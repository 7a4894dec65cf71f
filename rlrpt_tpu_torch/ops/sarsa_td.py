"""One step's nearest-volume lookup and TD update of the fine-map SARSA
wavefront (``integrators.sarsa_wavefront.trace_frame_sarsa_wavefront``, its
``.volume`` and ``.td`` stages), as four CUDA kernels, ``csrc/sarsa_td.cu``:

* ``find_closest_volume_table``: the answer table's nearest volume,
  ``radiance.grid_bucket.find_closest_volume_table`` bit for bit
  (``KERNEL_LOOKUP``);
* ``td_targets``: each lane's TD target and pending flag, and the pending
  count added into the frame's TD count (``KERNEL_TARGETS``);
* ``sarsa_contributions``: the pending lanes' targets and counts added
  into a ``TdScratch`` with atomics, their volumes marked dirty
  (``KERNEL_SCATTER``);
* ``apply_refresh``: for each dirty volume, the exact composition of the
  running mean applied in place to the entries that received targets,
  their scratch entries set back to zero, and the row's irradiance written
  into column S of its carried CDF row (``KERNEL_APPLY``).

A frame that takes this route holds a ``TdFrame`` (``td_frame``): its own
copies of the volumes' Q and visits, which the apply updates in place, the
carried CDF rows, and a scratch that is zero between steps, so no step
clears or passes over the whole (V, S) table.

The wrappers launch the kernels for CUDA tensors.  For CPU tensors they run
the plain twins: ``find_closest_volume_table`` and ``sarsa_contributions``
without a ``TdScratch`` are radiance/'s own functions (the frame binds these
two names, which the benchmark's planted faults patch, to the wrappers);
``targets_plain`` is the frame's former torch code of the targets;
``scatter_plain`` and ``apply_plain`` are the kernels' semantics in torch,
equal to ``radiance.volumes.sarsa_contributions`` +
``apply_sarsa_contributions`` + ``irradiance_estimates`` on the entries
and rows they touch.  On the card the lookup, the targets and the apply are
bit for bit their twins; the scatter's atomics, like the twin's
``index_add_``, add a duplicate entry's targets in any order.  The irradiance
follows ATen's reduction order exactly where S is below 128 or a multiple
of 4 (csrc/sarsa_td.cu).  The inputs are checked once a width
(``TdFrame.checked``, ``TdScratch.checked``): within a phase the frame hands
every step tensors of the same kinds.  Each kernel's ``launches`` counts
its launches.  The kernels replace no TPU kernel: the JAX package leaves
these stages to XLA.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import NamedTuple

import torch

from rlrpt_tpu_torch import _cuda
from rlrpt_tpu_torch.ops.sarsa_transport import _reciprocal
from rlrpt_tpu_torch.radiance import grid_bucket, volumes


class LookupParams(ctypes.Structure):
    """Mirror of ``LookupParams`` in csrc/sarsa_td.cu."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "n_lanes", "n_slots", "nx", "ny", "nz")]


class LookupArgs(ctypes.Structure):
    """Mirror of ``LookupArgs``."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "qpos", "cls", "table", "origin", "inv_cell", "next_vol")]


class TdParams(ctypes.Structure):
    """Mirror of ``TdParams`` (4-byte fields)."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "n_lanes", "n_volumes", "n_sectors", "bf16_rows", "lum_stride")] + [
        (name, ctypes.c_float) for name in (
            "env", "threshold", "inv_pi", "irr_scale")]


class TdTables(ctypes.Structure):
    """Mirror of ``TdTables``: a frame's table pointers."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "q", "visits", "sum_t", "cnt", "dirty", "rows", "cos", "surface_lum",
        "td_count")]


class TargetArgs(ctypes.Structure):
    """Mirror of ``TargetArgs``."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "active", "cur_sector", "cur_brdf", "missed", "light", "lum",
        "next_vol", "target", "pending")]


class ScatterArgs(ctypes.Structure):
    """Mirror of ``ScatterArgs``."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "vol", "sector", "target", "mask")]


KERNEL_LOOKUP = _cuda.Kernel("rlrpt_td_lookup", [
    LookupParams, LookupArgs, ctypes.c_int, ctypes.c_void_p])
KERNEL_TARGETS = _cuda.Kernel("rlrpt_td_targets", [
    TdParams, TdTables, TargetArgs, ctypes.c_void_p])
KERNEL_SCATTER = _cuda.Kernel("rlrpt_td_scatter", [
    ctypes.c_int, ctypes.c_int, ScatterArgs, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
KERNEL_APPLY = _cuda.Kernel("rlrpt_td_apply", [
    TdParams, TdTables, ctypes.c_void_p])
KERNELS = (KERNEL_LOOKUP, KERNEL_TARGETS, KERNEL_SCATTER, KERNEL_APPLY)


class TdScratch(NamedTuple):
    """The scatter's buffers, zero between steps: ``sum_t`` and ``cnt``
    (V*S + 1,) f32, ``dirty`` (V,) int32 (a volume's row received
    targets); ``views``, the (V, S) views of ``sum_t`` and ``cnt`` that
    ``sarsa_contributions`` returns; ``checked``, the widths whose scatter
    inputs the wrapper has checked."""

    sum_t: torch.Tensor
    cnt: torch.Tensor
    dirty: torch.Tensor
    views: tuple
    checked: set


def zero_scratch(n_volumes: int, n_sectors: int, device) -> TdScratch:
    """A zeroed ``TdScratch`` (the last entry of each buffer stays unused:
    the layout of ``radiance.volumes.td_scratch``)."""
    n = n_volumes * n_sectors + 1
    sum_t, cnt = (torch.zeros((n,), dtype=torch.float32, device=device)
                  for _ in range(2))
    views = (sum_t[:-1].view(n_volumes, n_sectors),
             cnt[:-1].view(n_volumes, n_sectors))
    return TdScratch(sum_t, cnt,
                     torch.zeros((n_volumes,), dtype=torch.int32,
                                 device=device), views, set())


@dataclasses.dataclass(eq=False)
class TdFrame:
    """A frame's TD state on the kernel route: its own ``q`` (V, S) f32 and
    ``visits`` (V, S) int32, updated in place; the carried CDF rows
    ``cdfplus`` (V, S + 1) f32 or bf16, whose column S the apply rewrites;
    the ``scratch``; the sector cosines ``cos`` (S,); the volumes'
    ``surface_lum`` (V,); ``count``, the frame's TD updates (an int64
    device scalar); the radiance ``threshold`` and the environment light
    ``env``; ``checked``, the widths whose inputs the wrapper has
    checked."""

    q: torch.Tensor
    visits: torch.Tensor
    cdfplus: torch.Tensor
    scratch: TdScratch
    cos: torch.Tensor
    surface_lum: torch.Tensor
    count: torch.Tensor
    threshold: float
    env: float
    checked: set = dataclasses.field(default_factory=set)

    @functools.cached_property
    def params(self) -> TdParams:
        """The kernels' parameters, but for a launch's lanes and the
        luminance's stride, which the wrapper sets."""
        v, s = self.q.shape
        return TdParams(
            n_volumes=v, n_sectors=s,
            bf16_rows=int(self.cdfplus.dtype == torch.bfloat16),
            env=self.env, threshold=self.threshold,
            inv_pi=_reciprocal(math.pi), irr_scale=2.0 * math.pi / s)

    @functools.cached_property
    def tables(self) -> TdTables:
        sc = self.scratch
        return TdTables(*(a.data_ptr() for a in (
            self.q, self.visits, sc.sum_t, sc.cnt, sc.dirty, self.cdfplus,
            self.cos, self.surface_lum, self.count)))


def _need(name, a, dtype, shape, device):
    if a.dtype != dtype or tuple(a.shape) != shape:
        raise ValueError(f"{name} must be {dtype} {shape}, got {a.dtype} "
                         f"{tuple(a.shape)}")
    if a.device != device:
        raise ValueError(f"{name} must be on {device}")
    if not a.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def td_frame(vols: volumes.RadianceVolumes, cdfplus: torch.Tensor,
             cos: torch.Tensor, threshold: float, env: float) -> TdFrame:
    """A frame's ``TdFrame``, from the volumes it starts from (copied:
    the frame never writes the caller's tables) and its carried rows."""
    v, s = vols.n_volumes, vols.n_sectors
    dev = vols.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    if cdfplus.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("cdfplus must be torch.float32 or torch.bfloat16, "
                         f"got {cdfplus.dtype}")
    own = dict(q=vols.q.clone(memory_format=torch.contiguous_format),
               visits=vols.visits.clone(memory_format=torch.contiguous_format),
               surface_lum=vols.surface_lum.contiguous())
    for name, a, dt, shape in (
            ("q", own["q"], torch.float32, (v, s)),
            ("visits", own["visits"], torch.int32, (v, s)),
            ("cdfplus", cdfplus, cdfplus.dtype, (v, s + 1)),
            ("cos", cos, torch.float32, (s,)),
            ("surface_lum", own["surface_lum"], torch.float32, (v,))):
        _need(name, a, dt, shape, dev)
    return TdFrame(cdfplus=cdfplus, scratch=zero_scratch(v, s, dev), cos=cos,
                   count=torch.zeros((), dtype=torch.int64, device=dev),
                   threshold=threshold, env=env, **own)


def _stream():
    return torch.cuda.current_stream().cuda_stream


# ---- the lookup -------------------------------------------------------------

def find_closest_volume_table(tb: grid_bucket.VolumeClassTable,
                              qpos: torch.Tensor, tri: torch.Tensor,
                              cls: torch.Tensor | None = None) -> torch.Tensor:
    """``radiance.grid_bucket.find_closest_volume_table``'s arguments and
    result, (N,) int64; the lookup kernel for CUDA tensors with the hits'
    classes ``cls`` (B4a's material row), else that function."""
    if cls is None or qpos.device.type != "cuda":
        return grid_bucket.find_closest_volume_table(tb, qpos, tri, cls=cls)
    n, dev = qpos.shape[0], qpos.device
    table = tb.table
    if not (qpos.dtype == torch.float32 and qpos.shape == (n, 3)
            and qpos.is_contiguous() and cls.dtype == torch.int32
            and cls.shape == (n,) and cls.is_contiguous()
            and cls.device == dev and table.device == dev
            and table.dtype == torch.int32 and table.shape[1:] == (16,)
            and table.is_contiguous() and tb.origin.device == dev
            and tb.inv_cell.device == dev):
        # one test a call; the messages only for a call that fails it
        for name, a, dt, shape in (
                ("qpos", qpos, torch.float32, (n, 3)),
                ("cls", cls, torch.int32, (n,)),
                ("table", table, torch.int32, (table.shape[0], 16)),
                ("origin", tb.origin, torch.float32, (3,)),
                ("inv_cell", tb.inv_cell, torch.float32, ())):
            _need(name, a, dt, shape, dev)
    out = torch.empty((n,), dtype=torch.int64, device=dev)
    if n:
        with torch.cuda.device(dev):
            KERNEL_LOOKUP.launch(
                LookupParams(n, tb.n_slots, *tb.dims),
                LookupArgs(qpos.data_ptr(), cls.data_ptr(),
                           tb.table.data_ptr(), tb.origin.data_ptr(),
                           tb.inv_cell.data_ptr(), out.data_ptr()),
                tb.table.shape[0], _stream())
    return out


# ---- the targets ------------------------------------------------------------

def targets_plain(c, missed, light, lum, next_vol, cdfplus, env: float):
    """The frame's torch code of a step's TD targets (ref: reinforcement_
    path_tracing.cu:69-78; targets per hit type radiance_map.cu:111-146):
    (target (W,) f32, pending (W,) bool), from the slot state ``c``, the
    hit's masks and luminance, the new volumes and the bootstrap column S
    of their carried rows.  A pending lane's sector is ``c.cur_sector``
    (the others' is -1, which no scatter reads)."""
    irr_b = cdfplus[next_vol, -1].float()
    target = torch.where(
        missed, c.cur_brdf * env,
        torch.where(light, c.cur_brdf * lum, c.cur_brdf * irr_b))
    return target, c.active & (c.cur_sector >= 0)


def td_targets(td: TdFrame, c, missed, light, lum, next_vol):
    """``targets_plain``'s result for the frame ``td``, whose ``count``
    gains the pending lanes."""
    w, dev = c.active.shape[0], td.q.device
    if w not in td.checked:
        b, i64 = torch.bool, torch.int64
        for name, a, dt in (("active", c.active, b),
                            ("cur_sector", c.cur_sector, i64),
                            ("cur_brdf", c.cur_brdf, torch.float32),
                            ("missed", missed, b), ("light", light, b),
                            ("next_vol", next_vol, i64)):
            _need(name, a, dt, (w,), dev)
        if (lum.dtype != torch.float32 or tuple(lum.shape) != (w,)
                or lum.device != dev):
            raise ValueError(f"lum must be torch.float32 ({w},) on {dev}")
        td.checked.add(w)
    if dev.type == "cpu":
        out = targets_plain(c, missed, light, lum, next_vol, td.cdfplus,
                            td.env)
        td.count += out[1].sum()
        return out
    target = torch.empty((w,), dtype=torch.float32, device=dev)
    pending = torch.empty((w,), dtype=torch.bool, device=dev)
    if w:
        p = td.params
        p.n_lanes, p.lum_stride = w, lum.stride(0)
        with torch.cuda.device(dev):
            KERNEL_TARGETS.launch(p, td.tables, TargetArgs(*(
                a.data_ptr() for a in (
                    c.active, c.cur_sector, c.cur_brdf, missed, light, lum,
                    next_vol, target, pending))), _stream())
    return target, pending


# ---- the scatter ------------------------------------------------------------

def scatter_plain(vol_idx, sector, target, mask, n_sectors: int,
                  scratch: TdScratch) -> None:
    """The scatter kernel in torch: the masked lanes' targets and counts
    added into the scratch, their volumes marked dirty."""
    flat = (vol_idx * n_sectors + sector)[mask]
    scratch.sum_t.index_add_(0, flat, target[mask])
    scratch.cnt.index_add_(0, flat, torch.ones_like(target[mask]))
    scratch.dirty[vol_idx[mask]] = 1


def sarsa_contributions(vol_idx: torch.Tensor, sector: torch.Tensor,
                        target: torch.Tensor, mask: torch.Tensor,
                        n_volumes: int, n_sectors: int, scratch=None):
    """``radiance.volumes.sarsa_contributions``'s arguments and result:
    (sum_targets (V, S), counts (V, S)).  With a ``TdScratch`` the sums
    add into it, which stays as it was outside the masked lanes' entries
    (the scatter kernel for CUDA tensors, ``scatter_plain`` for CPU
    ones), and the result is its views; otherwise that function."""
    if not isinstance(scratch, TdScratch):
        return volumes.sarsa_contributions(vol_idx, sector, target, mask,
                                           n_volumes, n_sectors, scratch)
    w, dev = mask.shape[0], scratch.sum_t.device
    if w not in scratch.checked:
        i64 = torch.int64
        for name, a, dt in (("vol_idx", vol_idx, i64),
                            ("sector", sector, i64),
                            ("target", target, torch.float32),
                            ("mask", mask, torch.bool)):
            _need(name, a, dt, (w,), dev)
        if scratch.views[0].shape != (n_volumes, n_sectors):
            raise ValueError(f"the scratch is not ({n_volumes}, "
                             f"{n_sectors})")
        scratch.checked.add(w)
    if dev.type == "cpu":
        scatter_plain(vol_idx, sector, target, mask, n_sectors, scratch)
    elif w:
        with torch.cuda.device(dev):
            KERNEL_SCATTER.launch(
                w, n_sectors, ScatterArgs(vol_idx.data_ptr(),
                                          sector.data_ptr(),
                                          target.data_ptr(), mask.data_ptr()),
                scratch.sum_t.data_ptr(), scratch.cnt.data_ptr(),
                scratch.dirty.data_ptr(), _stream())
    return scratch.views


# ---- the apply and the irradiance -------------------------------------------

def apply_plain(td: TdFrame) -> None:
    """The apply kernel in torch: ``apply_sarsa_contributions`` and
    ``irradiance_estimates`` on the dirty volumes' rows, in place, the
    scratch and the flags set back to zero."""
    sc = td.scratch
    rows = sc.dirty.nonzero()[:, 0]
    sum_t, cnt = (a[rows] for a in sc.views)
    q, visits = td.q[rows], td.visits[rows]
    n = visits.float()
    q_new = (q * (1.0 + n) + sum_t) / (1.0 + n + cnt)
    q_new = torch.clamp(q_new, min=td.threshold)
    q = torch.where(cnt > 0, q_new, q)
    td.q[rows] = q
    td.visits[rows] = visits + cnt.to(torch.int32)
    for a in sc.views:
        a[rows] = 0.0
    s = td.q.shape[1]
    acc = torch.sum(q * td.cos, dim=-1) * (td.surface_lum[rows] / math.pi)
    td.cdfplus[rows, -1] = (acc * (2.0 * math.pi / s)).to(td.cdfplus.dtype)
    sc.dirty[rows] = 0


def apply_refresh(td: TdFrame) -> None:
    """Apply the scattered contributions to ``td``'s tables in place and
    rewrite the dirty volumes' irradiance column (the apply kernel for
    CUDA tensors, ``apply_plain`` for CPU ones)."""
    dev = td.q.device
    if dev.type == "cpu":
        apply_plain(td)
        return
    with torch.cuda.device(dev):
        KERNEL_APPLY.launch(td.params, td.tables, _stream())
