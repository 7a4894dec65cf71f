"""One step's sector draw and transport of the fine-map SARSA wavefront
(``integrators.sarsa_wavefront.trace_frame_sarsa_wavefront``), as one CUDA
kernel, ``csrc/sarsa_transport.cu``.

``sample_transport`` takes a step after its TD update: the step's input
slot state (the frame's ``_State``), its hit (``Hit``: the hit masks, the
point, the material fields and the nearest volumes), the carried CDF rows
``cdfplus`` (V, S + 1) f32 or bf16, read in place at each lane's volume
(columns ``:S``; the step never writes them), the volumes' frames (V, 3, 3)
under frame_mode "volume" or None for the hit's own, the step's uniforms
and the frame's constants (``Frame``).  It returns the new slot state, the
sector and the pdf, all newly allocated, and adds into the frame's two
statistics (``path_sum`` f64, ``zclp`` int64) in place.  ``transport`` is
the same step for a sector, pdf and direction drawn by the caller (the
two-level sampler), with the same kernel.

The caller draws the uniforms, in the order the frame always drew them:
``r`` (W, 1) and ``u`` (W, 2) for the row sampler, ``u_rr`` (W,) for
Russian roulette (None when the configuration has none), and ``u_pix``
(W, 2), the jitter of the regenerated camera rays.  So the kernel and the
twin read the same random numbers, and the frame's stream of them is what
it was.

The wrapper launches the kernel for CUDA tensors and runs the plain twins
``sample_transport_plain`` and ``transport_plain`` (the frame's former
torch code of the two stages) for CPU tensors; it raises for any other
device and for inputs the kernel does not take.  The inputs are checked at
a frame's first step of each width (``Frame.checked``): within a phase the
frame hands every step tensors of the same kinds.  ``KERNEL.launches``
counts the launches.  The kernel replaces no TPU kernel: the JAX package
leaves these stages to XLA.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from rlrpt_tpu_torch import _cuda
from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.config import RHO, RenderConfig
from rlrpt_tpu_torch.integrators.wavefront import primary_dirs_u
from rlrpt_tpu_torch.ops.linalg import make_frame
from rlrpt_tpu_torch.radiance.volumes import sample_from_cdf_rows_u

SLOT_FIELDS = ("o", "d", "tp", "pixel", "kmx", "bounce", "remaining",
               "active", "sample_rad", "slot_rad", "cur_vol", "cur_sector",
               "cur_brdf")
STATS = ("path_sum", "zclp")


class Hit(NamedTuple):
    """A step's hit as the transport reads it, each (W,) or (W, 3): the
    live lanes that ``missed``, hit a ``light`` or a ``surface``; the hit
    point ``pos``; the hit's ``normal``, ``diffuse`` and ``emission``
    (f32 rows, each with its last stride 1: views of B4a's material row
    will do) and luminance ``lum``; and the nearest volume ``next_vol``
    (int64)."""

    missed: torch.Tensor
    light: torch.Tensor
    surface: torch.Tensor
    pos: torch.Tensor
    normal: torch.Tensor
    diffuse: torch.Tensor
    emission: torch.Tensor
    lum: torch.Tensor
    next_vol: torch.Tensor


class SarsaParams(ctypes.Structure):
    """Mirror of ``SarsaParams`` in csrc/sarsa_transport.cu (4-byte
    fields)."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "n_lanes", "n_sectors", "grid", "n_volumes", "row_stride",
        "bf16_rows", "sample", "volume_frames", "normal_stride",
        "diffuse_stride", "emission_stride", "lum_stride", "w0", "n_pix",
        "pix_end", "pix_mux", "spp", "width", "max_bounces",
        "russian_roulette", "rr_start_bounce")] + [
        (name, ctypes.c_float) for name in (
            "env", "ray_eps", "rr_min_prob", "throughput_threshold", "rho",
            "inv_grid_rho", "inv_pi", "inv_grid", "half_width",
            "half_height", "focal", "cam_x", "cam_y", "cam_z", "cos_yaw_y",
            "sin_yaw_y", "cos_yaw_x", "sin_yaw_x")]


class SlotState(ctypes.Structure):
    """Mirror of ``SlotState``: a slot state's field pointers."""

    _fields_ = [(name, ctypes.c_void_p) for name in SLOT_FIELDS]


class StepInputs(ctypes.Structure):
    """Mirror of ``StepInputs``."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "missed", "light", "surface", "pos", "normal", "diffuse",
        "emission", "lum", "next_vol", "rows", "frames", "r", "u", "u_rr",
        "u_pix", "sector", "pdf", "dir")]


class StepOutputs(ctypes.Structure):
    """Mirror of ``StepOutputs``."""

    _fields_ = [(name, ctypes.c_void_p) for name in ("sector", "pdf")
                + STATS]


KERNEL = _cuda.Kernel("rlrpt_sarsa_transport",
                      [SarsaParams, SlotState, StepInputs, SlotState,
                       StepOutputs, ctypes.c_void_p])


@dataclasses.dataclass(frozen=True)
class Frame:
    """A frame's constants of the step: the slots ``w0``, the image's
    pixels ``n_pix``, the end of this shard's pixels ``pix_end``, pixels a
    slot, samples a pixel, the camera, the render configuration, the
    sector grid and its GRID_RHO; ``checked``, the widths whose inputs the
    wrapper has checked."""

    w0: int
    n_pix: int
    pix_end: int
    pix_mux: int
    spp: int
    camera: Camera
    cfg: RenderConfig
    gr: int
    grid_rho: float
    checked: set = dataclasses.field(default_factory=set, compare=False,
                                     repr=False)

    @functools.cached_property
    def params(self) -> SarsaParams:
        """The kernel's parameters, but for those of a launch's inputs,
        which the wrapper sets."""
        cfg, cam = self.cfg, self.camera
        cy, sy, cx, sx = cam.yaw_cos_sin()
        return SarsaParams(
            n_sectors=self.gr * self.gr, grid=self.gr, w0=self.w0,
            n_pix=self.n_pix, pix_end=self.pix_end, pix_mux=self.pix_mux,
            spp=self.spp, width=cfg.width, max_bounces=cfg.max_ray_bounces,
            russian_roulette=int(cfg.russian_roulette),
            rr_start_bounce=cfg.rr_start_bounce,
            env=cfg.environment_light, ray_eps=cfg.eps,
            rr_min_prob=cfg.rr_min_prob,
            throughput_threshold=cfg.throughput_threshold, rho=RHO,
            inv_grid_rho=_reciprocal(self.grid_rho),
            inv_pi=_reciprocal(math.pi), inv_grid=_reciprocal(self.gr),
            half_width=cfg.width / 2.0, half_height=cfg.height / 2.0,
            focal=cfg.focal, cam_x=cam.position[0], cam_y=cam.position[1],
            cam_z=cam.position[2], cos_yaw_y=cy, sin_yaw_y=sy, cos_yaw_x=cx,
            sin_yaw_x=sx)


def _reciprocal(x: float) -> float:
    """1 / f32(x) in f32: torch divides a tensor by a host scalar on the
    card as a product with this."""
    return float(np.float32(1.0) / np.float32(x))


def transport_plain(c, hit: Hit, sector, pdf, new_d, u_rr, u_pix,
                    stats: dict, fr: Frame):
    """The plain torch twin of ``transport``: its arguments and result."""
    cfg, device = fr.cfg, c.o.device
    act = c.active
    sample_rad = (c.sample_rad
                  + torch.where(hit.missed[:, None],
                                c.tp * cfg.environment_light, 0.0)
                  + torch.where(hit.light[:, None], c.tp * hit.emission,
                                0.0))
    cos_theta = torch.sum(hit.normal * new_d, dim=-1)
    pdf_safe = torch.clamp(pdf, min=1e-12)
    exhausted = hit.surface & (c.bounce + 1 >= cfg.max_ray_bounces)
    survive = hit.surface & ~exhausted
    tp = torch.where(survive[:, None],
                     c.tp * (hit.diffuse / math.pi)
                     * (cos_theta / pdf_safe)[:, None], c.tp)
    rr_killed = torch.zeros_like(survive)
    if cfg.russian_roulette:
        p = torch.clamp(tp.max(dim=-1).values, cfg.rr_min_prob, 1.0)
        do_rr = survive & (c.bounce + 1 >= cfg.rr_start_bounce)
        rr_killed = do_rr & (u_rr >= p)
        tp = torch.where((do_rr & ~rr_killed)[:, None], tp / p[:, None], tp)
        survive = survive & ~rr_killed

    o = torch.where(survive[:, None], hit.pos + cfg.eps * new_d, c.o)
    d = torch.where(survive[:, None], new_d, c.d)
    bounce = torch.where(survive, c.bounce + 1, c.bounce)
    # pending TD state for the next vertex (ref: reinforcement_path_
    # tracing.cu:104-110)
    cur_vol = torch.where(survive, hit.next_vol, c.cur_vol)
    cur_sector = torch.where(survive, sector, -1)
    cur_brdf = torch.where(survive, hit.lum / math.pi, c.cur_brdf)

    # stats of finished samples
    fin = (bounce + 1).double()
    stats["path_sum"] += (torch.where(hit.missed | hit.light | rr_killed, fin,
                                      0.0).sum()
                          + exhausted.sum().double() * cfg.max_ray_bounces)
    finished = act & ~survive
    stats["zclp"] += (finished & (sample_rad.mean(-1)
                                  < cfg.throughput_threshold)).sum()

    # bank finished samples into the slot's k-th row
    ksel_base = torch.arange(fr.pix_mux, device=device)
    slot_rad = c.slot_rad + (
        (ksel_base == c.kmx[:, None])[:, :, None]
        * torch.where(finished[:, None], sample_rad, 0.0)[:, None, :])

    # regeneration: the next sample, else the next multiplexed pixel (the
    # pixel stride stays w0 in every phase)
    next_pix = c.pixel + fr.w0
    step_k = (finished & (c.remaining <= 0) & (c.kmx + 1 < fr.pix_mux)
              & (next_pix < fr.n_pix) & (next_pix < fr.pix_end))
    pixel = torch.where(step_k, next_pix, c.pixel)
    kmx = torch.where(step_k, c.kmx + 1, c.kmx)
    remaining = torch.where(step_k, fr.spp, c.remaining)
    regen = finished & (remaining > 0)
    rd = primary_dirs_u(u_pix, pixel, fr.camera, cfg)
    cam_o = torch.tensor(fr.camera.position, dtype=torch.float32,
                         device=device)
    return type(c)(
        o=torch.where(regen[:, None], cam_o, o),
        d=torch.where(regen[:, None], rd, d),
        tp=torch.where(regen[:, None], 1.0, tp), pixel=pixel,
        kmx=kmx, bounce=torch.where(regen, 0, bounce),
        remaining=torch.where(regen, remaining - 1, remaining),
        active=survive | regen,
        sample_rad=torch.where(regen[:, None], 0.0, sample_rad),
        slot_rad=slot_rad, cur_vol=cur_vol,
        cur_sector=torch.where(regen, -1, cur_sector),
        cur_brdf=cur_brdf)


def sample_transport_plain(c, hit: Hit, cdfplus, frames, r, u, u_rr, u_pix,
                           stats: dict, fr: Frame):
    """The plain torch twin of the kernel: ``sample_transport``'s
    arguments and results."""
    # importance-sample the next direction from the hit volume's CDF row
    basis = make_frame(hit.normal) if frames is None else \
        frames[hit.next_vol]
    new_d, sector, pdf = sample_from_cdf_rows_u(
        r, u, cdfplus[hit.next_vol, :-1].float(), basis, fr.grid_rho, fr.gr)
    out = transport_plain(c, hit, sector, pdf, new_d, u_rr, u_pix, stats, fr)
    return out, sector, pdf


def _check(c, hit: Hit, u_rr, u_pix, stats: dict, fr: Frame, draw: list):
    """Raise unless the step's inputs are what the kernel takes; ``draw``:
    the sampler's inputs, as (name, tensor, dtype, shape, alignment)."""
    if tuple(type(c)._fields) != SLOT_FIELDS:
        raise ValueError(f"the slot state's fields must be {SLOT_FIELDS}")
    dev, w = c.o.device, c.o.shape[0]
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    f32, i64, b = torch.float32, torch.int64, torch.bool
    want = [("o", c.o, f32, (w, 3)), ("d", c.d, f32, (w, 3)),
            ("tp", c.tp, f32, (w, 3)), ("pixel", c.pixel, i64, (w,)),
            ("kmx", c.kmx, i64, (w,)),
            ("bounce", c.bounce, torch.int32, (w,)),
            ("remaining", c.remaining, torch.int32, (w,)),
            ("active", c.active, b, (w,)),
            ("sample_rad", c.sample_rad, f32, (w, 3)),
            ("slot_rad", c.slot_rad, f32, (w, fr.pix_mux, 3)),
            ("cur_vol", c.cur_vol, i64, (w,)),
            ("cur_sector", c.cur_sector, i64, (w,)),
            ("cur_brdf", c.cur_brdf, f32, (w,)),
            ("missed", hit.missed, b, (w,)), ("light", hit.light, b, (w,)),
            ("surface", hit.surface, b, (w,)), ("pos", hit.pos, f32, (w, 3)),
            ("next_vol", hit.next_vol, i64, (w,)),
            ("u_pix", u_pix, f32, (w, 2), 8)]
    want += [(k, stats[k], dt, ()) for k, dt in zip(
        STATS, (torch.float64, i64))]
    if fr.cfg.russian_roulette:
        want.append(("u_rr", u_rr, f32, (w,)))
    elif u_rr is not None:
        raise ValueError("u_rr is for Russian roulette, which the "
                         "configuration turns off: pass None")
    for name, a, dt, shape, *align in want + draw:
        if a is None:
            raise ValueError(f"{name} is missing")
        if a.dtype != dt or a.shape != shape:
            raise ValueError(f"{name} must be {dt} {shape}, got {a.dtype} "
                             f"{tuple(a.shape)}")
        if a.device != dev:
            raise ValueError(f"{name} must be on the state's device {dev}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if align and a.data_ptr() % align[0]:
            raise ValueError(f"{name} must be {align[0]}-byte aligned")
    # the material fields may be strided rows (B4a's material row)
    for name, a, shape in (("normal", hit.normal, (w, 3)),
                           ("diffuse", hit.diffuse, (w, 3)),
                           ("emission", hit.emission, (w, 3)),
                           ("lum", hit.lum, (w,))):
        if a.dtype != f32 or a.shape != shape:
            raise ValueError(f"{name} must be {f32} {shape}, got {a.dtype} "
                             f"{tuple(a.shape)}")
        if a.device != dev:
            raise ValueError(f"{name} must be on the state's device {dev}")
        if len(shape) == 2 and a.stride(1) != 1:
            raise ValueError(f"{name} must have its last stride 1")


def _ptr(a):
    return None if a is None else a.data_ptr()


def _launch(c, hit: Hit, u_rr, u_pix, stats: dict, fr: Frame, *, rows=None,
            frames=None, r=None, u=None, given=None):
    """The kernel over the step's lanes: the new slot state, and the
    sector and pdf (with ``rows``) or None, None (``given`` the caller's
    (sector, pdf, direction))."""
    dev, w = c.o.device, c.o.shape[0]
    out = type(c)(*(torch.empty_like(a) for a in c))
    sector = pdf = None
    if rows is not None:
        sector = torch.empty((w,), dtype=torch.int64, device=dev)
        pdf = torch.empty((w,), dtype=torch.float32, device=dev)
    if w:
        p = fr.params
        p.n_lanes = w
        p.sample = int(rows is not None)
        p.volume_frames = int(frames is not None)
        if rows is not None:
            p.n_volumes, p.row_stride = rows.shape
            p.bf16_rows = int(rows.dtype == torch.bfloat16)
        p.normal_stride = hit.normal.stride(0)
        p.diffuse_stride = hit.diffuse.stride(0)
        p.emission_stride = hit.emission.stride(0)
        p.lum_stride = hit.lum.stride(0)
        drawn = given or (None, None, None)
        with torch.cuda.device(dev):
            KERNEL.launch(
                p, SlotState(*map(_ptr, c)),
                StepInputs(*map(_ptr, hit), _ptr(rows), _ptr(frames),
                           _ptr(r), _ptr(u), _ptr(u_rr), _ptr(u_pix),
                           *map(_ptr, drawn)),
                SlotState(*map(_ptr, out)),
                StepOutputs(_ptr(sector), _ptr(pdf),
                            *(stats[k].data_ptr() for k in STATS)),
                torch.cuda.current_stream().cuda_stream)
    return out, sector, pdf


def sample_transport(c, hit: Hit, cdfplus, frames, r, u, u_rr, u_pix,
                     stats: dict, fr: Frame):
    """One step's sector draw and transport (the module's docstring);
    returns (the new slot state, sector (W,) int64, pdf (W,) f32)."""
    w = c.o.shape[0]
    if w not in fr.checked:
        s = fr.gr * fr.gr
        if cdfplus.dim() != 2 or cdfplus.shape[1] != s + 1:
            raise ValueError(f"cdfplus must be (V, {s + 1}), got "
                             f"{tuple(cdfplus.shape)}")
        if cdfplus.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError("cdfplus must be torch.float32 or "
                             f"torch.bfloat16, got {cdfplus.dtype}")
        v = cdfplus.shape[0]
        draw = [("cdfplus", cdfplus, cdfplus.dtype, (v, s + 1)),
                ("r", r, torch.float32, (w, 1)),
                ("u", u, torch.float32, (w, 2), 8)]
        if frames is not None:
            draw.append(("frames", frames, torch.float32, (v, 3, 3)))
        _check(c, hit, u_rr, u_pix, stats, fr, draw)
        fr.checked.add(w)
    if c.o.device.type == "cpu":
        return sample_transport_plain(c, hit, cdfplus, frames, r, u, u_rr,
                                      u_pix, stats, fr)
    return _launch(c, hit, u_rr, u_pix, stats, fr, rows=cdfplus,
                   frames=frames, r=r, u=u)


def transport(c, hit: Hit, sector, pdf, new_d, u_rr, u_pix, stats: dict,
              fr: Frame):
    """One step's transport for a sector (W,) int64, pdf (W,) f32 and
    direction (W, 3) f32 the caller drew; returns the new slot state."""
    w = c.o.shape[0]
    if w not in fr.checked:
        _check(c, hit, u_rr, u_pix, stats, fr,
               [("sector", sector, torch.int64, (w,)),
                ("pdf", pdf, torch.float32, (w,)),
                ("new_d", new_d, torch.float32, (w, 3))])
        fr.checked.add(w)
    if c.o.device.type == "cpu":
        return transport_plain(c, hit, sector, pdf, new_d, u_rr, u_pix,
                               stats, fr)
    return _launch(c, hit, u_rr, u_pix, stats, fr, given=(sector, pdf,
                                                           new_d))[0]
