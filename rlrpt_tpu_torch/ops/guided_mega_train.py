"""The in-kernel expected-SARSA learning frame on the binned Q-state
(counterpart of ``rlrpt_tpu/ops/guided_mega_train.py``).

A learning frame runs the guided megakernel's slot loop, sampling each
bounce from the frame-start CDF, and learns Q over (sector, triangle x uv
bin) while it renders: a pending transition (the sector drawn at the
surface just left, brdf = its luminance/pi) takes the TD target brdf*env
on a miss, brdf*lum(light) on a light, and otherwise brdf times the live
irradiance sum_s Q*cos * lum/pi * 2pi/S of the new hit's bin; targets and
counts are summed per (sector, bin) over an iteration and applied as
Q <- max((Q(1+V) + sum_t)/(1+V+cnt), threshold) where cnt > 0.

Schedule: one batch per global iteration.  Every active slot takes its
k-th step on the irradiance of Q after iteration k-1, then the batch is
applied.  The JAX kernel runs its ray tiles in order, each on the Q the
previous one left; with one tile covering every slot (``r_tile >=
n_slots``) the two schedules are the same.  The paths never depend on Q,
so a learning frame's image is the guided frame's (``ops.guided_mega``)
for the same seed and table, and ``td_scatter_count`` equals the visit
delta sum(V_out - V_in) exactly.

As elsewhere in the port: ``mega_train_frame`` wraps the CUDA kernel B2
(``csrc/mega_train.cu``) and runs the plain twin ``mega_train_frame_plain``
for CPU tensors.  The TPU kernel's bf16 hi/lo splits of targets and
irradiance, its VMEM column caps and its ray-tile narrowing do not carry
over: both compute in plain f32.

``bin_luminance``, ``init_bin_q`` and ``rebuild_bin_cdf`` are the host
helpers of the pipeline; ``rebuild_bin_cdf`` runs between frames.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from rlrpt_tpu_torch import _cuda
from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.config import RenderConfig
from rlrpt_tpu_torch.ops import hemisphere as hs
from rlrpt_tpu_torch.ops.guided_mega import (_cdf_sampler, check_cdf_layout,
                                             check_cdf_order)
from rlrpt_tpu_torch.ops.megakernel import (PIX_MUX, R_TILE, T_CHUNK, _t_pad,
                                            assemble, camera_vector,
                                            check_tables, mega_params,
                                            n_slots_for, pack_scene,
                                            run_slots_plain)
from rlrpt_tpu_torch.radiance.bake import TriBinCDF
from rlrpt_tpu_torch.scene.scene import Scene
from rlrpt_tpu_torch.utils import prep_cache, profiling

PI = math.pi


def bin_luminance(scene: Scene, t_pad: int, uv_bins: int) -> torch.Tensor:
    """(1, C) per-bin surface luminance (every bin of a triangle shares
    its material luminance).  Built once per scene's luminance, t_pad and
    uv_bins (``utils.prep_cache``): shared, so the caller must not write
    it."""
    return prep_cache.CACHE.get(
        "bin_lum", (scene.luminance,), (t_pad, uv_bins),
        lambda: _bin_luminance(scene, t_pad, uv_bins))


def _bin_luminance(scene: Scene, t_pad: int, uv_bins: int) -> torch.Tensor:
    lum = torch.zeros((t_pad,), dtype=torch.float32, device=scene.device)
    lum[:scene.n_triangles] = scene.luminance.float()
    return lum.repeat_interleave(uv_bins * uv_bins)[None, :]


def init_bin_q(t_pad: int, uv_bins: int, sector_grid: int,
               initial_radiance: float, device="cuda"):
    """Fresh (q, visits), (S_pad, C) float32 each.  Padding sector rows
    hold zeros (never scattered into: the sampler clamps to S-1)."""
    s = sector_grid * sector_grid
    s_pad = int(math.ceil(s / 8) * 8)
    c = t_pad * uv_bins * uv_bins
    q = torch.zeros((s_pad, c), dtype=torch.float32, device=device)
    q[:s] = initial_radiance
    return q, torch.zeros((s_pad, c), dtype=torch.float32, device=device)


# The JAX package's rebuild runs under XLA, which sums the sector rows in
# a fixed order: a reduction longer than SUM_WINDOW rows is padded (half
# the pad before the rows) to whole windows, each window summed row by row,
# then the windows' sums reduced the same way; a cumulative sum scans
# blocks of SCAN_BLOCK rows row by row and adds each block's carry, the
# inclusive scan of the earlier blocks' totals, found the same way.  The
# two functions below sum in that order, so the bf16 table is JAX's bit
# for bit (float32 rounding at a sector's CDF step can move a bf16 entry
# by one unit in the last place).  They cost ~70 small ops a rebuild, so
# rebuild_bin_cdf takes them on the CPU only.
SUM_WINDOW = 32
SCAN_BLOCK = 16


def _padded_blocks(x: torch.Tensor, block: int, before: int) -> torch.Tensor:
    """x (n, ...) with ``before`` zero rows ahead and zeros after, to whole
    blocks, as (n_blocks, block, ...).  A zero added to these non-negative
    sums changes no bit."""
    n = x.shape[0]
    after = -(n + before) % block
    z = lambda k: x.new_zeros((k,) + x.shape[1:])  # noqa: E731
    return torch.cat([z(before), x, z(after)]).reshape(
        (-1, block) + x.shape[1:])


def _rows_in_order(x: torch.Tensor) -> list:
    """Running sums over dim 0, each row added in turn to the last."""
    acc, out = torch.zeros_like(x[0]), []
    for row in x.unbind(0):
        acc = acc + row
        out.append(acc)
    return out


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """torch.sum(x, dim=0) in the order the JAX package's sum takes."""
    n = x.shape[0]
    if n <= SUM_WINDOW:
        return _rows_in_order(x)[-1]
    blocks = _padded_blocks(x, SUM_WINDOW, (-n % SUM_WINDOW) // 2)
    return row_sum(_rows_in_order(blocks.transpose(0, 1))[-1])


def row_cumsum(x: torch.Tensor) -> torch.Tensor:
    """torch.cumsum(x, dim=0) in the order the JAX package's takes."""
    n = x.shape[0]
    if n <= SCAN_BLOCK:
        return torch.stack(_rows_in_order(x))
    local = torch.stack(_rows_in_order(
        _padded_blocks(x, SCAN_BLOCK, 0).transpose(0, 1)), dim=1)
    inclusive = row_cumsum(local[:, -1])
    carry = torch.cat([torch.zeros_like(inclusive[:1]), inclusive[:-1]])
    return (local + carry[:, None]).reshape((-1,) + x.shape[1:])[:n]


def rebuild_bin_cdf(q: torch.Tensor, sector_grid: int, uv_bins: int,
                    t_pad: int, distribution_threshold: float = 0.0,
                    defensive_mix: float = 0.0,
                    dtype: torch.dtype = torch.bfloat16,
                    jax_order: bool | None = None) -> TriBinCDF:
    """Frame-boundary CDF rebuild from the binned Q (the reference's
    update_radiance_distribution, radiance_volume.cu:149-188, on the
    binned state space).  Returns a TriBinCDF for the next frame: bf16 as
    the kernels take it; ``dtype=torch.float32`` keeps the unrounded table
    for the plain twins (a bf16 CDF never draws a sector whose probability
    is below its spacing, ROADMAP C).  With ``jax_order`` (the default on
    the CPU) the sums take the JAX package's order (row_sum, row_cumsum)
    and the bf16 table is JAX's bit for bit; else torch.sum and
    torch.cumsum (the default on the card, where the ordered sums' ~70
    launches cost a 32-spp learning frame ~9%, scripts/rebuild_timing.py).
    The kernels and their twins take the same table either way.  While a
    profiler records, the table's zero-probability sectors are tallied
    (``tally_zero_sectors``)."""
    if jax_order is None:
        jax_order = q.device.type == "cpu"
    s = sector_grid * sector_grid
    s_pad = q.shape[0]
    with profiling.span("rebuild_bin_cdf.cos"):
        cos = hs.sector_cos_thetas(sector_grid, q.device)
    with profiling.span("rebuild_bin_cdf.sums"):
        w = torch.clamp(q[:s] * cos[:, None], min=distribution_threshold)
        total = 1e-10 + (row_sum(w) if jax_order else torch.sum(w, dim=0))
        p = w / total[None, :]
        if defensive_mix:
            p = (1.0 - defensive_mix) * p + defensive_mix / s
        cdf = row_cumsum(p) if jax_order else torch.cumsum(p, dim=0)
        cdf[s - 1] = 1.0
    with profiling.span("rebuild_bin_cdf.cast"):
        out = torch.full((s_pad, q.shape[1]), 2.0, dtype=torch.float32,
                         device=q.device)
        out[:s] = cdf
        table = out.to(dtype)
    if profiling.recording():
        tally_zero_sectors(table, s)
    return TriBinCDF(cdf=table, sector_grid=sector_grid, uv_bins=uv_bins,
                     t_pad=t_pad)


def tally_zero_sectors(table: torch.Tensor, n_sectors: int) -> None:
    """Add to the recorder's device tallies, with no wait, the sectors of
    an (S_pad, C) table that the guided kernels can never draw
    (``rebuild_bin_cdf.zero_sectors``: pdf hi - lo 0 as their sampler reads
    it, csrc/path_common.cuh:CdfSampler, lo 0 before sector 0 and hi 1 for
    the last) and the sectors looked at (``rebuild_bin_cdf.sectors``).
    Every column counts, as the rebuild is handed no triangle count: the
    padding triangles' and the lights' columns keep the initial Q, whose
    bf16 table has 4 of 121 sectors at 0 (10 of 144 at 12x12)."""
    c = table[:n_sectors].float()
    one = torch.ones_like(c[:1])
    hi = torch.cat([c[:n_sectors - 1], one])
    lo = torch.cat([torch.zeros_like(one), c[:n_sectors - 1]])
    rec = profiling.RECORDER
    rec.tally("rebuild_bin_cdf.zero_sectors", (hi <= lo).sum())
    rec.tally("rebuild_bin_cdf.sectors", torch.full(
        (), n_sectors * table.shape[1], dtype=torch.int64,
        device=table.device))


# ---- the learning frame ----------------------------------------------------

def _irr_scale(n_sectors: int) -> float:
    """f32(2pi/S) / f32(pi), in float32 as the JAX kernel computes it."""
    return float(np.float32(np.float32(2.0 * PI / n_sectors)
                            / np.float32(PI)))


def bin_irradiance(q: torch.Tensor, sec_cos: torch.Tensor, lum: torch.Tensor,
                   irr_scale: float) -> torch.Tensor:
    """(C,) live irradiance sum_s Q*cos * lum * irr_scale of every bin
    (guided_mega_train.py:274-275)."""
    n_sectors = sec_cos.shape[0]
    return (torch.sum(q[:n_sectors] * sec_cos[:, None], dim=0) * lum
            * irr_scale)


def mega_train_frame_plain(seed: int, cam: tuple, tris: torch.Tensor,
                           mat: torch.Tensor, cdf_t: torch.Tensor,
                           lum: torch.Tensor, sec_cos: torch.Tensor,
                           q: torch.Tensor, visits: torch.Tensor,
                           sector_grid: int, uv_bins: int,
                           radiance_threshold: float, cfg: RenderConfig,
                           n_slots: int, pix_mux: int):
    """Plain torch twin of kernel B2 on the same inputs: B3's twin
    (``ops.guided_mega.mega_guided_frame_plain``) with the TD scatter
    hooked into every step.  Returns (rad, path_sum, iters, q, visits,
    td): q and visits are new tensors, td (n_slots,) f32 the slots' TD
    scatter counts."""
    dev = tris.device
    q, visits = q.clone(), visits.clone()
    scale = _irr_scale(sector_grid * sector_grid)
    thr = float(np.float32(radiance_threshold))
    env = cfg.environment_light
    st = {"irr": bin_irradiance(q, sec_cos, lum, scale),
          "bin": torch.zeros((n_slots,), dtype=torch.int64, device=dev),
          "sec": torch.full((n_slots,), -1, dtype=torch.int64, device=dev),
          "brdf": torch.zeros((n_slots,), dtype=torch.float32, device=dev),
          "td": torch.zeros((n_slots,), dtype=torch.float32, device=dev)}

    def on_step(act, m, missed, hit_light, survive, info):
        sector, col = info
        cur_sec, cur_bin, cur_brdf = st["sec"], st["bin"], st["brdf"]
        pending = act & (cur_sec >= 0)
        target = torch.where(
            missed, cur_brdf * env,
            torch.where(hit_light, cur_brdf * m[:, 10],
                        cur_brdf * st["irr"][col]))
        # (sum_t, cnt) of the iteration; a slot with nothing pending adds
        # 0 to cell (0, 0), which leaves it as it was
        cell = (torch.where(pending, cur_sec, 0),
                torch.where(pending, cur_bin, 0))
        sum_t = torch.zeros_like(q)
        cnt = torch.zeros_like(q)
        sum_t.index_put_(cell, torch.where(pending, target, 0.0),
                         accumulate=True)
        cnt.index_put_(cell, pending.float(), accumulate=True)
        q_new = torch.clamp((q * (1.0 + visits) + sum_t)
                            / (1.0 + visits + cnt), min=thr)
        q.copy_(torch.where(cnt > 0, q_new, q))
        visits.add_(cnt)
        st["irr"] = bin_irradiance(q, sec_cos, lum, scale)
        st["td"] = st["td"] + pending.float()
        # the transition just sampled is pending at the next step
        st["bin"] = torch.where(survive, col, cur_bin)
        st["sec"] = torch.where(survive, sector, -1)
        st["brdf"] = torch.where(survive, m[:, 10] / float(PI), cur_brdf)

    rad, path_sum, iters = run_slots_plain(
        seed, cam, tris, mat, cfg, n_slots, pix_mux,
        _cdf_sampler(seed, cdf_t, sector_grid, uv_bins), on_step)
    return rad, path_sum, iters, q, visits, st["td"]


_TRAIN_ARGS = [_cuda.MegaParams, _cuda.TrainParams] + [ctypes.c_void_p] * 19
KERNEL = _cuda.Kernel("rlrpt_mega_train", _TRAIN_ARGS)
# the same frame with B2's phase clock (csrc/mega_train.cu), counted apart
KERNEL_TIMED = _cuda.Kernel("rlrpt_mega_train", _TRAIN_ARGS)


def _check_error(lib, symbol: str, err: int) -> None:
    if err != 0:
        msg = lib.rlrpt_cuda_error_string(err).decode()
        raise RuntimeError(f"{symbol}: CUDA error {err}: {msg}")


@functools.lru_cache(maxsize=64)
def train_blocks(n_slots: int, device) -> int:
    """The block count of the timed B2's cooperative grid for ``n_slots``
    slots: the rows its phase clock fills (fixed for a card, so asked of
    it once)."""
    lib = _cuda.library()
    fn = lib.rlrpt_train_blocks
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        _check_error(lib, "rlrpt_train_blocks",
                     fn(n_slots, ctypes.byref(blocks)))
    return blocks.value


def _check_train_inputs(tris, mat, cdf_t, lum, sec_cos, q, visits,
                        sector_grid: int, uv_bins: int, n_slots: int,
                        clock) -> None:
    """What mega_train_frame takes (its docstring) but the table's order,
    which takes a read back (check_cdf_order); raises ValueError."""
    check_tables(tris, mat)
    check_cdf_layout(cdf_t, tris, sector_grid, uv_bins)
    n_cols = cdf_t.shape[0]
    n_sectors = sector_grid * sector_grid
    for name, a, shape in (("lum", lum, (n_cols,)),
                           ("sec_cos", sec_cos, (n_sectors,))):
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(a.shape)}")
    for name, a in (("q", q), ("visits", visits)):
        if a.dim() != 2 or a.shape[1] != n_cols or a.shape[0] < n_sectors:
            raise ValueError(f"{name} must be (S_pad >= {n_sectors}, "
                             f"{n_cols}), got {tuple(a.shape)}")
    for name, a in (("lum", lum), ("sec_cos", sec_cos), ("q", q),
                    ("visits", visits)):
        if a.dtype != torch.float32 or not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
        if a.device != tris.device:
            raise ValueError(f"{name} must be on the tables' device")
    if q.shape != visits.shape:
        raise ValueError("q and visits must have one shape")
    if clock is not None:
        if not tris.is_cuda:
            raise ValueError("clock takes the timed B2: CUDA tables only")
        rows = train_blocks(n_slots, tris.device)
        cols = len(profiling.CLOCK_COLS)
        if (clock.dtype != torch.int64 or clock.device != tris.device
                or not clock.is_contiguous() or clock.dim() != 2
                or clock.shape[0] < rows or clock.shape[1] != cols):
            raise ValueError(f"clock must be a contiguous int64 (>= {rows}, "
                             f"{cols}) tensor on {tris.device}")


def mega_train_frame(seed: int, cam: tuple, tris: torch.Tensor,
                     mat: torch.Tensor, cdf_t: torch.Tensor, lum: torch.Tensor,
                     sec_cos: torch.Tensor, q: torch.Tensor,
                     visits: torch.Tensor, sector_grid: int, uv_bins: int,
                     radiance_threshold: float, cfg: RenderConfig,
                     n_slots: int, pix_mux: int,
                     clock: torch.Tensor | None = None):
    """One learning frame of kernel B2 over ``cdf_t`` (the (C, S_pad) bf16
    table, transposed and contiguous), ``lum`` (C,) the bins' luminance,
    ``sec_cos`` (S,) the sectors' cos(theta), and ``q``, ``visits``
    (S_pad, C) f32, which are left untouched.  Returns (rad, path_sum,
    iters, q, visits, td) as mega_train_frame_plain does.  CPU tensors take
    the twin.

    On the card the frame is one cooperative launch of a persistent
    kernel that runs the iterations on the device (step, grid barrier,
    apply, grid barrier) and stops when no slot is active; the host does
    not synchronise inside it.  A grid that cannot be co-resident raises
    RuntimeError.  ``clock``: a contiguous int64 CUDA tensor of
    train_blocks(n_slots, device) or more rows of
    len(profiling.CLOCK_COLS); then the timed build (KERNEL_TIMED) runs
    the same frame, bit for bit, and adds each block's phase cycles into
    its row."""
    with profiling.span("render_sarsa_mega_train.check"):
        _check_train_inputs(tris, mat, cdf_t, lum, sec_cos, q, visits,
                            sector_grid, uv_bins, n_slots, clock)
    n_cols = cdf_t.shape[0]
    n_sectors = sector_grid * sector_grid
    if tris.device.type == "cpu":
        check_cdf_order(cdf_t)
        return mega_train_frame_plain(seed, cam, tris, mat, cdf_t, lum,
                                      sec_cos, q, visits, sector_grid,
                                      uv_bins, radiance_threshold, cfg,
                                      n_slots, pix_mux)
    if tris.device.type != "cuda":
        raise ValueError(f"no kernel for device {tris.device}")
    dev = tris.device
    with profiling.span("render_sarsa_mega_train.outputs"):
        f32 = dict(dtype=torch.float32, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        q_out, v_out = q.clone(), visits.clone()
        sum_t = torch.zeros(q.shape, **f32)
        cnt = torch.zeros(q.shape, **f32)
        irr = torch.zeros((2, n_cols), **f32)
        fstate = torch.empty((9, n_slots), **f32)   # csrc/mega_train.cu:FRow
        istate = torch.empty((5, n_slots), **i32)   # csrc/mega_train.cu:IRow
        flags = torch.zeros((2,), **i32)
        rad = torch.zeros((pix_mux, n_slots, 3), **f32)
        path_sum = torch.zeros((n_slots,), **f32)
        iters = torch.zeros((n_slots,), **i32)
        td = torch.zeros((n_slots,), **f32)
    # the frame's one wait for the card, after everything the host can
    # queue behind the last frame: only the launch follows it
    check_cdf_order(cdf_t)
    with profiling.span("render_sarsa_mega_train.launch"), \
            torch.cuda.device(dev):
        params = mega_params(
            seed, cam, tris.shape[0], cfg, n_slots, pix_mux,
            n_sectors=n_sectors, sector_grid=sector_grid, uv_bins=uv_bins,
            s_pad=cdf_t.shape[1], pdf_scale=n_sectors / (2.0 * PI),
            inv_gdir=1.0 / sector_grid)
        max_iters = pix_mux * cfg.samples_per_pixel * cfg.max_ray_bounces
        train = _cuda.TrainParams(n_cols=n_cols, max_iters=max_iters,
                                  radiance_threshold=radiance_threshold,
                                  irr_scale=_irr_scale(n_sectors))
        stream = torch.cuda.current_stream().cuda_stream
        (KERNEL if clock is None else KERNEL_TIMED).launch(
            params, train, tris.data_ptr(), mat.data_ptr(), cdf_t.data_ptr(),
            lum.data_ptr(), sec_cos.data_ptr(), q_out.data_ptr(),
            v_out.data_ptr(), sum_t.data_ptr(), cnt.data_ptr(),
            irr.data_ptr(), fstate.data_ptr(), istate.data_ptr(),
            flags.data_ptr(), rad.data_ptr(), path_sum.data_ptr(),
            iters.data_ptr(), td.data_ptr(),
            0 if clock is None else clock.data_ptr(), stream)
    return rad, path_sum, iters, q_out, v_out, td


def render_sarsa_mega_train(seed: int, scene: Scene, camera: Camera,
                            table: TriBinCDF, q: torch.Tensor,
                            visits: torch.Tensor, cfg: RenderConfig,
                            radiance_threshold: float, device,
                            r_tile: int = R_TILE, pix_mux: int = PIX_MUX,
                            sector_grid: int | None = None,
                            uv_bins: int | None = None):
    """One in-kernel SARSA learning frame on the binned Q-state.

    Returns (image (H, W, 3), q, visits, aux): q and visits are new
    tensors on ``device``, the inputs are left untouched; aux carries
    avg_path_length, wavefront_iterations and td_scatter_count (== the
    exact visit-count delta), 0-d device tensors.  Rebuild the CDF between
    frames with rebuild_bin_cdf (the reference's once-per-frame
    schedule).  ``seed`` is the kernel's int seed, as in
    ops.megakernel.render_default_mega.  ``sector_grid`` and ``uv_bins``
    are the table's (guided_mega_train.py:474-475): the TriBinCDF carries
    them, so they are checks, and a value other than the table's raises
    ValueError.
    """
    for name, given, own in (("sector_grid", sector_grid, table.sector_grid),
                             ("uv_bins", uv_bins, table.uv_bins)):
        if given is not None and given != own:
            raise ValueError(f"{name}={given} differs from the table's "
                             f"{own}")
    t_pad = _t_pad(scene.n_triangles)
    if t_pad > T_CHUNK:
        raise ValueError("binned SARSA megakernel supports single-chunk "
                         f"scenes (<= {T_CHUNK} padded triangles)")
    if table.t_pad != t_pad:
        raise ValueError(f"table t_pad {table.t_pad} != scene t_pad {t_pad}")
    device = torch.device(device)
    with profiling.span("render_sarsa_mega_train.pack"):
        scene = scene.to(device)
        tris, mat = pack_scene(scene)
        cam = camera_vector(camera)
        n_slots = n_slots_for(cfg.n_pixels, r_tile, pix_mux)

    def f32(a):
        return a.to(device=device, dtype=torch.float32).contiguous()

    with profiling.span("render_sarsa_mega_train.tables"):
        cdf_t = table.cdf.to(device).T.contiguous()
        lum = bin_luminance(scene, t_pad, table.uv_bins)[0]
        sec_cos = hs.sector_cos_thetas(table.sector_grid, device)
        q, visits = f32(q), f32(visits)
    clock = None   # B2's phase clock, while a profiler records
    if tris.is_cuda and profiling.recording():
        clock = profiling.RECORDER.clock(
            train_blocks(n_slots, tris.device), tris.device)
    rad, path_sum, iters, q, visits, td = mega_train_frame(
        seed, cam, tris, mat, cdf_t, lum, sec_cos, q, visits,
        table.sector_grid, table.uv_bins, radiance_threshold, cfg, n_slots,
        pix_mux, clock)
    with profiling.span("render_sarsa_mega_train.assemble"):
        img, aux = assemble(rad, path_sum, iters, cfg)
        aux["td_scatter_count"] = td.double().sum().long()
    return img, q, visits, aux
