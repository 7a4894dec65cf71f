"""The guided (frozen-map) path-tracing megakernel (counterpart of
``rlrpt_tpu/ops/guided_mega.py``).

The default megakernel's slot loop, but each surface bounce samples a
sector from a frozen bf16 CDF column keyed on (hit triangle, quantised
barycentric u, v) — a ``TriBinCDF`` — with pdf = (hi - lo) * S / 2pi
computed from the same rounded values the draw compared (the last sector
takes 1 - lo), and maps the sector plus in-sector jitter to a direction
with the Chiu concentric map.  The estimator is unbiased for any table.

As in ``ops.megakernel``: ``mega_guided_frame`` wraps the CUDA kernel B3
(``csrc/mega_guided.cu``) and runs the plain twin
``mega_guided_frame_plain`` for CPU tensors.  The TPU kernel's one-hot MXU
column fetch and its VMEM column cap and ray-tile narrowing do not carry
over: a column is a load.

``ablate`` is the JAX kernel's perf-attribution switch
(guided_mega.py:340-370): ``"uniform"`` draws the sector uniformly at the
uniform pdf and reads no table, ``"fetch"`` also reads the hit's bin
column (its first entry, kept live as JAX keeps its fetched row).  Each
mode is a CUDA kernel of its own with its own launch count
(``KERNEL_UNIFORM``, ``KERNEL_FETCH``); the twin has the same modes.  The
images of those modes are wrong by design: the kernels time the guided
sampler's share of B3 by difference.  JAX sends an unknown mode down the
``"fetch"`` branch; the port raises ValueError.
"""

from __future__ import annotations

import ctypes
import math

import torch

from rlrpt_tpu_torch import _cuda
from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.config import RenderConfig
from rlrpt_tpu_torch.ops.megakernel import (PIX_MUX, R_TILE, T_CHUNK,
                                            _frame_tb, _t_pad, _uniform,
                                            assemble, camera_vector,
                                            check_tables, frame_outputs,
                                            mega_params, n_slots_for,
                                            pack_scene, run_slots_plain)
from rlrpt_tpu_torch.radiance.bake import TriBinCDF
from rlrpt_tpu_torch.scene.scene import Scene
from rlrpt_tpu_torch.utils import profiling

PI = math.pi


def _concentric_dir(gx, gy, nx, ny, nz):
    """Chiu concentric map of unit-square (gx, gy) to the hemisphere about
    normal n; returns (dx, dy, dz, cos_theta) (guided_mega.py:72-134).

    The math of hemisphere.concentric_map + linalg.make_frame inlined on
    (R,) vectors: world = lx*T + ly*N + lz*B, cos_theta = ly.
    """
    w = torch.where

    def c(v):
        return torch.full_like(gx, v)

    a = 2.0 * gx - 1.0
    b = 2.0 * gy - 1.0
    abv, blw, pos_b, pos_a = b > -a, b < a, b > 0.0, a > 0.0
    xx = w(abv, w(blw, a, b), w(b > a, -a, -b))
    yy = w(abv,
           w(blw, w(pos_b, b, a + b), w(pos_a, b - a, -a)),
           w(b > a, w(pos_b, -a - b, -b), w(pos_a, a, a - b)))
    offset = w(abv,
               w(blw, w(pos_b, c(0.0), c(7.0 * PI / 4.0)),
                 w(pos_a, c(PI / 4.0), c(PI / 2.0))),
               w(b > a, w(pos_b, c(3.0 * PI / 4.0), c(PI)),
                 w(pos_a, c(3.0 * PI / 2.0), c(5.0 * PI / 4.0))))
    origin = xx == 0.0
    safe_xx = w(origin, c(1.0), xx)
    cos_t = 1.0 - xx * xx
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = offset + float(PI / 4.0) * (yy / safe_xx)
    lx = w(origin, c(0.0), sin_t * torch.cos(phi))
    lz = w(origin, c(0.0), sin_t * torch.sin(phi))
    ly = w(origin, c(1.0), cos_t)
    (tx, ty, tz), (bx, by, bz) = _frame_tb(nx, ny, nz)
    return (lx * tx + ly * nx + lz * bx, lx * ty + ly * ny + lz * by,
            lx * tz + ly * nz + lz * bz, ly)


def bin_column(hit, uv_bins: int) -> torch.Tensor:
    """Column of the binned tables for each hit: tri * uv^2 + iu * uv + iv,
    (iu, iv) the clipped bins of barycentric u'/det, v'/det
    (csrc/path_common.cuh:bin_column)."""
    _, tri, up, vp, det = hit
    dsafe = torch.where(det == 0.0, torch.ones_like(det), det)
    iu = torch.clamp((up / dsafe * uv_bins).to(torch.int64), 0, uv_bins - 1)
    iv = torch.clamp((vp / dsafe * uv_bins).to(torch.int64), 0, uv_bins - 1)
    return tri * (uv_bins * uv_bins) + iu * uv_bins + iv


ABLATE_MODES = ("none", "uniform", "fetch")


def _f32(x: float) -> float:
    """x rounded to float32, as the kernels' parameters are."""
    return float(torch.tensor(x, dtype=torch.float32))


def check_ablate(ablate: str) -> None:
    if ablate not in ABLATE_MODES:
        raise ValueError(f"ablate must be one of {ABLATE_MODES}, got "
                         f"{ablate!r}")


def _cdf_sampler(seed: int, cdf_t: torch.Tensor, sector_grid: int,
                 uv_bins: int, ablate: str = "none"):
    """The guided bounce of the twin over a (C, S_pad) transposed table.
    Its info is (sector, column) of every slot's draw (column None under
    ablate="uniform", which reads no table)."""
    check_ablate(ablate)
    n_sectors = sector_grid * sector_grid
    pdf_scale = _f32(n_sectors / (2.0 * PI))
    inv_gdir = _f32(1.0 / sector_grid)
    uniform_pdf = _f32(1.0 / n_sectors)

    def _sector_bounce(sector, pdf, u1, u2, nx, ny, nz):
        """(dx, dy, dz, scale) of a bounce into ``sector`` at density
        ``pdf`` (csrc/path_common.cuh:sector_bounce)."""
        pdf_safe = torch.clamp(pdf, min=1e-12)
        sxg = torch.div(sector, sector_grid, rounding_mode="floor")
        syg = sector - sxg * sector_grid
        gx = (sxg.float() + u1) * inv_gdir
        gy = (syg.float() + u2) * inv_gdir
        dx, dy, dz, cost = _concentric_dir(gx, gy, nx, ny, nz)
        # throughput *= (diffuse/pi) * cos / pdf
        return dx, dy, dz, cost / (float(PI) * pdf_safe)

    def sample(pix, it1, u1, u2, hit, nx, ny, nz):
        us = _uniform(seed, pix, it1, 5)
        if ablate != "none":
            # guided_mega.py:358-362: a uniform sector; "fetch" folds the
            # column's first entry * 1e-30 (0 after truncation) into it
            sector = (us * n_sectors).to(torch.int64)
            column = None
            if ablate == "fetch":
                column = bin_column(hit, uv_bins)
                sector = sector + (cdf_t[column, 0].float() * 1e-30).to(
                    torch.int64)
            sector = torch.clamp(sector, max=n_sectors - 1)
            pdf = torch.full_like(us, uniform_pdf) * pdf_scale
            return _sector_bounce(sector, pdf, u1, u2, nx, ny, nz) + (
                (sector, column),)
        column = bin_column(hit, uv_bins)
        col = cdf_t[column].float()
        cnt = (col < us[:, None]).sum(dim=1)
        sector = torch.clamp(cnt, max=n_sectors - 1)
        hi = col.gather(1, sector[:, None])[:, 0]
        lo = torch.where(sector > 0,
                         col.gather(1, (sector - 1).clamp(min=0)[:, None])[:, 0],
                         0.0)
        # The last sector absorbs every draw >= cdf[S-2]: its probability
        # is 1 - lo.
        hi = torch.where(sector == n_sectors - 1, 1.0, hi)
        pdf = torch.clamp(hi - lo, min=0.0) * pdf_scale
        return _sector_bounce(sector, pdf, u1, u2, nx, ny, nz) + (
            (sector, column),)

    return sample


def mega_guided_frame_plain(seed: int, cam: tuple, tris: torch.Tensor,
                            mat: torch.Tensor, cdf_t: torch.Tensor,
                            sector_grid: int, uv_bins: int,
                            cfg: RenderConfig, n_slots: int, pix_mux: int,
                            ablate: str = "none"):
    """Plain torch twin of kernel B3 (or, with ``ablate``, of its ablated
    kernels) on the same inputs."""
    return run_slots_plain(seed, cam, tris, mat, cfg, n_slots, pix_mux,
                           _cdf_sampler(seed, cdf_t, sector_grid, uv_bins,
                                        ablate))


def check_cdf(cdf_t: torch.Tensor, tris: torch.Tensor, sector_grid: int,
              uv_bins: int) -> None:
    """What the guided kernels take of a transposed (C, S_pad) table:
    among it, every column non-decreasing (padding rows included), since
    the kernels find the sector #{entries < u} by a binary search.  Every
    table the package builds is (``rebuild_bin_cdf``, ``bake_tri_bin_cdf``:
    cumulative sums, padded with 2.0, rounded to bf16 monotonically).
    That test costs one reduction over the table and one host sync per
    frame, on the CPU and the card alike; a decreasing column raises
    ValueError."""
    n_cols = tris.shape[0] * uv_bins * uv_bins
    if (cdf_t.dim() != 2 or cdf_t.shape[0] < n_cols
            or cdf_t.dtype != torch.bfloat16 or not cdf_t.is_contiguous()):
        raise ValueError(f"cdf_t must be a contiguous bf16 (C >= {n_cols}, "
                         f"S_pad) table, got {cdf_t.dtype} "
                         f"{tuple(cdf_t.shape)}")
    if cdf_t.shape[1] < sector_grid * sector_grid:
        raise ValueError(f"table has {cdf_t.shape[1]} sector rows for "
                         f"{sector_grid}x{sector_grid} sectors")
    if cdf_t.device != tris.device:
        raise ValueError("cdf_t must be on the tables' device")
    with profiling.host_sync("check_cdf", cdf_t):
        bad = int(torch.count_nonzero(
            (cdf_t[:, 1:] < cdf_t[:, :-1]).any(dim=1)))
    if bad:
        raise ValueError(f"{bad} CDF column(s) decrease: the guided kernels "
                         "need every column non-decreasing")


_ARGS = [_cuda.MegaParams] + [ctypes.c_void_p] * 8
KERNEL = _cuda.Kernel("rlrpt_mega_guided", _ARGS)
# B3's ablated kernels (ablate="uniform", "fetch"), counted apart
KERNEL_UNIFORM = _cuda.Kernel("rlrpt_mega_guided_uniform", _ARGS)
KERNEL_FETCH = _cuda.Kernel("rlrpt_mega_guided_fetch", _ARGS)
_KERNELS = {"none": KERNEL, "uniform": KERNEL_UNIFORM, "fetch": KERNEL_FETCH}


def mega_guided_frame(seed: int, cam: tuple, tris: torch.Tensor,
                      mat: torch.Tensor, cdf_t: torch.Tensor,
                      sector_grid: int, uv_bins: int, cfg: RenderConfig,
                      n_slots: int, pix_mux: int, ablate: str = "none"):
    """One frame of kernel B3 over ``cdf_t``, the (C, S_pad) bf16 table
    transposed and contiguous.  Returns (rad, path_sum, iters) as
    ops.megakernel.mega_default_frame does.  ``ablate`` ("none",
    "uniform", "fetch") picks B3 or one of its ablated kernels.  CPU
    tensors take the twin."""
    with profiling.span("render_guided_mega.check"):
        check_ablate(ablate)
        check_tables(tris, mat)
        check_cdf(cdf_t, tris, sector_grid, uv_bins)
    if tris.device.type == "cpu":
        return mega_guided_frame_plain(seed, cam, tris, mat, cdf_t,
                                       sector_grid, uv_bins, cfg, n_slots,
                                       pix_mux, ablate)
    if tris.device.type != "cuda":
        raise ValueError(f"no kernel for device {tris.device}")
    s_pad = cdf_t.shape[1]
    n_sectors = sector_grid * sector_grid
    with profiling.span("render_guided_mega.launch"), \
            torch.cuda.device(tris.device):
        params = mega_params(
            seed, cam, tris.shape[0], cfg, n_slots, pix_mux,
            n_sectors=n_sectors, sector_grid=sector_grid, uv_bins=uv_bins,
            s_pad=s_pad, pdf_scale=n_sectors / (2.0 * PI),
            inv_gdir=1.0 / sector_grid)
        rad, path_sum, iters, nxt = frame_outputs(n_slots, pix_mux,
                                                  tris.device)
        stream = torch.cuda.current_stream().cuda_stream
        _KERNELS[ablate].launch(params, tris.data_ptr(), mat.data_ptr(),
                                cdf_t.data_ptr(), rad.data_ptr(),
                                path_sum.data_ptr(), iters.data_ptr(),
                                nxt.data_ptr(), stream)
    return rad, path_sum, iters


def render_guided_mega(seed: int, scene: Scene, camera: Camera,
                       table: TriBinCDF, cfg: RenderConfig, device,
                       r_tile: int = R_TILE, pix_mux: int = PIX_MUX,
                       ablate: str = "none"):
    """Render a frame with frozen-map guided sampling; returns (image,
    aux).  ``seed`` is the kernel's int seed, as in
    ops.megakernel.render_default_mega.

    Same estimator as the SARSA wavefront's inference side (importance
    sample the learned CDF, weight by brdf*cos/pdf, ref:
    reinforcement_path_tracing.cu:85-120).  ``ablate`` ("uniform",
    "fetch") is perf attribution only: those frames are wrong by design
    (the module's docstring).
    """
    t_pad = _t_pad(scene.n_triangles)
    n_chunks = t_pad // min(t_pad, T_CHUNK)
    if n_chunks > 1 and table.uv_bins != 1:
        raise ValueError(
            f"multi-chunk scenes ({t_pad} padded triangles) run guided "
            "inference with PER-TRIANGLE tables — bake with uv_bins=1")
    if table.t_pad != t_pad:
        raise ValueError(
            f"table baked for t_pad={table.t_pad} but scene packs to "
            f"{t_pad}; re-bake the table for this scene")
    device = torch.device(device)
    with profiling.span("render_guided_mega.pack"):
        tris, mat = pack_scene(scene.to(device))
        cam = camera_vector(camera)
        n_slots = n_slots_for(cfg.n_pixels, r_tile, pix_mux)
    with profiling.span("render_guided_mega.tables"):
        cdf_t = table.cdf.to(device).T.contiguous()
    out = mega_guided_frame(seed, cam, tris, mat, cdf_t, table.sector_grid,
                            table.uv_bins, cfg, n_slots, pix_mux, ablate)
    with profiling.span("render_guided_mega.assemble"):
        return assemble(*out, cfg)
