"""Host helpers of the binned expected-SARSA pipeline (counterpart of
``rlrpt_tpu/ops/guided_mega_train.py``).

``bin_luminance``, ``init_bin_q`` and ``rebuild_bin_cdf`` are ported; the
in-kernel learning frame (``_train_kernel``, ``render_sarsa_mega_train``)
is still to be ported (ROADMAP queue B, item B2).

``rebuild_bin_cdf`` sums and scans in the order XLA's CPU backend uses for
the JAX reference, so its bf16 table is bit-identical to the reference's
(the sector axis is at most 256 long for every grid up to 16x16).
"""

from __future__ import annotations

import math

import torch

from rlrpt_tpu_torch.ops import hemisphere as hs
from rlrpt_tpu_torch.radiance.bake import TriBinCDF
from rlrpt_tpu_torch.scene.scene import Scene


def bin_luminance(scene: Scene, t_pad: int, uv_bins: int) -> torch.Tensor:
    """(1, C) per-bin surface luminance (every bin of a triangle shares
    its material luminance)."""
    lum = torch.zeros((t_pad,), dtype=torch.float32, device=scene.device)
    lum[:scene.n_triangles] = scene.luminance.float()
    return lum.repeat_interleave(uv_bins * uv_bins)[None, :]


def init_bin_q(t_pad: int, uv_bins: int, sector_grid: int,
               initial_radiance: float, device="cpu"):
    """Fresh (q, visits), (S_pad, C) float32 each.  Padding sector rows
    hold zeros (never scattered into: the sampler clamps to S-1)."""
    s = sector_grid * sector_grid
    s_pad = int(math.ceil(s / 8) * 8)
    c = t_pad * uv_bins * uv_bins
    q = torch.zeros((s_pad, c), dtype=torch.float32, device=device)
    q[:s] = initial_radiance
    return q, torch.zeros((s_pad, c), dtype=torch.float32, device=device)


def _sum0(x: torch.Tensor) -> torch.Tensor:
    """Sum over dim 0 in XLA's CPU order: a reduction longer than 32 is
    padded (half the padding in front) to windows of 32 that are summed in
    sequence, then the window sums are reduced the same way."""
    n = x.shape[0]
    if n <= 32:
        acc = torch.zeros_like(x[0])
        for row in x:
            acc = acc + row
        return acc
    pad = -n % 32
    lo = pad // 2
    xp = torch.cat([x.new_zeros((lo,) + x.shape[1:]), x,
                    x.new_zeros((pad - lo,) + x.shape[1:])])
    windows = xp.reshape((-1, 32) + x.shape[1:])
    acc = torch.zeros_like(windows[:, 0])
    for j in range(32):
        acc = acc + windows[:, j]
    return _sum0(acc)


def _cumsum0(x: torch.Tensor) -> torch.Tensor:
    """Inclusive scan over dim 0 in XLA's CPU order: the axis is padded at
    the end to blocks of 16, each block is scanned in sequence, and the
    running total of the preceding blocks is added to it."""
    n = x.shape[0]
    nb = -(-n // 16)
    xp = torch.cat([x, x.new_zeros((nb * 16 - n,) + x.shape[1:])])
    blocks = xp.reshape((nb, 16) + x.shape[1:])
    scan = torch.empty_like(blocks)
    acc = torch.zeros_like(blocks[:, 0])
    for j in range(16):
        acc = acc + blocks[:, j]
        scan[:, j] = acc
    if nb > 1:
        before = torch.zeros_like(scan[:, -1])
        for b in range(1, nb):
            before[b] = before[b - 1] + scan[b - 1, -1]
        scan = scan + before[:, None]
    return scan.reshape(xp.shape)[:n]


def rebuild_bin_cdf(q: torch.Tensor, sector_grid: int, uv_bins: int,
                    t_pad: int, distribution_threshold: float = 0.0,
                    defensive_mix: float = 0.0) -> TriBinCDF:
    """Frame-boundary CDF rebuild from the binned Q (the reference's
    update_radiance_distribution, radiance_volume.cu:149-188, on the
    binned state space).  Returns a bf16 TriBinCDF for the next frame."""
    s = sector_grid * sector_grid
    s_pad = q.shape[0]
    cos = hs.sector_cos_thetas(sector_grid, q.device)
    w = torch.clamp(q[:s] * cos[:, None], min=distribution_threshold)
    total = 1e-10 + _sum0(w)[None, :]
    p = w / total
    if defensive_mix:
        p = (1.0 - defensive_mix) * p + defensive_mix / s
    cdf = _cumsum0(p)
    cdf[s - 1] = 1.0
    out = torch.full((s_pad, q.shape[1]), 2.0, dtype=torch.float32,
                     device=q.device)
    out[:s] = cdf
    return TriBinCDF(cdf=out.to(torch.bfloat16), sector_grid=sector_grid,
                     uv_bins=uv_bins, t_pad=t_pad)
