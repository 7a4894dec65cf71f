"""Frozen guidance table of the guided megakernel (counterpart of
``rlrpt_tpu/radiance/bake.py``; ``bake_tri_bin_cdf`` is not ported yet).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class TriBinCDF:
    """cdf: (S_pad, C) bf16 per-column CDFs over the sector grid; padding
    rows (>= n_sectors) hold 2.0 sentinels (never < a uniform).
    Column c = tri * uv_bins^2 + iu * uv_bins + iv with
    iu = floor(u * uv_bins), iv = floor(v * uv_bins) of the barycentric hit
    coordinates (u along v1-v0, v along v2-v0)."""

    cdf: torch.Tensor
    sector_grid: int
    uv_bins: int
    t_pad: int

    @property
    def n_sectors(self) -> int:
        return self.sector_grid * self.sector_grid

    @property
    def n_columns(self) -> int:
        return self.t_pad * self.uv_bins * self.uv_bins
