"""State carried across from the JAX package as numpy arrays.

The parity tests build both sides through these: the JAX objects are
turned into numpy (``np.asarray``) and handed over here, so this package
never imports the JAX one.
"""

from __future__ import annotations

import numpy as np
import torch

from rlrpt_tpu_torch.radiance.bake import TriBinCDF
from rlrpt_tpu_torch.scene.scene import Scene


def scene_from_numpy(v0, v1, v2, normal, diffuse_c, emission, luminance,
                     n_surfaces: int, device="cpu") -> Scene:
    """A Scene from the JAX Scene's arrays (surfaces first, then lights)."""
    t = lambda a: torch.as_tensor(  # noqa: E731
        np.array(a, np.float32), device=device)
    return Scene(v0=t(v0), v1=t(v1), v2=t(v2), normal=t(normal),
                 diffuse_c=t(diffuse_c), emission=t(emission),
                 luminance=t(luminance), n_surfaces=int(n_surfaces))


def tri_bin_cdf_from_numpy(cdf, sector_grid: int, uv_bins: int, t_pad: int,
                           device="cpu") -> TriBinCDF:
    """A TriBinCDF from a JAX table's (S_pad, C) cdf.  The values are
    rounded to bf16 as the JAX kernel rounds them; a bf16 table converts
    exactly."""
    cdf = torch.as_tensor(np.array(cdf, np.float32), device=device)
    return TriBinCDF(cdf=cdf.to(torch.bfloat16), sector_grid=sector_grid,
                     uv_bins=uv_bins, t_pad=t_pad)


def bin_q_from_numpy(q, visits, device="cpu"):
    """The binned trainer's (q, visits), (S_pad, C) float32 each."""
    return (torch.as_tensor(np.array(q, np.float32), device=device),
            torch.as_tensor(np.array(visits, np.float32), device=device))
