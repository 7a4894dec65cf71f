"""Hemisphere sampling math (counterpart of ``rlrpt_tpu/ops/hemisphere.py``).

Chiu's concentric square->hemisphere map (ref: hemisphere_helpers.cu:
134-226), sector-centre cosines and uniform hemisphere sampling
(ref: hemisphere_helpers.cu:8-25, :67-93).  The cosine between a sector
direction and the normal is the local y coordinate of the mapped point
(the frame is a rotation taking local y to the normal), so the per-sector
cos(theta) table is one constant (n_sectors,) vector.
"""

from __future__ import annotations

import math

import torch

from rlrpt_tpu_torch.ops.linalg import make_frame

PI = math.pi


def concentric_map(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Map points of the unit square to the unit hemisphere (y up).

    Branch-free 8-octant Chiu map.  x, y: (...,) in [0, 1].  Returns
    (..., 3) unit vectors with y >= 0.
    """
    a = 2.0 * x - 1.0
    b = 2.0 * y - 1.0
    abv = b > -a   # above y = -x
    blw = b < a    # below y = x
    pos_b = b > 0.0
    pos_a = a > 0.0
    w = torch.where

    def c(v):
        return torch.full_like(a, v)

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
    safe_xx = w(origin, torch.ones_like(xx), xx)
    cos_t = 1.0 - xx * xx
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = offset + (PI / 4.0) * (yy / safe_xx)
    out = torch.stack([sin_t * torch.cos(phi), cos_t, sin_t * torch.sin(phi)],
                      dim=-1)
    # Origin (and any degenerate xx == 0 point) -> straight up, as in the ref.
    up = torch.tensor([0.0, 1.0, 0.0], dtype=out.dtype, device=out.device)
    return w(origin[..., None], up.expand(out.shape), out)


def grid_pos_to_local(gx: torch.Tensor, gy: torch.Tensor,
                      grid_resolution: int) -> torch.Tensor:
    """Continuous grid coordinates -> local hemisphere point
    (ref: hemisphere_helpers.cu:96-105)."""
    g = float(grid_resolution)
    return concentric_map(gx / g, gy / g)


def sector_centre_dirs_local(grid_resolution: int,
                             device="cpu") -> torch.Tensor:
    """Local directions of all sector centres, idx = sx*G + sy
    (ref: radiance_volume.cu:61).  Returns (n_sectors, 3)."""
    g = grid_resolution
    ar = torch.arange(g, dtype=torch.float32, device=device)
    sx = ar.repeat_interleave(g)
    sy = ar.repeat(g)
    return grid_pos_to_local(sx + 0.5, sy + 0.5, g)


def sector_cos_thetas(grid_resolution: int, device="cpu") -> torch.Tensor:
    """cos(theta) of each sector centre == its local y.  (n_sectors,)."""
    return sector_centre_dirs_local(grid_resolution, device)[:, 1]


def uniform_hemisphere_local(r1: torch.Tensor,
                             r2: torch.Tensor) -> torch.Tensor:
    """Uniform unit-hemisphere sample in local coords, y = cos(theta) = r1
    (ref: hemisphere_helpers.cu:8-25)."""
    sin_t = torch.sqrt(torch.clamp(1.0 - r1 * r1, min=0.0))
    phi = 2.0 * PI * r2
    return torch.stack([sin_t * torch.cos(phi), r1, sin_t * torch.sin(phi)],
                       dim=-1)


def sample_uniform_direction(generator: torch.Generator,
                             normal: torch.Tensor):
    """Uniform directions about normals (..., 3); returns (dir, cos_theta).

    Local x maps to B, y to N, z to T (ref: hemisphere_helpers.cu:67-93).
    """
    r = torch.rand(normal.shape[:-1] + (2,), generator=generator,
                   device=normal.device)
    cos_theta = r[..., 0]
    local = uniform_hemisphere_local(cos_theta, r[..., 1])
    frame = make_frame(normal)
    t, n, b = frame[..., 0, :], frame[..., 1, :], frame[..., 2, :]
    d = local[..., 0:1] * b + local[..., 1:2] * n + local[..., 2:3] * t
    return d, cos_theta
