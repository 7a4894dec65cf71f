"""Small vector-math helpers over batched (..., 3) tensors (counterpart of
``rlrpt_tpu/ops/linalg.py``)."""

from __future__ import annotations

import torch


def normalize(a: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    n = torch.sqrt(torch.sum(a * a, dim=-1, keepdim=True))
    if eps:
        n = torch.clamp(n, min=eps)
    return a / n


def make_frame(normal: torch.Tensor) -> torch.Tensor:
    """Hemisphere local->world rotation for unit normals (..., 3).

    Rows are (T, N, B) (ref: hemisphere_helpers.cu:31-63), so a local point
    p = (x, y, z) with y "up" maps to world as x*T + y*N + z*B.
    Returns (..., 3, 3).
    """
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    zero = torch.zeros_like(nx)
    use_x = (torch.abs(nx) > torch.abs(ny))[..., None]
    # |n.x| > |n.y|: T = normalize((n.z, 0, -n.x)); else normalize((0, -n.z, n.y))
    t = torch.where(use_x, torch.stack([nz, zero, -nx], dim=-1),
                    torch.stack([zero, -nz, ny], dim=-1))
    t = normalize(t, eps=1e-20)
    b = torch.linalg.cross(normal, t, dim=-1)
    return torch.stack([t, normal, b], dim=-2)
