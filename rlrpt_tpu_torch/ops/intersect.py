"""Closest-hit ray/triangle intersection, plain torch (counterpart of
``rlrpt_tpu/ops/intersect.py``).

Dense (rays x triangles) Moller-Trumbore with an argmin reduction, tiled
over rays so peak memory stays O(ray_tile * n_triangles).  The triangle
array is [surfaces..., lights...] and argmin returns the first minimum, so
surfaces are tested before lights and the first-tested triangle wins ties
(ref: ray.cu:17-36).
"""

from __future__ import annotations

import dataclasses

import torch

from rlrpt_tpu_torch.scene.scene import AREA_LIGHT, NOTHING, SURFACE, Scene

INF = 3.0e38


@dataclasses.dataclass(frozen=True)
class Hit:
    """SoA intersection record (ref: ray.cuh:30-45 Intersection)."""

    t: torch.Tensor         # (R,) distance along the (unit) ray, INF if miss
    tri: torch.Tensor       # (R,) int64 triangle index into the scene arrays
    hit_type: torch.Tensor  # (R,) int32: NOTHING / AREA_LIGHT / SURFACE
    position: torch.Tensor  # (R, 3)
    normal: torch.Tensor    # (R, 3)


def _hit_block(o: torch.Tensor, d: torch.Tensor, scene: Scene):
    """Closest hit for a block of rays o, d (R, 3) -> (t (R,), tri (R,))."""
    v0 = scene.v0
    e1, e2 = scene.v1 - v0, scene.v2 - v0
    pvec = torch.linalg.cross(d[:, None, :].expand(-1, v0.shape[0], -1),
                              e2[None].expand(d.shape[0], -1, -1), dim=-1)
    det = torch.sum(pvec * e1[None], dim=-1)
    inv_det = torch.where(det == 0.0, torch.zeros_like(det), 1.0 / det)
    tvec = o[:, None, :] - v0[None, :, :]
    u = torch.sum(tvec * pvec, dim=-1) * inv_det
    qvec = torch.linalg.cross(tvec, e1[None].expand_as(tvec), dim=-1)
    v = torch.sum(d[:, None, :] * qvec, dim=-1) * inv_det
    t = torch.sum(e2[None] * qvec, dim=-1) * inv_det
    valid = (det != 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
    t = torch.where(valid, t, torch.full_like(t, INF))
    tbest, tri = torch.min(t, dim=-1)   # first minimum wins
    return tbest, tri


def closest_hit(o: torch.Tensor, d: torch.Tensor, scene: Scene,
                ray_tile: int = 8192) -> Hit:
    """Closest intersection for rays o + t*d (d unit), tiled over rays."""
    ts, tris = [], []
    for s in range(0, o.shape[0], ray_tile):
        t, tri = _hit_block(o[s:s + ray_tile], d[s:s + ray_tile], scene)
        ts.append(t)
        tris.append(tri)
    t, tri = torch.cat(ts), torch.cat(tris)
    missed = t >= INF
    hit_type = torch.where(
        missed, NOTHING,
        torch.where(tri >= scene.n_surfaces, AREA_LIGHT, SURFACE)).to(
            torch.int32)
    t_safe = torch.where(missed, torch.zeros_like(t), t)
    position = o + t_safe[:, None] * d
    return Hit(t=t, tri=tri, hit_type=hit_type, position=position,
               normal=scene.normal[tri])
