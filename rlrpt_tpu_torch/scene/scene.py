"""SoA scene container (counterpart of ``rlrpt_tpu/scene/scene.py``).

Surfaces and area lights live in ONE triangle array, surfaces
``[0, n_surfaces)`` first and lights after, so a closest-hit sweep that
keeps strictly closer hits tests surfaces before lights — the reference's
tie-break (ray.cu:17-36).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rlrpt_tpu_torch.scene.geometry import luminance, triangle_normals

# Intersection types (ref: ray.cuh:30-45 enum NOTHING/AREA_LIGHT/SURFACE).
NOTHING = 0
AREA_LIGHT = 1
SURFACE = 2


@dataclasses.dataclass(frozen=True)
class Scene:
    """All triangles of a scene as float32 tensors on one device."""

    v0: torch.Tensor         # (T, 3)
    v1: torch.Tensor         # (T, 3)
    v2: torch.Tensor         # (T, 3)
    normal: torch.Tensor     # (T, 3)  normalize(cross(e2, e1))
    diffuse_c: torch.Tensor  # (T, 3) reflectance; zeros for lights
    emission: torch.Tensor   # (T, 3) light diffuse_p; zeros for surfaces
    luminance: torch.Tensor  # (T,)   0.5*(max+min) of diffuse_c / diffuse_p
    n_surfaces: int

    @property
    def n_triangles(self) -> int:
        return self.v0.shape[0]

    @property
    def device(self) -> torch.device:
        return self.v0.device

    def to(self, device) -> "Scene":
        return dataclasses.replace(
            self, v0=self.v0.to(device), v1=self.v1.to(device),
            v2=self.v2.to(device), normal=self.normal.to(device),
            diffuse_c=self.diffuse_c.to(device),
            emission=self.emission.to(device),
            luminance=self.luminance.to(device))


def build_scene(surf_v0, surf_v1, surf_v2, surf_rgb,
                light_v0, light_v1, light_v2, light_power,
                device="cpu") -> Scene:
    """Assemble a Scene from host numpy surface + light triangle soup."""
    f32 = lambda a: np.asarray(a, np.float32).reshape(-1, 3)  # noqa: E731
    surf_v0, surf_v1, surf_v2 = f32(surf_v0), f32(surf_v1), f32(surf_v2)
    light_v0, light_v1, light_v2 = f32(light_v0), f32(light_v1), f32(light_v2)
    surf_rgb, light_power = f32(surf_rgb), f32(light_power)

    ns, nl = len(surf_v0), len(light_v0)
    v0 = np.concatenate([surf_v0, light_v0], axis=0)
    v1 = np.concatenate([surf_v1, light_v1], axis=0)
    v2 = np.concatenate([surf_v2, light_v2], axis=0)
    normal = triangle_normals(v0, v1, v2)
    diffuse_c = np.concatenate([surf_rgb, np.zeros((nl, 3), np.float32)])
    emission = np.concatenate([np.zeros((ns, 3), np.float32), light_power])
    lum = np.concatenate([luminance(surf_rgb), luminance(light_power)])

    as_t = lambda a: torch.as_tensor(  # noqa: E731
        np.asarray(a, np.float32), device=device)
    return Scene(v0=as_t(v0), v1=as_t(v1), v2=as_t(v2), normal=as_t(normal),
                 diffuse_c=as_t(diffuse_c), emission=as_t(emission),
                 luminance=as_t(lum), n_surfaces=ns)
