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

from rlrpt_tpu_torch.scene.geometry import (luminance, triangle_areas,
                                            triangle_normals)

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

    @property
    def vertices_flat(self) -> torch.Tensor:
        """Flat (T*9,) vertex list in the reference's order (v0 v1 v2 per
        triangle, surfaces then lights): the DQN input encoding and the
        vertices.txt contract (ref: scene.cu:63-88)."""
        return torch.cat([self.v0, self.v1, self.v2], dim=-1).reshape(-1)

    @property
    def vertices_count(self) -> int:
        """Floats in the flat vertex list, the DQN's input width."""
        return self.n_triangles * 9

    def to(self, device) -> "Scene":
        return dataclasses.replace(
            self, v0=self.v0.to(device), v1=self.v1.to(device),
            v2=self.v2.to(device), normal=self.normal.to(device),
            diffuse_c=self.diffuse_c.to(device),
            emission=self.emission.to(device),
            luminance=self.luminance.to(device))


def build_scene(surf_v0, surf_v1, surf_v2, surf_rgb,
                light_v0, light_v1, light_v2, light_power,
                device="cuda") -> Scene:
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


def surface_areas(scene: Scene) -> np.ndarray:
    """Areas of the surface triangles only (host numpy, float32 as the
    scene's arrays)."""
    ns = scene.n_surfaces
    v0, v1, v2 = (a[:ns].cpu().numpy() for a in (scene.v0, scene.v1,
                                                  scene.v2))
    return triangle_areas(v0, v1, v2)


def save_vertices_to_file(scene: Scene, path: str) -> None:
    """Write vertices.txt, one `v0 v1 v2` row of 9 floats per triangle, the
    renderer <-> offline-trainer contract (ref: scene.cu:63-88)."""
    rows = torch.cat([scene.v0, scene.v1, scene.v2], dim=-1).cpu().numpy()
    with open(path, "w") as f:
        for row in rows:
            f.write(" ".join(_fmt(x) for x in row) + "\n")


def load_vertices_from_file(path: str) -> np.ndarray:
    """Read vertices.txt -> flat float32 array (ref: NN_Q_Value_Trainer/
    Source/main.cu:39-70)."""
    vals: list[float] = []
    with open(path) as f:
        for line in f:
            vals.extend(float(t) for t in line.split())
    return np.asarray(vals, np.float32)


def _fmt(x: float) -> str:
    # C++ default ostream float formatting (6 significant digits)
    return f"{float(x):.6g}"


def morton_sort_surfaces(scene: Scene) -> Scene:
    """Reorder the surface triangles along a Morton (Z-order) curve of their
    centroids; the lights keep their trailing positions.

    The JAX megakernel sweeps triangles in chunks and pre-rejects a chunk
    by its bounding box, which only pays when a chunk is spatially tight;
    OBJ files interleave distant faces.  The kernels here sweep every
    triangle and cull nothing, so the order changes only which of two
    equally close triangles wins a hit (the reference's first-tested-wins
    sweep leaves that arbitrary, ray.cu:17-36).  The code is the 10-bit
    spread of each quantised centroid axis, interleaved x|y<<1|z<<2, and
    a stable sort: the JAX package's permutation exactly.
    """
    ns = scene.n_surfaces
    host = lambda a: a[:ns].cpu().numpy().astype(np.float64)  # noqa: E731
    cen = (host(scene.v0) + host(scene.v1) + host(scene.v2)) / 3.0
    lo = cen.min(axis=0)
    ext = np.maximum(cen.max(axis=0) - lo, 1e-12)
    qi = np.clip(((cen - lo) / ext * 1023.0).astype(np.uint64), 0, 1023)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x0000FF0000FF)
        x = (x | (x << 8)) & np.uint64(0x00F00F00F00F)
        x = (x | (x << 4)) & np.uint64(0x0C30C30C30C3)
        x = (x | (x << 2)) & np.uint64(0x249249249249)
        return x

    code = (spread(qi[:, 0]) | (spread(qi[:, 1]) << np.uint64(1))
            | (spread(qi[:, 2]) << np.uint64(2)))
    perm = torch.as_tensor(np.concatenate(
        [np.argsort(code, kind="stable"),
         np.arange(ns, scene.n_triangles)]).astype(np.int64),
        device=scene.device)
    return dataclasses.replace(
        scene, v0=scene.v0[perm], v1=scene.v1[perm], v2=scene.v2[perm],
        normal=scene.normal[perm], diffuse_c=scene.diffuse_c[perm],
        emission=scene.emission[perm], luminance=scene.luminance[perm])
