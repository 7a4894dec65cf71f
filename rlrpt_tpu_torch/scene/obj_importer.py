"""Wavefront OBJ scene importer (counterpart of
``rlrpt_tpu/scene/obj_importer.py``).

The reference importer's pipeline (ref: GPU_Rendering_Engine/Source/
objects/object_importer.cu):

* `v` / `f` lines with fan triangulation, `x/x/x` face tokens included
  (object_importer.cu:22-89);
* normalisation: the literal scale factor 2 (the "/ max_difference" is
  commented out there), the min corner translated to (-1, -1, -1), then
  x and y flipped (object_importer.cu:93-145);
* material and light assignment by triangulated face index, which the
  reference hard-codes per scene (object_importer.cu:150-163, :210-314,
  :375-399) and ``scene.presets`` gives as data.

``parse_obj`` and ``normalise_vertices`` are the plain Python version;
``parse_and_normalise`` takes the native library (``utils.native``) when
it is live.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from rlrpt_tpu_torch.scene.scene import Scene, build_scene
from rlrpt_tpu_torch.utils.native import parse_obj_native


@dataclasses.dataclass(frozen=True)
class MaterialRule:
    """Assign `rgb` to triangulated face indices in [lo, hi] (inclusive)."""
    lo: int
    hi: int
    rgb: tuple


@dataclasses.dataclass(frozen=True)
class LightRange:
    """Triangulated face indices [lo, hi] (inclusive) become area lights
    (the lights_in_obj=True path, object_importer.cu:375-379)."""
    lo: int
    hi: int


@dataclasses.dataclass(frozen=True)
class LightSpec:
    """A hard-coded light quad (triangles K-I-J and K-J-L) in the
    reference's pre-normalisation l=2 coordinates, world = (1-x, 1-y, z-1)
    (the lights_in_obj=False path, object_importer.cu:210-314)."""
    I: tuple  # noqa: E741
    J: tuple
    K: tuple
    L: tuple


def parse_obj(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Parse `v` and `f` lines -> (vertices (V, 3) float64, 1-based face
    index triples (F, 3) int64).  Polygons are fan-triangulated as the
    reference does (object_importer.cu:53-77): (i0, i_k, i_{k+1})."""
    verts: list[list[float]] = []
    faces: list[tuple[int, int, int]] = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(parts[1]), float(parts[2]),
                              float(parts[3])])
            elif parts[0] == "f":
                idx = [int(tok.split("/")[0]) for tok in parts[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append((idx[0], idx[k], idx[k + 1]))
    return (np.asarray(verts, np.float64).reshape(-1, 3),
            np.asarray(faces, np.int64).reshape(-1, 3))


def normalise_vertices(verts: np.ndarray) -> np.ndarray:
    """Scale by 2, translate the min corner to (-1, -1, -1), flip x and y
    (object_importer.cu:93-145; its min starts at 0)."""
    scale = 2.0
    mn = np.minimum(verts.min(axis=0), 0.0)
    out = verts * scale + (-1.0 - mn * scale)
    out[:, 0] *= -1.0
    out[:, 1] *= -1.0
    return out


def _light_quad_triangles(spec: LightSpec) -> np.ndarray:
    """The quad's triangles (K, I, J), (K, J, L), normalised with l=2:
    scale 2/l = 1, translate -1, flip x and y (object_importer.cu:
    245-299).  Returns (2, 3, 3) float64."""
    I, J, K, L = (np.asarray(v, np.float64)  # noqa: E741
                  for v in (spec.I, spec.J, spec.K, spec.L))
    tris = np.stack([np.stack([K, I, J]), np.stack([K, J, L])]) - 1.0
    tris[..., 0] *= -1.0
    tris[..., 1] *= -1.0
    return tris


def parse_and_normalise(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Parse and normalise an OBJ: the native loader when it is live
    (float32 arithmetic), else the Python one (float64).  Both give the
    same float32 scene up to an ulp of the parse (exact on coordinates
    that float32 holds exactly).  Returns (float64 vertices, int64 faces)."""
    out = parse_obj_native(path, normalise=True)
    if out is not None:
        return np.asarray(out[0], np.float64), np.asarray(out[1], np.int64)
    verts, faces = parse_obj(path)
    return normalise_vertices(verts), faces


def load_obj_scene(path: str, default_rgb: tuple = (0.75, 0.75, 0.75),
                   material_rules: Sequence[MaterialRule] = (),
                   light_specs: Sequence[LightSpec] = (),
                   light_power: float = 8.0,
                   light_ranges: Sequence[LightRange] = (),
                   light_range_power: float = 12.0,
                   flip_winding: bool = False, device="cuda") -> Scene:
    """Load an OBJ file into a Scene on ``device``.

    With ``light_ranges``, the faces in those triangulated index ranges
    become area lights of power ``light_range_power`` (lights_in_obj);
    otherwise the ``light_specs`` quads are added as lights of power
    ``light_power``.  The first matching material rule colours a surface
    face, as the reference's if/else chains do.
    """
    verts, faces = parse_and_normalise(path)
    tri = verts[faces - 1]   # (F, 3, 3): v1, v2, v3 of each face

    def rgb_for(i: int) -> tuple:
        for r in material_rules:
            if r.lo <= i <= r.hi:
                return r.rgb
        return default_rgb

    is_light = np.zeros(len(tri), bool)
    for lr in light_ranges:
        is_light[lr.lo: lr.hi + 1] = True

    # The reference builds Surface(v1, v3, v2), a v2/v3 swap
    # (object_importer.cu:166, :377, :392); ``flip_winding`` undoes it for
    # models whose winding would then give outward normals (no two-sided
    # shading, ray.cu:69).
    if flip_winding:
        a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    else:
        a, b, c = tri[:, 0], tri[:, 2], tri[:, 1]

    surf = ~is_light
    surf_rgb = np.asarray([rgb_for(i) for i in range(len(tri))],
                          np.float32).reshape(-1, 3)[surf]
    if is_light.any():
        lv0, lv1, lv2 = a[is_light], b[is_light], c[is_light]
        lpow = np.full((int(is_light.sum()), 3), light_range_power,
                       np.float32)
    elif light_specs:
        lt = np.concatenate([_light_quad_triangles(s) for s in light_specs])
        lv0, lv1, lv2 = lt[:, 0], lt[:, 1], lt[:, 2]
        lpow = np.full((len(lt), 3), light_power, np.float32)
    else:
        lv0 = lv1 = lv2 = lpow = np.zeros((0, 3), np.float32)
    return build_scene(a[surf], b[surf], c[surf], surf_rgb, lv0, lv1, lv2,
                       lpow, device=device)
