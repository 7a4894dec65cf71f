"""A generated OBJ scene: a torus in a room with no front wall.

The reference's OBJ models are not part of the repository, so the OBJ
path is exercised on a scene written here, deterministically, at the size
of ``bunny.obj`` (4,968 faces): a torus of 46 x 54 quads, which fan
triangulation turns into exactly 4,968 triangles (a torus has no poles,
so none is degenerate), inside five inward-facing room quads (10
triangles), lit by one ceiling ``LightSpec`` (2 triangles): 4,980 in all.
``n_major`` and ``n_minor`` make smaller versions of the same scene.

Coordinates lie in [0, 1] and on a 2^-16 grid, written exactly, so the
normaliser maps them to [-1, 1] (x and y flipped, y = 1 the ceiling)
without rounding, in float32 and float64 alike.  Faces are wound so that,
after the importer's v2/v3 swap, every normal points into the room and
out of the torus, towards the camera's side.  Faces alternate between
plain ``f a b c d`` and ``f a/a/a ...`` tokens.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np

from rlrpt_tpu_torch.scene.obj_importer import LightSpec, MaterialRule
from rlrpt_tpu_torch.scene.presets import ScenePreset

BUNNY_SIZE = (46, 54)    # 2 x 46 x 54 = 4,968 triangles: bunny.obj's faces
GRID = 65536.0           # coordinates are multiples of 1 / GRID
CAMERA = (0.0, 0.0, -3.0)
# world = (1-x, 1-y, z-1): x in [-0.25, 0.25], y = -0.995 (just below the
# ceiling), z in [-0.1, 0.4]
LIGHT = LightSpec(I=(0.75, 1.995, 1.4), J=(1.25, 1.995, 1.4),
                  K=(0.75, 1.995, 0.9), L=(1.25, 1.995, 0.9))
LIGHT_POWER = 11.0
# triangulated faces 4-5 are the x = 0 wall, 6-7 the x = 1 wall
MATERIALS = (MaterialRule(4, 5, (0.75, 0.15, 0.15)),
             MaterialRule(6, 7, (0.15, 0.15, 0.75)))

_ROOM_CORNERS = [(x, y, z) for x in (0, 1) for y in (0, 1) for z in (0, 1)]
# corners 1-based as (x, y, z) in binary +1; each quad counter-clockwise
# seen from inside the room: floor, ceiling, x = 0, x = 1, back (z = 1)
_ROOM_QUADS = ((1, 2, 6, 5), (3, 7, 8, 4), (1, 3, 4, 2), (5, 6, 8, 7),
               (2, 4, 8, 6))


def _fmt(x: float) -> str:
    return f"{x:.16f}".rstrip("0").rstrip(".") or "0"


def _torus_room_obj(n_major: int, n_minor: int) -> str:
    """The scene's OBJ text: the 8 room corners, then the torus vertices
    (with ``vt`` and ``vn`` lines the parsers skip); the 5 room quads,
    then the torus quads, ring by ring."""
    big_r, small_r = 0.27, 0.11
    centre = np.array([0.5, 0.42, 0.55])
    tilt = math.radians(35.0)      # the axis leans towards the camera
    axis = np.array([0.0, math.cos(tilt), -math.sin(tilt)])
    e1 = np.array([1.0, 0.0, 0.0])
    e2 = np.cross(axis, e1)        # e1 x e2 == axis
    u = 2.0 * math.pi * np.arange(n_major) / n_major
    v = 2.0 * math.pi * np.arange(n_minor) / n_minor
    ring = (np.cos(u)[:, None] * e1 + np.sin(u)[:, None] * e2)[:, None, :]
    normal = (np.cos(v)[None, :, None] * ring
              + np.sin(v)[None, :, None] * axis)             # (U, V, 3)
    pos = centre + big_r * ring + small_r * normal
    pos = np.round(pos * GRID) / GRID
    lines = ["# torus room: a generated test scene",
             f"# torus {n_major} x {n_minor} quads in an open-fronted room",
             "o room"]
    lines += [f"v {x} {y} {z}" for x, y, z in _ROOM_CORNERS]
    lines.append("o torus")
    for p in pos.reshape(-1, 3):
        lines.append("v " + " ".join(_fmt(c) for c in p))
    for i in range(n_major):
        for j in range(n_minor):
            lines.append(f"vt {i / n_major:.6f} {j / n_minor:.6f}")
    for n in normal.reshape(-1, 3):
        lines.append("vn " + " ".join(f"{c:.6f}" for c in n))
    lines.append("g room")
    lines += ["f " + " ".join(str(k) for k in q) for q in _ROOM_QUADS]
    lines += ["g torus", "s off"]
    base = len(_ROOM_CORNERS)
    for i in range(n_major):
        for j in range(n_minor):
            # (u, v) -> (u+1, v) -> (u+1, v+1) -> (u, v+1): counter-clockwise
            # about the outward normal (d/du x d/dv points outwards)
            i1, j1 = (i + 1) % n_major, (j + 1) % n_minor
            quad = [a * n_minor + b for a, b in ((i, j), (i1, j), (i1, j1),
                                                 (i, j1))]
            if i % 2:
                lines.append("f " + " ".join(
                    f"{base + k + 1}/{k + 1}/{k + 1}" for k in quad))
            else:
                lines.append("f " + " ".join(str(base + k + 1) for k in quad))
    return "\n".join(lines) + "\n"


def torus_room(path, n_major: int = BUNNY_SIZE[0],
               n_minor: int = BUNNY_SIZE[1]) -> ScenePreset:
    """Write the scene's OBJ to ``path`` and return a preset that loads it
    (an absolute path, so no models directory is involved)."""
    path = Path(path).resolve()
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(_torus_room_obj(n_major, n_minor))
    return ScenePreset(name=f"torus_room_{n_major}x{n_minor}", obj=str(path),
                       camera_position=CAMERA, material_rules=MATERIALS,
                       light_specs=(LIGHT,), light_power=LIGHT_POWER)
