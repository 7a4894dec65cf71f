"""Per-scene presets: model path, material tables, lights, default camera
(counterpart of ``rlrpt_tpu/scene/presets.py``, with the same names and
values).

The reference hard-codes these in C++ (camera positions: main.cu:100-104;
material rules: object_importer.cu:150-163 and :375-399; light quads:
object_importer.cu:210-314).  Light quads are given in the reference's
pre-normalisation l=2 coordinates: world = (1-x, 1-y, z-1).

OBJ models are read from ``MODELS_DIR``: the environment variable
``RLRPT_MODELS_DIR`` at import, else ``models/`` at the repository root.
The repository ships no model; point the variable at the reference's
``Models`` directory.  An absolute ``obj`` path is read as it is.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Callable, Optional, Sequence

from rlrpt_tpu_torch.scene.cornell import cornell_box, monte_carlo_test_scene
from rlrpt_tpu_torch.scene.obj_importer import (LightRange, LightSpec,
                                                MaterialRule, load_obj_scene)
from rlrpt_tpu_torch.scene.scene import Scene

MODELS_DIR = os.environ.get(
    "RLRPT_MODELS_DIR", str(Path(__file__).resolve().parents[2] / "models"))

_L = 2.0
_RED = (0.75, 0.15, 0.15)
_BLUE = (0.15, 0.15, 0.75)

# Archway light quads (ref: object_importer.cu:240-271, the active config);
# the reference names the 2nd and 3rd quads' corners (O,M,N,P) and
# (S,Q,R,T), the same K-I-J / K-J-L pattern.
_ARCHWAY_LIGHTS = (
    LightSpec(I=(_L + 1.99, _L, 2.5 * _L), J=(_L + 1.99, _L * 4 / 8, 2.5 * _L),
              K=(_L + 1.99, _L, 2.0 * _L), L=(_L + 1.99, _L * 4 / 8, 2.0 * _L)),
    LightSpec(I=(_L - 1.99, _L, 2.5 * _L), J=(_L - 1.99, _L * 4 / 8, 2.5 * _L),
              K=(_L - 1.99, _L, 2.0 * _L), L=(_L - 1.99, _L * 4 / 8, 2.0 * _L)),
    LightSpec(I=(_L - 0.5, _L, 2.99 * _L), J=(_L - 0.5, _L * 0.5, 2.99 * _L),
              K=(_L + 0.5, _L, 2.99 * _L), L=(_L + 0.5, _L * 0.5, 2.99 * _L)),
)
# Door-room light quad (ref: object_importer.cu:216-219, commented config).
_DOOR_LIGHTS = (
    LightSpec(I=(6.3 * _L / 8, _L * 6 / 8, 1.499 * _L),
              J=(6.3 * _L / 8, 0, 1.499 * _L),
              K=(2.58 * _L / 8, _L * 6 / 8, 1.499 * _L),
              L=(2.58 * _L / 8, 0, 1.499 * _L)),
)
# Simple-room light quad (ref: object_importer.cu:228-231, commented config).
_SIMPLE_ROOM_LIGHTS = (
    LightSpec(I=(_L - 0.001, _L * 6 / 8, 0.5 * _L),
              J=(_L - 0.001, _L * 3 / 8, 0.5 * _L),
              K=(_L - 0.001, _L * 6 / 8, 0.25 * _L),
              L=(_L - 0.001, _L * 3 / 8, 0.25 * _L)),
)
# Simple-closed-room light quad (ref: object_importer.cu:222-225).
_SIMPLE_CLOSED_LIGHTS = (
    LightSpec(I=(_L - 0.001, _L * 4 / 8, 1.0 * _L),
              J=(_L - 0.001, _L * 1 / 8, 1.0 * _L),
              K=(_L - 0.001, _L * 4 / 8, 0.5 * _L),
              L=(_L - 0.001, _L * 1 / 8, 0.5 * _L)),
)
# The ceiling quad of the generic OBJ presets (medieval_house, bunny, cube).
_CEILING_LIGHTS = (
    LightSpec(I=(_L / 3, 0.001, 2 * _L / 3), J=(2 * _L / 3, 0.001, 2 * _L / 3),
              K=(_L / 3, 0.001, _L / 3), L=(2 * _L / 3, 0.001, _L / 3)),
)


@dataclasses.dataclass(frozen=True)
class ScenePreset:
    name: str
    camera_position: tuple            # ref: main.cu:100-104
    obj: Optional[str] = None         # None -> the built-in ``builder``
    builder: Optional[Callable[..., Scene]] = None
    default_rgb: tuple = (0.75, 0.75, 0.75)
    material_rules: Sequence[MaterialRule] = ()
    light_specs: Sequence[LightSpec] = ()
    light_power: float = 8.0
    light_ranges: Sequence[LightRange] = ()
    light_range_power: float = 12.0
    flip_winding: bool = False

    def load(self, device="cuda") -> Scene:
        if self.builder is not None:
            return self.builder(device=device)
        path = (self.obj if os.path.isabs(self.obj)
                else os.path.join(MODELS_DIR, self.obj))
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"scene {self.name!r}: no OBJ model at {path}; set "
                f"RLRPT_MODELS_DIR to the directory that holds "
                f"{os.path.basename(path)} (now {MODELS_DIR})")
        return load_obj_scene(
            path, default_rgb=self.default_rgb,
            material_rules=self.material_rules,
            light_specs=self.light_specs, light_power=self.light_power,
            light_ranges=self.light_ranges,
            light_range_power=self.light_range_power,
            flip_winding=self.flip_winding, device=device)


PRESETS: dict[str, ScenePreset] = {}


def _register(p: ScenePreset) -> ScenePreset:
    PRESETS[p.name] = p
    return p


# Hard-coded Cornell (ref: cornell_box_scene.cu; camera main.cu:101).
_register(ScenePreset(name="cornell", builder=cornell_box,
                      camera_position=(0.0, 0.0, -3.0)))

# The CPU engine's extra hard-coded test room
# (ref: Old_CPU_Rendering_Engine/Source/scenes/monte_carlo_test_scene.cpp;
# camera Old_CPU_Rendering_Engine/Source/main.cpp).
_register(ScenePreset(name="test_room", builder=monte_carlo_test_scene,
                      camera_position=(0.0, 0.0, -3.0)))

# box.obj, the Cornell-like OBJ scene.  The reference has no config for it:
# a ceiling light quad in the spirit of the Cornell light hole.  Under the
# literal scale 2 the interior spans x in [-5.6, 1], y in [-6.1, 1] (the
# ceiling at y = -6.1 after the flip), z in [-1, 8.9].  Its winding gives
# outward normals under the reference's v2/v3 swap, so it is flipped.
_register(ScenePreset(
    name="box", obj="box.obj", camera_position=(-2.3, -2.5, -0.2),
    light_specs=(LightSpec(I=(1.8, 7.0, 6.5), J=(4.8, 7.0, 6.5),
                           K=(1.8, 7.0, 3.5), L=(4.8, 7.0, 3.5)),),
    light_power=11.0, flip_winding=True,
))

# Archway (the reference's active config: main.cu:104,111; importer rules
# object_importer.cu:157-163).
_register(ScenePreset(
    name="archway", obj="archway.obj", camera_position=(-1.0, 0.2, -0.99),
    material_rules=(MaterialRule(12, 23, _BLUE),
                    MaterialRule(81, 10 ** 9, _RED)),
    light_specs=_ARCHWAY_LIGHTS, light_power=8.0,
))

# Door room (commented config: main.cu:100; object_importer.cu:153-155,
# 216-219).
_register(ScenePreset(
    name="door_room", obj="door_room.obj", camera_position=(0.0, 0.5, -0.9),
    material_rules=(MaterialRule(24, 35, _RED),),
    light_specs=_DOOR_LIGHTS, light_power=8.0,
))

_register(ScenePreset(
    name="simple_room", obj="simple_room.obj",
    camera_position=(0.0, 0.0, -0.9),
    light_specs=_SIMPLE_ROOM_LIGHTS, light_power=8.0,
))

_register(ScenePreset(
    name="simple_room_closed", obj="simple_room_closed.obj",
    camera_position=(0.0, 0.0, -0.9),
    light_specs=_SIMPLE_CLOSED_LIGHTS, light_power=8.0,
))

# Complex light room (lights inside the OBJ; ref: object_importer.cu:
# 375-399: light triangle ranges 24-35 and 51-62 at power 12, dark
# surfaces 0-7, red 134-141; camera main.cu:102).
_register(ScenePreset(
    name="complex_light_room", obj="complex_light_room.obj",
    camera_position=(-1.0, -1.0, -0.4),
    default_rgb=(0.9, 0.9, 0.9),
    material_rules=(MaterialRule(0, 7, (0.1, 0.1, 0.1)),
                    MaterialRule(134, 141, _RED)),
    light_ranges=(LightRange(24, 35), LightRange(51, 62)),
    light_range_power=12.0,
))

# Further bundled models, white with a ceiling light (the JAX package's
# multi-scene configuration).
_register(ScenePreset(
    name="medieval_house", obj="Medieval_House.obj",
    camera_position=(0.0, 0.0, -2.5),
    light_specs=_CEILING_LIGHTS, light_power=11.0,
))

_register(ScenePreset(
    name="bunny", obj="bunny.obj", camera_position=(0.0, 0.0, -2.5),
    light_specs=_CEILING_LIGHTS, light_power=11.0,
))

_register(ScenePreset(
    name="cube", obj="cube.obj", camera_position=(0.0, 0.0, -2.5),
    light_specs=_CEILING_LIGHTS, light_power=11.0,
))


def get(name: str) -> ScenePreset:
    return PRESETS[name]


def load_scene(name: str, device="cuda") -> Scene:
    return PRESETS[name].load(device=device)
