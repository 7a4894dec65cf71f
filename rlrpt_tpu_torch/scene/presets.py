"""Per-scene presets (counterpart of ``rlrpt_tpu/scene/presets.py``).

Only the hard-coded Cornell box is ported so far; the OBJ presets wait for
the OBJ importer.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from rlrpt_tpu_torch.scene.cornell import cornell_box
from rlrpt_tpu_torch.scene.scene import Scene


@dataclasses.dataclass(frozen=True)
class ScenePreset:
    name: str
    camera_position: tuple            # ref: main.cu:100-104
    factory: Callable[..., Scene]

    def load(self, device="cpu") -> Scene:
        return self.factory(device=device)


PRESETS: dict[str, ScenePreset] = {
    # Hard-coded Cornell (ref: cornell_box_scene.cu; camera main.cu:101).
    "cornell": ScenePreset(name="cornell", camera_position=(0.0, 0.0, -3.0),
                           factory=cornell_box),
}


def get(name: str) -> ScenePreset:
    return PRESETS[name]
