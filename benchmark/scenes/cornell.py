"""The GPU engine's hard-coded Cornell box (38 triangles)."""

from __future__ import annotations

from benchmark.reference import scenes as ref_scenes


def program_scene(config: dict, device):
    from rlrpt_tpu_torch.scene.cornell import cornell_box
    return cornell_box(device=device)


def reference_tables(config: dict):
    return ref_scenes.cornell()
