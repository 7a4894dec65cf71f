"""The CPU engine's second built-in room (18 triangles: 16 surfaces and a
two-triangle polygon light)."""

from __future__ import annotations

from benchmark.reference import test_room as ref_test_room


def program_scene(config: dict, device):
    from rlrpt_tpu_torch.scene.cornell import monte_carlo_test_scene
    return monte_carlo_test_scene(device=device)


def reference_tables(config: dict):
    return ref_test_room.tables()
