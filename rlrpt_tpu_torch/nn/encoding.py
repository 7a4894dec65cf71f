"""State encodings of the deep-Q tracer (counterpart of
``rlrpt_tpu/nn/encoding.py``).

The reference encodes a point as the scene's flat vertex list in a
coordinate system centred at the point (ref: nn_rendering_helpers.cu:
281-298; offline: NN_Q_Value_Trainer/Source/main.cu:25-36).  The tracers
never build it (``DQNetwork.forward_relative``); the tests do.
"""

from __future__ import annotations

import torch


def relative_vertex_encoding(scene_vertices_flat: torch.Tensor,
                             positions: torch.Tensor) -> torch.Tensor:
    """scene_vertices_flat (F,), F = 9T; positions (R, 3) -> (R, F), every
    vertex minus the position."""
    f = scene_vertices_flat.shape[0]
    rel = scene_vertices_flat.reshape(1, f // 3, 3) - positions[:, None, :]
    return rel.reshape(positions.shape[0], f)
