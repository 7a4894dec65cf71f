"""Triangle geometry helpers (host-side numpy; scenes are built eagerly).

Counterpart of ``rlrpt_tpu/scene/geometry.py`` with the same float32
arithmetic, so scene arrays come out bit-identical.
"""

from __future__ import annotations

import numpy as np


def triangle_normals(v0: np.ndarray, v1: np.ndarray,
                     v2: np.ndarray) -> np.ndarray:
    """Face normals normalize(cross(e2, e1)) (ref: triangle.cu:67-76)."""
    e1 = v1 - v0
    e2 = v2 - v0
    n = np.cross(e2, e1)
    return n / np.linalg.norm(n, axis=-1, keepdims=True)


def luminance(rgb: np.ndarray) -> np.ndarray:
    """Scalar luminance = 0.5*(max+min channel) (ref: material.cu:4-14)."""
    return 0.5 * (rgb.max(axis=-1) + rgb.min(axis=-1))
