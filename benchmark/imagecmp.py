"""Image arithmetic of the benchmark: the pinned ground truth, and the gaps
by which an output differs from the reference's."""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np


def sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def load_gt(root: Path, spec: dict) -> np.ndarray:
    """The ground truth named by a configuration's ``gt`` entry, after its
    sha256 is checked against the pin."""
    path = root / spec["path"]
    got = sha256(path)
    if got != spec["sha256"]:
        raise ValueError(f"{spec['path']}: sha256 {got} is not the pinned "
                         f"{spec['sha256']}")
    with np.load(path) as z:
        return np.asarray(z["gt"], np.float32)


def rel_l1(out, ref) -> float:
    """sum |out - ref| / sum |ref|, in float64."""
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(out - ref).sum() / max(np.abs(ref).sum(), 1e-300))


def rel_gap(out: float, ref: float) -> float:
    return abs(float(out) - float(ref)) / max(abs(float(ref)), 1e-300)
