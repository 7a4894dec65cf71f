"""Profiling and tracing hooks (counterpart of
``rlrpt_tpu/utils/profiling.py``).

The reference times phases with std::chrono behind a compile-time TIMING
flag (deep_learning_settings.h:20, neural_q_pathtracer.cu:281-284) and
frames with SDL_GetTicks (main.cu:43-49).  Here:

* ``host_fence`` waits for the card: ``torch.cuda.synchronize`` on the
  device of any CUDA tensor it is given, nothing for CPU tensors (they are
  computed when the call returns);
* ``phase_timer`` wall-clocks a named phase, fenced on what the body
  stores in ``out["value"]``;
* ``trace`` records a region with ``torch.profiler`` into a directory, as
  a Chrome trace;
* ``RaysPerSecond`` accumulates traced rays over wall time.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


def _tensors(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def host_fence(tree) -> None:
    """Wait until every tensor in ``tree`` (nested lists, tuples and dicts)
    is computed: one synchronize per CUDA device among them."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def phase_timer(name: str, verbose: bool = True) -> Iterator[dict]:
    """Times a phase; fences on ``out['value']`` if the body sets it, and
    stores the seconds in ``out['seconds']``."""
    out: dict = {}
    t0 = time.perf_counter()
    yield out
    if "value" in out:
        host_fence(out["value"])
    out["seconds"] = time.perf_counter() - t0
    if verbose:
        print(f"{name}: {out['seconds']:.3f}s")


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """A torch.profiler region (CPU, and CUDA when a card is present)
    written to ``log_dir/trace.json`` (chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class RaysPerSecond:
    """Accumulates traced-ray counts and wall time -> rays/s."""

    def __init__(self) -> None:
        self.rays = 0.0
        self.seconds = 0.0
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, rays: float) -> None:
        if self._t0 is None:
            raise RuntimeError("RaysPerSecond.stop() before start()")
        self.seconds += time.perf_counter() - self._t0
        self.rays += rays
        self._t0 = None

    @property
    def value(self) -> float:
        return self.rays / self.seconds if self.seconds else 0.0

    def per_chip(self, n_chips: int = 1) -> float:
        return self.value / max(n_chips, 1)
