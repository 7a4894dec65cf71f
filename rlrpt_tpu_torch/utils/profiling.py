"""Profiling and tracing hooks (counterpart of
``rlrpt_tpu/utils/profiling.py``).

The reference times phases with std::chrono behind a compile-time TIMING
flag (deep_learning_settings.h:20, neural_q_pathtracer.cu:281-284) and
frames with SDL_GetTicks (main.cu:43-49).  Here:

* ``host_fence`` waits for the card: ``torch.cuda.synchronize`` on the
  device of any CUDA tensor it is given, nothing for CPU tensors (they are
  computed when the call returns);
* ``trace`` records a region with ``torch.profiler`` into a directory, as
  a Chrome trace, with the program's spans in it;
* ``span`` marks a phase of the program, ``host_sync`` a place where the
  host waits for the card; both record only while a ``torch.profiler``
  records, into ``RECORDER`` and, as ``user_annotation`` events on the
  profiler's clock, into its trace.  Off, a span costs one check of the
  profiler's flag and an empty ``with``.  Spans are named
  ``<launcher>.<phase>`` after the public launcher whose phase they time
  (``render_default_mega.pack``), host waits ``sync.<site>``.  A trace
  labels a device gap by the latest-starting span that holds its start,
  looking back over a bounded number of spans (``benchmark/tracing.py``:
  64), so no span holds more than ~50 spans directly: a frame loop puts
  each step under a ``<loop>.step`` span (5-7 stage spans), and a deep
  step's ``.train`` holds one ``train_on_batches.replay`` a minibatch (32
  at the published 4096-row minibatches of 129,600 lanes);
* ``RECORDER`` also counts the lookups and hits of the host helpers'
  table cache (``utils.prep_cache``) by table, and owns the buffer of
  kernel B2's phase clock, which
  ``ops.guided_mega_train.render_sarsa_mega_train`` fills while a
  profiler records (csrc/mega_train.cu, the timed build); ``b2_shares``
  reads its phase shares over the blocks that apply;
* ``RECORDER`` counts the deep-Q paths' work while a profiler records:
  host numbers in ``counts`` (frames, steps, minibatches); ``tally`` adds
  a device one (live iterations, rays, rows forwarded and trained, Adam
  steps taken) without a wait, and ``tally_values`` reads them once.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Iterator

import torch
from torch._C._autograd import _profiler_enabled as recording

# Columns of a row of B2's phase clock (csrc/mega_train.cu ClockCol): a
# block's cycles at the start (slot starts, the first apply, the first
# grid barrier), in the iterations' step (and compaction), first grid
# barrier, apply and second grid barrier, its total, and its iterations.
CLOCK_COLS = ("start", "step", "wait1", "apply", "wait2", "total",
              "iterations")


class Recorder:
    """What the spans, the host waits and B2's phase clock recorded while
    a profiler ran, summed since the last ``reset``: per span name its
    host nanoseconds (``ns``), the same less the spans recorded inside it
    (``self_ns``) and its calls; per site the host waits (``syncs``);
    per table of ``utils.prep_cache`` its lookups and hits; per counter
    name its host sum (``counts``) or its device sum (``tallies``, an int64
    tensor each, read by ``tally_values``); ``b2_clock``,
    a (blocks, len(CLOCK_COLS)) int64 tensor on the card that the timed
    B2 adds its blocks' rows into (None until one ran)."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.ns: dict[str, int] = defaultdict(int)
        self.self_ns: dict[str, int] = defaultdict(int)
        self.calls: dict[str, int] = defaultdict(int)
        self.syncs: dict[str, int] = defaultdict(int)
        self.lookups: dict[str, int] = defaultdict(int)
        self.hits: dict[str, int] = defaultdict(int)
        self.counts: dict[str, int] = defaultdict(int)
        self.tallies: dict[str, torch.Tensor] = {}
        self.b2_clock: torch.Tensor | None = None
        self._open: list[int] = []   # ns of recorded children, per open span

    def clock(self, rows: int, device) -> torch.Tensor:
        """B2's clock buffer of ``rows`` rows on ``device``, allocated at
        its first call and kept across calls; raises ValueError for a grid
        of other rows or another device (``reset`` first)."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if self.b2_clock is None:
            self.b2_clock = torch.zeros((rows, len(CLOCK_COLS)),
                                        dtype=torch.int64, device=device)
        elif (self.b2_clock.shape[0], self.b2_clock.device) != (rows, device):
            raise ValueError(
                f"B2's clock holds {self.b2_clock.shape[0]} rows on "
                f"{self.b2_clock.device}, not {rows} on {device}: reset the "
                "recorder before timing another grid")
        return self.b2_clock

    def tally(self, name: str, value: torch.Tensor) -> None:
        """Add ``value`` (an integer or bool tensor) to the counter
        ``name`` on its device, with no wait for the card."""
        acc = self.tallies.get(name)
        if acc is None:
            self.tallies[name] = value.detach().to(torch.int64,
                                                    copy=True).reshape(())
        else:
            acc.add_(value.detach().reshape(()))

    def tally_values(self) -> dict[str, int]:
        """The device counters read on the host: one wait."""
        if not self.tallies:
            return {}
        names = sorted(self.tallies)
        vals = torch.stack([self.tallies[n] for n in names]).tolist()
        return dict(zip(names, vals))


RECORDER = Recorder()


def b2_shares(clock: torch.Tensor | None) -> dict | None:
    """B2's phases (start, step, wait1, apply, wait2) in percent of the
    cycles of a clock's blocks that apply: those whose apply cycles reach
    half the largest block's.  apply() deals its items to the grid's warps
    in order, so where they are fewer than the warps only the first blocks
    apply and the others wait for them at the second grid barrier: the
    frame's length follows the blocks that apply.  One read from the card;
    None for no clock or no cycles."""
    if clock is None:
        return None
    c = clock.cpu()
    apply = c[:, CLOCK_COLS.index("apply")]
    sums = c[2 * apply >= apply.max()].sum(dim=0).tolist()
    total = sums[CLOCK_COLS.index("total")]
    if total <= 0:
        return None
    return {n: 100.0 * sums[i] / total
            for i, n in enumerate(CLOCK_COLS[:5])}


class _Span:
    __slots__ = ("name", "mark", "t0")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> None:
        self.mark = torch.profiler.record_function(self.name)
        self.mark.__enter__()
        RECORDER._open.append(0)
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc) -> bool:
        dt = time.perf_counter_ns() - self.t0
        rec = RECORDER
        children = rec._open.pop()
        if rec._open:
            rec._open[-1] += dt
        rec.ns[self.name] += dt
        rec.self_ns[self.name] += dt - children
        rec.calls[self.name] += 1
        self.mark.__exit__(*exc)   # the bookkeeping inside the annotation
        return False


_OFF = contextlib.nullcontext()


def span(name: str):
    """A phase of the program: records only while a profiler records."""
    if not recording():
        return _OFF
    return _Span(name)


def host_sync(site: str, tensor: torch.Tensor, waits: int = 1):
    """Wraps a place where the host waits for the card on ``tensor``: while
    a profiler records, a span ``sync.<site>`` that counts ``waits`` waits
    at ``site`` for a CUDA tensor (a CPU tensor is computed already: the
    span, no wait), so a CPU trace has the card's spans."""
    if not recording():
        return _OFF
    if tensor.is_cuda:
        RECORDER.syncs[site] += waits
    return _Span("sync." + site)


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
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """A torch.profiler region (CPU, and CUDA when a card is present)
    written to ``log_dir/trace.json`` (chrome://tracing, Perfetto); the
    program's spans and host waits are in it, and in ``RECORDER``."""
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
