"""Spans recorded from the benchmark's own files, and the reading of the
device trace of a traced run.

``Spans`` times each call into a layer of the program with the host clock
(always: two clock reads a call); while a profiler runs it also marks the
call with ``torch.profiler.record_function``, so the trace can say what the
host was doing in each idle gap of the device.  ``read_trace`` reduces a
Chrome trace that ``torch.profiler`` exported to: device time by kernel
name, the device's busy seconds (the union of every kernel, copy and set
interval) inside the traced window, and the idle gaps labelled by the
innermost benchmark span the host was in when each began.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import time
from collections import defaultdict

WINDOW = "window"                 # the span around the traced window
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SCAN = 64    # spans looked back over for the one that holds a gap's start


class Spans:
    def __init__(self):
        self.seconds: dict[str, list] = defaultdict(list)
        self.active = False   # inside the traced window: kept and marked

    @contextlib.contextmanager
    def span(self, name: str):
        mark = contextlib.nullcontext()
        active = self.active
        if active:
            import torch
            mark = torch.profiler.record_function(name)
        with mark:
            t0 = time.perf_counter()
            yield
            dt = time.perf_counter() - t0
        if active:
            self.seconds[name].append(dt)


def kernel_name(name: str) -> str:
    """A device event's name without its return type, anonymous namespace
    and argument list (the last parenthesised group; template arguments
    are kept)."""
    name = name.replace("(anonymous namespace)::", "").strip()
    if name.startswith("void "):
        name = name[5:]
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                return name[:i].strip()
    return name


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def read_trace(path: str, top: int = 10) -> dict:
    """Summary of a Chrome trace (timestamps in microseconds)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    window = [e for e in events if e.get("ph") == "X"
              and e.get("cat") == "user_annotation" and e["name"] == WINDOW]
    if not window:
        raise ValueError(f"{path}: no '{WINDOW}' span")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    device, spans = [], []
    by_name: dict[str, list] = defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        s, d = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            s, t = max(s, w0), min(s + d, w1)
            if t <= s:
                continue
            device.append((s, t))
            row = by_name[kernel_name(e["name"]) if cat == "kernel"
                          else cat]
            row[0] += (t - s) * 1e-6
            row[1] += 1
        elif cat == "user_annotation" and e["name"] != WINDOW:
            spans.append((s, s + d, e["name"]))
    busy = _union(device)
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    spans.sort(key=lambda sp: (sp[0], -sp[1]))   # outer before inner
    starts = [s for s, _, _ in spans]
    idle: dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        label = "outside any span"
        i = bisect.bisect_right(starts, g0) - 1
        for i in range(i, max(i - SCAN, -1), -1):
            s, e, name = spans[i]
            if e >= g0:   # the latest-starting span that holds g0
                label = name
                break
        idle[label] += (g1 - g0) * 1e-6
    ops = sorted(((n, v[0]) for n, v in by_name.items()),
                 key=lambda kv: -kv[1])
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "kernels": {n: {"seconds": v[0], "count": v[1]}
                    for n, v in by_name.items()},
        "device_ops": [[n, s] for n, s in ops[:top]],
        "idle_gaps": [[n, s] for n, s in sorted(idle.items(),
                                                key=lambda kv: -kv[1])[:top]],
    }
