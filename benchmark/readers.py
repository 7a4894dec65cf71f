"""What the metric readers share: the spans and the device trace of the
traced window, and the frames' segments in it."""

from __future__ import annotations

def loop(run) -> str:
    return run.traffic["loop"]


def span_mean_ms(run, *names):
    """Mean host milliseconds of the calls named, in the traced window."""
    vals = [v for n in names for v in run.spans.seconds.get(n, [])]
    return 1e3 * sum(vals) / len(vals) if vals else None


def kernel_seconds(run, name: str):
    """Device seconds of a kernel in the traced window (None: it never ran
    or nothing was traced)."""
    if run.trace_summary is None:
        return None
    k = run.trace_summary["kernels"].get(name)
    return k["seconds"] if k and k["seconds"] > 0 else None


def idle_pct(run):
    if run.trace_summary is None or run.trace_summary["window_s"] <= 0:
        return None
    s = run.trace_summary
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def traced_segments(run, kernel: str | None = None, per_answer: int = 1):
    """Segments of each frame in the traced window: the frames' own path
    lengths summed, read back after the window."""
    seg = run.extra.get("kernel_segments")
    if seg is None:
        return []
    if kernel is not None:
        seg = seg.get(kernel, [])
    return seg[: run.traced_answers * per_answer]


def roofline_pct(run, kernel_name: str, bounds):
    """100 x (sum of the frames' bounds) / (the kernel's device seconds)."""
    t = kernel_seconds(run, kernel_name)
    if t is None or not bounds:
        return None
    return 100.0 * sum(bounds) / t

