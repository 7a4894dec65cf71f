"""Host milliseconds a step of the deep-Q loop spends in its own code
around its stages: the self time of the program's span
``trace_frame_deep_wavefront.step`` (the step's iteration count and
tallies, and the entry and exit of its stage and capture spans), summed
over the traced window, over its steps (``deep_wavefront.steps``).  None
for a program without the span."""

from benchmark import recorded

SPAN = "trace_frame_deep_wavefront.step"


def read(run):
    rec = recorded.recorder(run)
    if rec is None or "deep" not in run.extra:
        return None
    steps = getattr(rec, "counts", {}).get("deep_wavefront.steps")
    if not steps or not rec.calls.get(SPAN):
        return None
    return 1e-6 * rec.self_ns[SPAN] / steps
