"""Share of the deep-Q loop's steps whose sample-and-transport ran as the
one CUDA kernel over the traced window, in percent: the program's counts
``deep_wavefront.transport_launches`` over ``deep_wavefront.steps``.  None
for a program without the launch counter."""

from benchmark import recorded


def read(run):
    rec = recorded.recorder(run)
    if rec is None or "deep" not in run.extra:
        return None
    launches = rec.counts.get("deep_wavefront.transport_launches")
    steps = rec.counts.get("deep_wavefront.steps")
    if launches is None or not steps:
        return None
    return 100.0 * launches / steps
