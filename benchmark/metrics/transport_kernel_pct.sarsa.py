"""Share of the fine-map SARSA loop's steps whose sector draw and transport
ran as the one CUDA kernel over the traced window, in percent: the
program's counts ``sarsa_wavefront.transport_launches`` over
``sarsa_wavefront.steps``.  None for a program without the launch
counter."""

from benchmark import recorded


def read(run):
    rec = recorded.recorder(run)
    if rec is None or "sarsa" not in run.extra:
        return None
    launches = rec.counts.get("sarsa_wavefront.transport_launches")
    steps = rec.counts.get("sarsa_wavefront.steps")
    if launches is None or not steps:
        return None
    return 100.0 * launches / steps
