"""Share of the fine-map SARSA loop's steps that CUDA graph replays ran
over the traced window, in percent: the program's counts
``sarsa_wavefront.graph_steps`` over ``sarsa_wavefront.steps``.  None for a
program without the replay count."""

from benchmark import recorded


def read(run):
    rec = recorded.recorder(run)
    if rec is None or "sarsa" not in run.extra:
        return None
    graph_steps = rec.counts.get("sarsa_wavefront.graph_steps")
    steps = rec.counts.get("sarsa_wavefront.steps")
    if graph_steps is None or not steps:
        return None
    return 100.0 * graph_steps / steps
