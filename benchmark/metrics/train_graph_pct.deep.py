"""Share of the deep-Q trainer's minibatch steps replayed as a CUDA graph
over the traced window, in percent: the program's counts
``train.graph_replays`` over ``train.minibatches``.  None for a program
without the replay counter."""

from benchmark import recorded


def read(run):
    rec = recorded.recorder(run)
    if rec is None or "deep" not in run.extra:
        return None
    replays = rec.counts.get("train.graph_replays")
    minibatches = rec.counts.get("train.minibatches")
    if replays is None or not minibatches:
        return None
    return 100.0 * replays / minibatches
