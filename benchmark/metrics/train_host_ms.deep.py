"""Host milliseconds a wavefront iteration spends in its training (the
program's span ``trace_frame_deep_wavefront.train``: the minibatches'
losses, gradients and Adam steps issued), mean over the traced window."""

from benchmark import recorded


def read(run):
    rec = recorded.recorder(run)
    if rec is None or "deep" not in run.extra:
        return None
    name = "trace_frame_deep_wavefront.train"
    calls = rec.calls.get(name, 0)
    return 1e-6 * rec.ns[name] / calls if calls else None
