"""Device kernels launched a wavefront iteration in the fine-map SARSA
loop: the kernels of the traced window (copies and sets left out) over
the program's count of iterations with a live slot.  None for a program
without the counter."""

from benchmark import recorded
from benchmark.tracing import DEVICE_CATS


def read(run):
    rec = recorded.recorder(run)
    if rec is None or "sarsa" not in run.extra:
        return None
    iters = getattr(rec, "tally_values", lambda: {})().get(
        "sarsa_wavefront.iterations")
    if not iters:
        return None
    kernels = sum(k["count"] for name, k in
                  run.trace_summary["kernels"].items()
                  if name not in DEVICE_CATS)
    return kernels / iters
