"""Share of the fine-map SARSA loop's steps whose nearest-volume lookup and
TD update ran as the CUDA kernels of ``ops/sarsa_td.py`` over the traced
window, in percent: the program's counts ``sarsa_wavefront.td_kernel_steps``
over ``sarsa_wavefront.steps``.  None for a program without the count."""

from benchmark import recorded


def read(run):
    rec = recorded.recorder(run)
    if rec is None or "sarsa" not in run.extra:
        return None
    kernel_steps = rec.counts.get("sarsa_wavefront.td_kernel_steps")
    steps = rec.counts.get("sarsa_wavefront.steps")
    if kernel_steps is None or not steps:
        return None
    return 100.0 * kernel_steps / steps
