"""Share of kernel B2's cycles waiting at its iterations' two grid
barriers (their own cost and the wait for the slowest block's step), from
its in-kernel phase clock over the frames of the traced window, in the
blocks that apply (``profiling.b2_shares``), in percent."""

from benchmark import recorded


def read(run):
    return recorded.b2_pct(run, "wait1", "wait2")
