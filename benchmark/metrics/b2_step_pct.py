"""Share of kernel B2's cycles in its iterations' step (the slots' bounce
and TD scatter, and the live list's compaction), from its in-kernel phase
clock over the frames of the traced window, in the blocks that apply
(``profiling.b2_shares``), in percent."""

from benchmark import recorded


def read(run):
    return recorded.b2_pct(run, "step")
