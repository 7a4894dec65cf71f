"""Share of kernel B2's cycles in its iterations' apply of Q, from its
in-kernel phase clock over the frames of the traced window, in the blocks
that apply (``profiling.b2_shares``: the apply's items go to the first
blocks; the frame follows them), in percent."""

from benchmark import recorded


def read(run):
    return recorded.b2_pct(run, "apply")
