"""Host milliseconds of a rebuild_bin_cdf call, mean over the traced
window."""

from benchmark import readers


def read(run):
    return readers.span_mean_ms(run, "rebuild_bin_cdf")
