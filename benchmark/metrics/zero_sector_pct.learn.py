"""Share of the rebuilt bf16 CDF tables' sectors that the guided kernels
can never draw (a pdf of 0 as their sampler reads it: a probability below
the spacing of the sector's bf16 CDF entry), in percent, over every
rebuild of the traced window of the learning jobs' loop: the program's
device tallies ``rebuild_bin_cdf.zero_sectors`` over
``rebuild_bin_cdf.sectors``.  None for a program without the tallies."""

from benchmark import readers, recorded


def read(run):
    rec = recorded.recorder(run)
    if rec is None or readers.loop(run) != "learning_jobs":
        return None
    tallies = getattr(rec, "tally_values", lambda: {})()
    sectors = tallies.get("rebuild_bin_cdf.sectors")
    if not sectors:
        return None
    return 100.0 * tallies.get("rebuild_bin_cdf.zero_sectors", 0) / sectors
