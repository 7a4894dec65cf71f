"""The 95th percentile, over every frame of the window, of host
milliseconds from the frame's call to the end of its synchronisation."""

from benchmark import readers, stats


def read(run):
    if readers.loop(run) != "progressive":
        return None
    return 1e3 * stats.percentile(run.answer_s, 95)
