"""Camera paths completed a second: pixels x spp of every frame finished in
the window, over the window's seconds (paths, not segments: a change that
lengthens paths reads as no gain)."""

from benchmark import readers, stats


def read(run):
    if readers.loop(run) != "progressive":
        return None
    return stats.rate(run.answers * run.paths_per_answer, run.window_s)
