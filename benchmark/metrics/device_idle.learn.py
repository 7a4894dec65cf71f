"""Share of the traced window in which no kernel, copy or set ran on the
device, in the learning jobs' loop."""

from benchmark import readers


def read(run):
    if readers.loop(run) != "learning_jobs":
        return None
    return readers.idle_pct(run)
