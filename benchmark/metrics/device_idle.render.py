"""Share of the traced window in which no kernel, copy or set ran on the
device, in the progressive frames' loop."""

from benchmark import readers


def read(run):
    if readers.loop(run) != "progressive":
        return None
    return readers.idle_pct(run)
