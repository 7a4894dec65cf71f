"""Kernel B1's sweep (mega_default_kernel): the frames' counted bound over
its device time, in percent (benchmark/roofline.py)."""

from benchmark import readers
from benchmark.roofline import sweep_bound_s


def read(run):
    x = run.extra
    bounds = [sweep_bound_s("B1", s, x["n_tris"], x["n_slots"])
              for s in readers.traced_segments(run)]
    return readers.roofline_pct(run, "mega_default_kernel", bounds)
