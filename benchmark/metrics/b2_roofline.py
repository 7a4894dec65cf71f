"""Kernel B2 (train_kernel, the learning frame): the frames' counted bound
(the sweep, the TD target, the tables; the apply of Q left out) over its
device time, in percent (benchmark/roofline.py)."""

from benchmark import readers
from benchmark.roofline import binned_table_bytes, sweep_bound_s


def read(run):
    x = run.extra
    if "n_cols" not in x:
        return None
    table = binned_table_bytes(x["n_sectors_pad"], x["n_cols"], True)
    bounds = [sweep_bound_s("B2", s, x["n_tris"], x["n_slots"], table)
              for s in readers.traced_segments(
                  run, "B2", run.traffic["frames"])]
    return readers.roofline_pct(run, "train_kernel", bounds)
