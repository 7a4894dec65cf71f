"""Kernel B3 (mega_guided_kernel, the guided render): the frames' counted
bound over its device time, in percent (benchmark/roofline.py)."""

from benchmark import readers
from benchmark.roofline import binned_table_bytes, sweep_bound_s


def read(run):
    x = run.extra
    if "n_cols" not in x:
        return None
    table = binned_table_bytes(x["n_sectors_pad"], x["n_cols"], False)
    bounds = [sweep_bound_s("B3", s, x["n_tris"], x["n_slots"], table)
              for s in readers.traced_segments(run, "B3")]
    return readers.roofline_pct(run, "mega_guided_kernel", bounds)
