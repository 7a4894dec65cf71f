"""The MLP's share of the card's f32 peak in the traced window of the
deep-Q loop: its operations, counted from the program's rows forwarded
and trained at the published widths (benchmark/roofline_deep.py), over
the traced window's seconds x 67 TFLOP/s, in percent.  None for a program
without the counters."""

from benchmark import recorded
from benchmark.roofline_deep import mfu_pct


def read(run):
    rec = recorded.recorder(run)
    if rec is None or "deep" not in run.extra:
        return None
    n = getattr(rec, "tally_values", lambda: {})()
    if "deep_wavefront.rows_forwarded" not in n or "train.rows" not in n:
        return None
    return mfu_pct(n["deep_wavefront.rows_forwarded"], n["train.rows"],
                   run.trace_summary["window_s"])
