"""What the program recorded inside itself during the traced window, for
the metric readers: the spans, host waits and kernel B2's phase clock of
``rlrpt_tpu_torch.utils.profiling.RECORDER``, which records only while a
profiler runs (here: the traced window alone).  A program without the
recorder, or a run that recorded nothing, gives every reader None."""

from __future__ import annotations


def recorder(run):
    """The program's recorder if it recorded in ``run``'s traced window."""
    if run.trace_summary is None or not run.traced_answers:
        return None
    try:
        from rlrpt_tpu_torch.utils import profiling
    except ImportError:
        return None
    rec = getattr(profiling, "RECORDER", None)
    if rec is None or not getattr(rec, "calls", None):
        return None
    return rec


def phase_ms(run, launcher: str, phases, self_time: bool = False):
    """Mean host milliseconds a call of ``launcher`` spent in its spans
    ``<launcher>.<phase>`` (with ``self_time``, less the spans recorded
    inside them: its host waits); the calls are counted by its ``pack``
    span, one a call."""
    rec = recorder(run)
    if rec is None:
        return None
    calls = rec.calls.get(f"{launcher}.pack", 0)
    if not calls:
        return None
    ns = rec.self_ns if self_time else rec.ns
    return 1e-6 * sum(ns.get(f"{launcher}.{p}", 0) for p in phases) / calls


def b2_pct(run, *columns):
    """The named columns' share of B2's phase clock, in percent, over the
    blocks that apply (``profiling.b2_shares``), summed over the frames."""
    rec = recorder(run)
    if rec is None:
        return None
    from rlrpt_tpu_torch.utils import profiling
    shares = profiling.b2_shares(rec.b2_clock)
    return None if shares is None else sum(shares[c] for c in columns)
