"""Host milliseconds a step of the fine-map SARSA loop spends issuing its
work: the program's spans ``trace_frame_sarsa_wavefront.hit``, ``.volume``,
``.td``, ``.sample`` and ``.transport`` summed over the traced window,
over its steps (``sarsa_wavefront.steps``).  None for a program without
the spans."""

from benchmark import recorded

STAGES = ("hit", "volume", "td", "sample", "transport")


def read(run):
    rec = recorded.recorder(run)
    if rec is None or "sarsa" not in run.extra:
        return None
    steps = getattr(rec, "counts", {}).get("sarsa_wavefront.steps")
    names = [f"trace_frame_sarsa_wavefront.{s}" for s in STAGES]
    if not steps or not all(rec.calls.get(n) for n in names):
        return None
    return 1e-6 * sum(rec.ns[n] for n in names) / steps
