"""Host waits for the card a frame of the fine-map SARSA loop, counted by
the program at each site (``sync.<site>``: the live count, the flushes,
the camera's copy, the class ids' check, the tree's size) over the frames
of the traced window."""

from benchmark import recorded


def read(run):
    rec = recorded.recorder(run)
    if rec is None or "sarsa" not in run.extra:
        return None
    if not rec.calls.get("trace_frame_sarsa_wavefront.pack"):
        return None
    return sum(rec.syncs.values()) / run.traced_answers
