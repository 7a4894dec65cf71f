"""Host waits for the card a learning job, counted by the program at each
site (``sync.<site>``: the table's check, the up vector's copy, ...) over
the jobs of the traced window."""

from benchmark import readers, recorded


def read(run):
    rec = recorded.recorder(run)
    if rec is None or readers.loop(run) != "learning_jobs":
        return None
    return sum(rec.syncs.values()) / run.traced_answers
