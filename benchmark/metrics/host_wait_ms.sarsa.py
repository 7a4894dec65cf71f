"""Host milliseconds a frame of the fine-map SARSA loop waits for the card:
the program's spans ``sync.<site>`` of every site where it counted a wait
(``host_syncs.sarsa`` counts the waits), summed over the traced window,
over its frames (``sarsa_wavefront.frames``).  The host's clock alone: a
short wait means the host sets the pace, a long one that the card lags.
None for a program that counted no frame or no wait."""

from benchmark import recorded


def read(run):
    rec = recorded.recorder(run)
    if rec is None or "sarsa" not in run.extra:
        return None
    frames = getattr(rec, "counts", {}).get("sarsa_wavefront.frames")
    names = [f"sync.{site}" for site in rec.syncs]
    if not frames or not names:
        return None
    return 1e-6 * sum(rec.ns.get(n, 0) for n in names) / frames
