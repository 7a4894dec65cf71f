"""Window statistics: every answer of the window counts, none is dropped
or averaged in chunks first."""

from __future__ import annotations

def percentile(values, q: float) -> float:
    """The q-th percentile (0 < q < 100) of ``values`` by linear
    interpolation between order statistics (``statistics.quantiles``'
    inclusive method, as numpy's default)."""
    vals = sorted(values)
    if not vals:
        raise ValueError("no values")
    if len(vals) == 1:
        return float(vals[0])
    pos = (len(vals) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(vals) - 1)
    return float(vals[lo] + (vals[hi] - vals[lo]) * (pos - lo))


def rate(count: float, window_s: float) -> float:
    """Work per second over the whole window."""
    if window_s <= 0:
        raise ValueError("empty window")
    return count / window_s
