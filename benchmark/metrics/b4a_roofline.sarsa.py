"""Kernel B4a (closest_hit_bvh_kernel) under the fine-map SARSA loop's ray
mix: the traced window's counted bound (benchmark/roofline_deep.py: the
live rays' bytes in and out, the scene's rows a launch) over its device
time, in percent.  None for a program without the counters."""

from benchmark import readers, recorded
from benchmark.roofline_deep import b4a_bound_s


def read(run):
    rec = recorded.recorder(run)
    if rec is None or "sarsa" not in run.extra:
        return None
    rays = getattr(rec, "tally_values", lambda: {})().get(
        "sarsa_wavefront.rays")
    steps = getattr(rec, "counts", {}).get("sarsa_wavefront.steps")
    if not rays or not steps:
        return None
    bound = b4a_bound_s(rays, steps, run.extra["sarsa"]["n_tris"])
    return readers.roofline_pct(run, "closest_hit_bvh_kernel", [bound])
