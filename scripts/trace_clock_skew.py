"""How far a trace's device clock lies from its host clock on one CUDA card,
over learning frames of the fine-map cell's configuration (720x720, 8 spp,
80 bounces, 24,526 radiance volumes at 12x12 sectors, the answer table,
``--pix-mux`` 4):

    python scripts/trace_clock_skew.py [--frames 3] [--out DIR]

One frame warms up; ``utils.profiling.trace`` then records ``--frames``
frames into ``DIR/trace.json`` (kept gzipped as ``trace.json.gz``).  Each
kernel is paired with the host call that launched it by the trace's
correlation id.  A kernel cannot start before its launch, nor can a device
op launched before a host wait's span (``sync.*``) ends run past that end:
either, in the trace, is the profiler's conversion between the two clocks.
Prints the card's name and power limit, then one JSON row: the kernels
paired, the median and least (kernel start - launch start) in
microseconds, the share of kernels that start before their launch, the
``sync.*`` spans, how many of them a device op launched before their end
outlasts, and by how much at most.  A second row gives the tracing's own
host cost: microseconds a call of a small op (a reduction over 129,600
lanes, the loop's widest phase) and of an empty ``profiling.span``, with
no profiler and under one.
"""

import argparse
import bisect
import gzip
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from rlrpt_tpu_torch.camera import Camera  # noqa: E402
from rlrpt_tpu_torch.config import (RadianceVolumeConfig,  # noqa: E402
                                    RenderConfig)
from rlrpt_tpu_torch.integrators import sarsa_wavefront as sw  # noqa: E402
from rlrpt_tpu_torch.radiance.grid_bucket import \
    build_volume_class_table  # noqa: E402
from rlrpt_tpu_torch.radiance.volumes import \
    build_radiance_volumes  # noqa: E402
from rlrpt_tpu_torch.scene import cornell_box  # noqa: E402
from rlrpt_tpu_torch.utils import profiling  # noqa: E402

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def skew(events: list) -> dict:
    """The clock readings of a Chrome trace's events (microseconds)."""
    device, launch, syncs = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat"), e.get("args") or {}
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append((cat, args.get("correlation"), ts, ts + dur))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launch.setdefault(args["correlation"], ts)
        elif cat == "user_annotation" and e["name"].startswith("sync."):
            syncs.append(ts + dur)
    lat = [s - launch[c] for cat, c, s, _ in device
           if cat == "kernel" and c in launch]
    # device ops by launch time, with the latest end among those launched
    # so far: a wait's span must outlast every op launched before its end
    ops = sorted((launch[c], end) for _, c, _, end in device if c in launch)
    starts = [t for t, _ in ops]
    latest, m = [], float("-inf")
    for _, end in ops:
        m = max(m, end)
        latest.append(m)
    over = []
    for end in syncs:
        i = bisect.bisect_left(starts, end)
        if i and latest[i - 1] > end:
            over.append(latest[i - 1] - end)
    return {"kernels_paired": len(lat),
            "device_ops": len(device),
            "launch_to_start_us_median": statistics.median(lat) if lat
            else None,
            "launch_to_start_us_min": min(lat) if lat else None,
            "start_before_launch_share": (sum(x < 0 for x in lat) / len(lat)
                                          if lat else None),
            "sync_spans": len(syncs),
            "sync_spans_outlasted": len(over),
            "outlast_us_max": max(over) if over else 0.0}


def costs(n: int = 500) -> dict:
    """Host microseconds a call of a small op and of an empty span, with
    no profiler and under one (the card left to drain between the two; n
    below the launch queue's depth, so the host never waits on it)."""
    lanes = torch.rand(129600, device="cuda") < 0.5

    def op():
        lanes.sum()

    def empty_span():
        with profiling.span("clock_skew.empty"):
            pass

    def per_call(fn):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return 1e6 * dt / n
    out = {"op_us": per_call(op), "span_us": per_call(empty_span)}
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        out.update(op_us_traced=per_call(op),
                   span_us_traced=per_call(empty_span))
    profiling.RECORDER.reset()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--out", default="build/clock_skew")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    cfg = RenderConfig(width=720, height=720, samples_per_pixel=8,
                       max_ray_bounces=80, environment_light=0.0, eps=1e-5,
                       russian_roulette=False)
    rl = RadianceVolumeConfig(grid_resolution=12, area_per_sample=0.001,
                              distribution_threshold=0.0, defensive_mix=0.0)
    scene = cornell_box(device=dev)
    vols = build_radiance_volumes(scene, rl, seed=1984)
    table = build_volume_class_table(vols, scene)
    cam = Camera.create([0.0, 0.0, -3.0])

    def frame(seed, vols):
        _, vols, _ = sw.render_frame_sarsa_wavefront(seed, scene, cam, vols,
                                                     table, cfg, rl,
                                                     pix_mux=4)
        torch.cuda.synchronize()
        return vols
    vols = frame(1, vols)                     # every first call
    out = Path(args.out)
    t0 = time.perf_counter()
    with profiling.trace(str(out)):
        for f in range(args.frames):
            vols = frame(2 + f, vols)
    traced_s = time.perf_counter() - t0
    path = out / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    row = {"frames": args.frames, "traced_s": traced_s, **skew(events)}
    with open(path, "rb") as src, gzip.open(str(path) + ".gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    path.unlink()
    print(json.dumps(row), flush=True)
    print(json.dumps(costs()), flush=True)


if __name__ == "__main__":
    main()
