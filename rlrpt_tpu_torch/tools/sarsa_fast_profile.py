"""Timing and profile probe of the fine-map ``sarsa-fast`` loop on one
CUDA card.

    python -m rlrpt_tpu_torch.tools.sarsa_fast_profile [--rounds N]
        [--no-profile]

At the fine-map point (Cornell box, 720x720, 8 spp, 80-bounce cap,
area_per_sample 0.001, pix_mux 4) it builds the volume set and its
answer table once (their seconds are printed, and are in no frame's),
runs WARM learning frames of
``render_frame_sarsa_wavefront`` and then:

* profiles one learning frame with torch.profiler.  Device busy time is
  the union of the kernel, memcpy and memset intervals of its chrome
  trace (written to a temporary directory and read back); the idle share
  is measured against the median unprofiled seconds per iteration of the
  last three warm frames.  It prints the device kernels per iteration,
  the device time of the top kernels and the host ops by count;
* compares the VARIANTS below: each of --rounds rounds runs every variant
  once, in rotated order, from the same learned map and the same seed
  (a frame leaves its input map as it was), and prints each variant's
  frame seconds and their median.  Frame seconds, not seconds per
  iteration, since idle iterations after a phase drained are not counted.

The card's name, power limit, SM clock, power draw and temperature
(nvidia-smi) come first and last.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time

import torch

from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.config import RadianceVolumeConfig, RenderConfig
from rlrpt_tpu_torch.integrators import sarsa_wavefront as sw
from rlrpt_tpu_torch.radiance.grid_bucket import build_volume_class_table
from rlrpt_tpu_torch.radiance.volumes import build_radiance_volumes
from rlrpt_tpu_torch.scene import cornell_box
from rlrpt_tpu_torch.tools.mega_sweep import card_state

# (label, SYNC_EVERY or None for the module's, frame options)
VARIANTS = [("SYNC_EVERY 2", 2, {}), ("SYNC_EVERY 4", 4, {}),
            ("SYNC_EVERY 8", 8, {}), ("SYNC_EVERY 16", 16, {}),
            ("hit_mode f32", None, {"hit_mode": "f32"}),
            ("cdf_dtype bf16", None, {"cdf_dtype": "bf16"})]
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SIZE, SPP, AREA, WARM = 720, 8, 0.001, 7


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def trace_events(prof) -> list:
    """Every event of a finished profile, from its chrome trace."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def device_events(events: list) -> list:
    """The kernel, memcpy and memset events among a trace's events."""
    return [e for e in events if e.get("cat") in DEVICE_CATS]


def rotated(items: list, k: int) -> list:
    k %= len(items)
    return items[k:] + items[:k]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=5,
                        help="rounds of the variant comparison (0: none)")
    parser.add_argument("--no-profile", action="store_true",
                        help="skip the profiled frame")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sarsa_fast_profile needs a CUDA card")
    dev = torch.device("cuda")
    print(card_state(), flush=True)
    scene = cornell_box(device=dev)
    camera = Camera.create((0.0, 0.0, -3.0))
    rl = RadianceVolumeConfig(area_per_sample=AREA)
    cfg = RenderConfig(width=SIZE, height=SIZE, samples_per_pixel=SPP,
                       max_ray_bounces=80)
    t0 = time.perf_counter()
    vols = build_radiance_volumes(scene, rl)
    t1 = time.perf_counter()
    table = build_volume_class_table(vols, scene)
    print(f"V = {vols.n_volumes}, volume set {t1 - t0:.4f} s; answer table "
          f"{table.table.shape[0]} cells, {table.nbytes} bytes, "
          f"{time.perf_counter() - t1:.4f} s", flush=True)

    def frame(seed, vols, sync_every=None, **kw):
        default = sw.SYNC_EVERY
        sw.SYNC_EVERY = sync_every or default
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, out, aux = sw.render_frame_sarsa_wavefront(
                seed, scene, camera, vols, table, cfg, rl, pix_mux=4, **kw)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
        finally:
            sw.SYNC_EVERY = default
        it = int(aux["wavefront_iterations"])
        print(f"  frame seed {seed} sync_every {sync_every or default} {kw}: "
              f"{sec:.4f} s, {it} iterations, {sec / it * 1e3:.4f} ms/iter, "
              f"avg path {float(aux['avg_path_length']):.4f}, zclp "
              f"{int(aux['zero_contribution_light_paths'])}, phases "
              f"{aux['phase_iterations'].tolist()}", flush=True)
        return out, sec, it

    print(f"{WARM} warm learning frames at {SIZE}x{SIZE}, {SPP} spp, "
          f"pix_mux 4, SYNC_EVERY {sw.SYNC_EVERY}",
          flush=True)
    per_iter = []
    for i in range(WARM):
        vols, sec, it = frame(i, vols)
        per_iter.append(sec / it)

    if not args.no_profile:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, psec, pit = frame(20, vols)
        evs = device_events(trace_events(prof))
        busy = busy_us((e["ts"], e["ts"] + e["dur"]) for e in evs)
        wall_it = statistics.median(per_iter[-3:]) * 1e6
        print(f"profiled frame: {psec:.4f} s, {pit} iterations, {len(evs)} "
              f"device events ({len(evs) / pit:.1f} per iteration), device "
              f"busy {busy / 1e3:.3f} ms ({busy / pit:.2f} us per iteration) "
              f"against {wall_it:.2f} us of unprofiled wall per iteration: "
              f"idle share {1 - busy / pit / wall_it:.4f}", flush=True)
        by = {}
        for e in evs:
            c = by.setdefault(e["name"][:90], [0.0, 0])
            c[0] += e["dur"]
            c[1] += 1
        for k, (d, n) in sorted(by.items(), key=lambda x: -x[1][0])[:25]:
            print(f"  {d / 1e3:9.3f} ms  {n:6d}x  {k}")
        ops = sorted(prof.key_averages(), key=lambda e: e.count,
                     reverse=True)
        print("host ops by count: " + ", ".join(
            f"{e.key} {e.count}" for e in ops[:25]
            if e.key.startswith("aten::")), flush=True)

    if args.rounds:
        secs = {label: [] for label, _, _ in VARIANTS}
        for r in range(args.rounds):
            print(f"round {r}", flush=True)
            for label, se, kw in rotated(VARIANTS, r):
                _, sec, _ = frame(100 + r, vols, se, **kw)
                secs[label].append(sec)
        for label, s in secs.items():
            print(f"{label}: median {statistics.median(s):.4f} s per frame "
                  f"(" + ", ".join(f"{x:.4f}" for x in s) + ")")
    print(card_state(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
