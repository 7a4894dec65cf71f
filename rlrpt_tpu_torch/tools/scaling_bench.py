"""Scaling-efficiency bench: rays/s at 1..N ranks (counterpart of
``rlrpt_tpu/tools/scaling_bench.py``).

For each size d in ``sizes``, d spawned processes form a group
(``parallel.multihost``: NCCL on the card, one card a rank; gloo on the
CPU) and render the same frame with ``parallel.dp.render_default_dp``
(rays sharded, scene replicated, no collective until the image is
gathered); rank 0 reports

    rays/s(d), speedup(d) = rays/s(d) / rays/s(1),
    efficiency(d) = speedup(d) / d.

A size above the available devices is skipped with a ``# skipping size``
line: on the card that is every d above the CUDA device count, on the CPU
every d above the cores this process may use.  mode "strong" keeps the
total work fixed; "weak" keeps the work a rank fixed (the frame height
scales with d), so ideal scaling is a flat time and any rise is
partition, collective and launch overhead.  ``seconds`` is the best host
time of ``repeats`` frames, each fenced by a synchronize; process start,
group set-up and a warm-up frame are not in it.

Usage:  python -m rlrpt_tpu_torch.tools.scaling_bench [--sizes 1,2,4,8]
        [--width 256] [--height 256] [--spp 4] [--bounces 20]
        [--scene cornell] [--repeats 3] [--mode both] [--json PATH]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch
import torch.distributed as dist

from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.config import RenderConfig
from rlrpt_tpu_torch.utils.rng import fold_in

SEED = 1984


def _build_scene(name: str, device):
    if name == "cornell":
        from rlrpt_tpu_torch.scene import cornell_box
        return cornell_box(device=device), Camera.create([0.0, 0.0, -3.0])
    from rlrpt_tpu_torch.scene import presets
    p = presets.get(name)
    return p.load(device=device), Camera.create(p.camera_position)


def available_devices(device) -> int:
    """Ranks a size may use: CUDA cards, or the CPU cores this process may
    run on."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return len(os.sched_getaffinity(0))


def _bench_rank(rank: int, world: int, address: str, scene, camera,
                cfg: RenderConfig, repeats: int, device: str):
    """One rank of a size: the group, a warm-up frame, then the best of
    ``repeats`` frames.  Returns (seconds, avg_path_length)."""
    from rlrpt_tpu_torch.parallel import multihost
    from rlrpt_tpu_torch.parallel.dp import render_default_dp
    from rlrpt_tpu_torch.parallel.mesh import make_mesh

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        torch.set_num_threads(max(1, available_devices("cpu") // world))
    multihost.initialize(address, world, rank, device=dev)
    try:
        mesh = make_mesh(device=dev)
        scene = scene.to(dev)

        def frame(seed):
            img, aux = render_default_dp(seed, scene, camera, cfg, mesh)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return aux

        aux = frame(SEED)      # warm-up
        best = float("inf")
        for r in range(repeats):
            t0 = time.perf_counter()
            aux = frame(fold_in(SEED, r))
            best = min(best, time.perf_counter() - t0)
        return best, aux["avg_path_length"]
    finally:
        dist.destroy_process_group()


def run_scaling(scene, camera, cfg: RenderConfig, sizes, repeats: int = 3,
                mode: str = "strong", device="cuda",
                timeout: float = 600.0):
    """Measure rays/s for each size in ``sizes``; returns a list of result
    dicts (the JAX tool's keys).  mode "strong": fixed total work; "weak":
    the frame height times d."""
    from rlrpt_tpu_torch.parallel.multihost import spawn

    scene = scene.to("cpu")    # each rank moves it to its own device
    results = []
    base_rps = base_d = base_sec = None
    for d in sizes:
        n_avail = available_devices(device)
        if d > n_avail:
            print(f"# skipping size {d}: only {n_avail} devices")
            continue
        cfg_d = cfg if mode == "strong" else dataclasses.replace(
            cfg, height=cfg.height * d)
        best, avg_path = spawn(_bench_rank, d,
                               (scene, camera, cfg_d, repeats, str(device)),
                               timeout=timeout)[0]
        rps = avg_path * cfg_d.n_pixels * cfg_d.samples_per_pixel / best
        if base_rps is None:
            base_rps, base_d, base_sec = rps, d, best
        row = {"mode": mode, "devices": d, "seconds": best,
               "rays_per_sec": rps, "rays_per_sec_per_device": rps / d}
        if mode == "strong":
            speedup = rps / base_rps
            row["speedup"] = speedup
            row["efficiency"] = speedup / (d / base_d)
        else:
            # ideal weak scaling keeps the time flat
            row["pixels"] = cfg_d.n_pixels
            row["weak_efficiency"] = base_sec / best
        results.append(row)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default=None,
                    help="comma-separated sizes (default 1,2,..,N pow2)")
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--bounces", type=int, default=20)
    ap.add_argument("--scene", default="cornell")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--mode", choices=("strong", "weak", "both"),
                    default="both")
    ap.add_argument("--json", default=None, help="also write results here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.sizes:
        sizes = [int(s) for s in args.sizes.split(",")]
    else:
        sizes, d = [], 1
        while d <= available_devices(args.device):
            sizes.append(d)
            d *= 2
    cfg = RenderConfig(width=args.width, height=args.height,
                       samples_per_pixel=args.spp,
                       max_ray_bounces=args.bounces, ray_tile=4096)
    scene, camera = _build_scene(args.scene, "cpu")
    modes = ["strong", "weak"] if args.mode == "both" else [args.mode]
    results = []
    for mode in modes:
        results += run_scaling(scene, camera, cfg, sizes,
                               repeats=args.repeats, mode=mode,
                               device=args.device)
    for r in results:
        print(json.dumps(r))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
