"""Benchmark: rays/s on one card, the Cornell default path trace at 1 spp
(counterpart of the JAX package's ``bench.py``).

    python -m rlrpt_tpu_torch.bench [--device cuda] [--size 720]

The same point and protocol as ``bench.py``: the hard-coded Cornell box at
the reference's 720x720 with the full 80-bounce cap, 1 spp, through
``render_default_mega`` (kernel B1 on the card); 3 warm-up frames, then 5
trials of 10 frames, each trial fenced once; the median trial is the
value.  "Rays" are traced path segments: the frames' average path length
x pixels x spp.

Per-trial lines go to stderr; stdout gets ONE JSON line with the keys of
``bench.py``: metric, value, unit and vs_baseline, against the same
order-of-magnitude estimate of the reference engine on its GTX 1070Ti,
1.0e8 rays/s.  ``--device cpu`` times the plain torch twin (a test of the
line, not a device metric); ``--size`` shrinks the frame for that.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.config import RenderConfig
from rlrpt_tpu_torch.utils.profiling import host_fence

REFERENCE_RAYS_PER_SEC_ESTIMATE = 1.0e8
WARMUP, TRIALS, REPS = 3, 5, 10


def measure(device="cuda", size: int = 720, log=None) -> dict:
    """Run the bench protocol on ``device``.  Returns rays_per_s (the
    median trial), trials (rays/s each), frame_ms (each trial's mean) and
    the last frame's image and aux.  ``log(trial, rays_per_s, frame_ms)``
    is called after each trial."""
    from rlrpt_tpu_torch.ops.megakernel import render_default_mega
    from rlrpt_tpu_torch.scene import cornell_box

    device = torch.device(device)
    cfg = RenderConfig(width=size, height=size, samples_per_pixel=1,
                       max_ray_bounces=80)
    scene = cornell_box(device=device)
    cam = Camera.create([0.0, 0.0, -3.0])

    def render(seed):
        return render_default_mega(seed, scene, cam, cfg, device)

    for i in range(WARMUP):
        img, aux = render(1000 + i)
    host_fence(img)
    trials, frame_ms = [], []
    for trial in range(TRIALS):
        paths = torch.zeros((), dtype=torch.float64, device=device)
        t0 = time.perf_counter()
        for i in range(REPS):
            img, aux = render(trial * REPS + i)
            paths += aux["avg_path_length"]
        rays = float(paths) * cfg.n_pixels * cfg.samples_per_pixel  # fence
        dt = time.perf_counter() - t0
        trials.append(rays / dt)
        frame_ms.append(dt / REPS * 1e3)
        if log:
            log(trial, trials[-1], frame_ms[-1])
    return {"rays_per_s": statistics.median(trials), "trials": trials,
            "frame_ms": frame_ms, "image": img, "aux": aux}


def result_line(rays_per_s: float, size: int = 720) -> dict:
    """bench.py's JSON line for a measured rays/s."""
    return {
        "metric": f"rays/sec/chip (cornell {size}x{size}, 1 spp, 80-bounce "
                  "cap)",
        "value": round(rays_per_s, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_s / REFERENCE_RAYS_PER_SEC_ESTIMATE, 4),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda runs kernel B1; cpu its plain torch twin")
    ap.add_argument("--size", type=int, default=720,
                    help="frame width and height (the bench point is 720)")
    args = ap.parse_args(argv)

    def log(trial, rays, ms):
        print(f"trial {trial}: {rays / 1e6:.1f}M rays/s ({ms:.4f} ms/frame)",
              file=sys.stderr, flush=True)

    out = measure(args.device, args.size, log)
    trials = out["trials"]
    print(f"median {out['rays_per_s'] / 1e6:.1f}M  best "
          f"{max(trials) / 1e6:.1f}M  spread "
          f"{(max(trials) / min(trials) - 1) * 100:.1f}%",
          file=sys.stderr, flush=True)
    print(json.dumps(result_line(out["rays_per_s"], args.size)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
