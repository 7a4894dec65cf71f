"""Seconds of the sarsa-mega learning frame and of its CDF rebuild on one
card, with ``rebuild_bin_cdf``'s two summation orders in turns.

    python scripts/rebuild_timing.py [--frames 10] [--rounds 2]

The loop is ``tools/render.py --mode sarsa-mega``'s on the Cornell box at
720x720, 32 spp, 80 bounces: ``render_sarsa_mega_train`` and then
``rebuild_bin_cdf`` for each learning frame, a frame's seconds on the
host's clock from its launch until its table and aux are read (as the
CLI's ``seconds``).  The orders: ``torch`` (torch.sum and torch.cumsum,
the card's default) and ``jax`` (``jax_order=True``: row_sum and
row_cumsum, the JAX package's order, the CPU's default).  The rebuild
alone is timed by CUDA events, the mean of 50 calls on the last frame's
Q.  Each round runs jax, torch, torch, jax, each turn from the same Q;
one JSON line a turn, then the largest difference between the two
orders' tables.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from rlrpt_tpu_torch.camera import Camera  # noqa: E402
from rlrpt_tpu_torch.config import (RadianceVolumeConfig,  # noqa: E402
                                    RenderConfig)
from rlrpt_tpu_torch.ops import guided_mega_train as gt  # noqa: E402
from rlrpt_tpu_torch.ops.megakernel import _t_pad  # noqa: E402
from rlrpt_tpu_torch.scene import cornell_box  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frames", type=int, default=10)
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args(argv)
    dev = torch.device("cuda")
    scene, cam = cornell_box(device=dev), Camera.create((0.0, 0.0, -3.0))
    cfg = RenderConfig(width=720, height=720, samples_per_pixel=32,
                       max_ray_bounces=80)
    rl = RadianceVolumeConfig(grid_resolution=11)
    gr, ub, t_pad = 11, 4, _t_pad(scene.n_triangles)
    q0, v0 = gt.init_bin_q(t_pad, ub, gr, rl.initial_radiance, device=dev)

    def rebuild(q, order):
        return gt.rebuild_bin_cdf(q, gr, ub, t_pad,
                                  defensive_mix=rl.defensive_mix,
                                  jax_order=order == "jax")

    def turn(order: str):
        q, vis = q0, v0
        table = rebuild(q, order)
        secs = []
        for fr in range(args.frames):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, q, vis, aux = gt.render_sarsa_mega_train(
                7 + fr, scene, cam, table, q, vis, cfg,
                rl.radiance_threshold, dev)
            table = rebuild(q, order)
            float(aux["avg_path_length"]), float(table.cdf[0, 0])
            secs.append(time.perf_counter() - t0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(50):
            rebuild(q, order)
        end.record()
        torch.cuda.synchronize()
        return {"order": order, "frame_seconds": secs,
                "median_frame_seconds": statistics.median(secs[1:]),
                "rebuild_ms": start.elapsed_time(end) / 50}, q

    for _ in range(args.rounds):
        for order in ("jax", "torch", "torch", "jax"):
            row, q = turn(order)
            print(json.dumps(row), flush=True)
    diff = (rebuild(q, "jax").cdf.float()
            - rebuild(q, "torch").cdf.float()).abs()
    print(json.dumps({"tables_max_abs_diff": float(diff.max()),
                      "entries_differing": int((diff > 0).sum()),
                      "entries": diff.numel()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
