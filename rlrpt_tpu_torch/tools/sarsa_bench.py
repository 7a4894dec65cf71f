"""SARSA frame-time benchmark (counterpart of
``rlrpt_tpu/tools/sarsa_bench.py``).

The reference cites a +20% overhead for expected SARSA over the default
tracer at equal spp (4_critical_evaluation.tex:272, BASELINE.md).  This
harness measures the port's ratio at the bench point: steady-state
seconds per frame (and rays/s) for

  * the default torch wavefront (integrators.wavefront, kernel B4a), the
    like-for-like baseline: the SARSA tracer is the same wavefront
    machinery plus the RL additions (volume search, TD scatters, CDF
    sampling), as the reference's +20% compares its two kernels,
  * the default megakernel (ops.megakernel, kernel B1, the bench path),
  * the regenerative SARSA wavefront (integrators.sarsa_wavefront, B4a),
  * the binned learning frame (ops.guided_mega_train, B2, with the CDF
    rebuild) and the guided render (ops.guided_mega, B3),

on the Cornell box at 720x720, 1 spp, 80-bounce cap, default volume
density.

Timing protocol (shared ``measure``): 3 warm-up frames, then `trials`
trials of `frames` frames, each trial fenced by ONE host read; the best
trial is reported, with the mean path length of the same trial.  Frame i
of trial t takes the seed ``evaluate.fold_in(1984, 100 t + i)`` (warm-up
900 + i), the JAX tool's stream numbers.  Times are the card's, or with
``--device cpu`` the plain twins' (no device metric).

Usage: python -m rlrpt_tpu_torch.tools.sarsa_bench [--spp 1] [--frames 6]
       [--area-per-sample 0.001] [--pix-mux 8] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.config import RadianceVolumeConfig, RenderConfig
from rlrpt_tpu_torch.tools.evaluate import fold_in

SEED = 1984


def measure(fn, seed: int, frames: int, trials: int = 2):
    """Steady-state sec/frame for `fn(seed) -> (probe_scalar, path_len)`
    (0-d tensors).

    Warm-up: 3 executions, fenced.  Then `trials` trials of `frames`
    chained executions each; ONE host read per trial; returns (best
    sec/frame, mean path length of that trial).
    """
    acc = 0.0
    for i in range(3):
        probe, _ = fn(fold_in(seed, 900 + i))
        acc = acc + probe
    float(acc)

    best = (float("inf"), 0.0)
    for t in range(trials):
        t0 = time.perf_counter()
        acc = 0.0
        paths = []
        for i in range(frames):
            probe, plen = fn(fold_in(seed, 100 * t + i))
            paths.append(plen)
            acc = acc + probe
        float(acc)
        dt = (time.perf_counter() - t0) / frames
        if dt < best[0]:
            best = (dt, sum(float(p) for p in paths) / len(paths))
    return best


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spp", type=int, default=1)
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--width", type=int, default=720)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--bounces", type=int, default=80)
    ap.add_argument("--area-per-sample", type=float, default=0.001)
    ap.add_argument("--pix-mux", type=int, default=8)
    ap.add_argument("--skip-mega", action="store_true")
    ap.add_argument("--skip-wavefront", action="store_true")
    ap.add_argument("--search", choices=("table", "grid"), default="table",
                    help="volume search: precomputed class-answer table "
                         "(fast) or bucketed candidate grid")
    ap.add_argument("--drain-factor", type=int, default=4)
    ap.add_argument("--min-drain-w", type=int, default=512)
    ap.add_argument("--cdf-dtype", choices=("f32", "bf16"), default="f32")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda runs the CUDA kernels, cpu "
                         "their plain torch twins")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    from rlrpt_tpu_torch.scene import cornell_box

    device = torch.device(args.device)
    cfg = RenderConfig(width=args.width, height=args.height,
                       samples_per_pixel=args.spp,
                       max_ray_bounces=args.bounces)
    scene = cornell_box(device=device)
    cam = Camera.create([0.0, 0.0, -3.0])
    total = cfg.n_pixels * cfg.samples_per_pixel

    def line(d):
        print(json.dumps(d), flush=True)

    wf_dt = None
    if not args.skip_wavefront:
        from rlrpt_tpu_torch.integrators.wavefront import render_wavefront

        def run_wf(s):
            img, aux = render_wavefront(s, scene, cam, cfg, device)
            return img.sum(), aux["avg_path_length"]

        wf_dt, plen = measure(run_wf, SEED, args.frames)
        line({"which": "default_wavefront", "sec_per_frame": round(wf_dt, 4),
              "rays_per_sec": round(plen * total / wf_dt, 1)})

    mega_dt = None
    if not args.skip_mega:
        from rlrpt_tpu_torch.ops.megakernel import render_default_mega

        def run_mega(s):
            img, aux = render_default_mega(s, scene, cam, cfg, device)
            return img.sum(), aux["avg_path_length"]

        mega_dt, plen = measure(run_mega, SEED, args.frames)
        line({"which": "default_mega", "sec_per_frame": round(mega_dt, 4),
              "rays_per_sec": round(plen * total / mega_dt, 1)})

    from rlrpt_tpu_torch.integrators.sarsa_wavefront import (
        render_frame_sarsa_wavefront)
    from rlrpt_tpu_torch.radiance.volumes import build_radiance_volumes

    rl = RadianceVolumeConfig(area_per_sample=args.area_per_sample)
    vols = build_radiance_volumes(scene, rl)
    if args.search == "table":
        from rlrpt_tpu_torch.radiance.grid_bucket import (
            build_volume_class_table)
        grid = build_volume_class_table(vols, scene)
        line({"n_volumes": int(vols.n_volumes), "search": "table",
              "cells": int(grid.table.shape[0]),
              "table_mb": round(grid.nbytes / 2**20, 1)})
    else:
        from rlrpt_tpu_torch.radiance.grid_bucket import build_volume_grid
        grid = build_volume_grid(vols)
        line({"n_volumes": int(vols.n_volumes), "search": "grid",
              "grid_cells": int(grid.payload.shape[0]),
              "k_max": int(grid.k_max)})

    # Learning changes the Q table, but a frame's cost does not depend on
    # the Q values, so every timed frame starts from the same `vols` and
    # the trials stay independent.
    last_aux = {}

    def run_sarsa(s):
        img, _, aux = render_frame_sarsa_wavefront(
            s, scene, cam, vols, grid, cfg, rl, pix_mux=args.pix_mux,
            drain_factor=args.drain_factor, min_drain_w=args.min_drain_w,
            cdf_dtype=args.cdf_dtype)
        last_aux.update(aux)
        return img.sum(), aux["avg_path_length"]

    dt, plen = measure(run_sarsa, SEED, args.frames)
    out = {"which": "sarsa_wavefront", "sec_per_frame": round(dt, 4),
           "rays_per_sec": round(plen * total / dt, 1),
           "iters": int(last_aux["wavefront_iterations"]),
           "pix_mux": args.pix_mux, "cdf_dtype": args.cdf_dtype,
           "phase_widths": [int(w) for w in last_aux["phase_widths"]],
           "phase_iters": [int(x) for x in last_aux["phase_iterations"]]}
    if wf_dt:
        out["overhead_vs_default_wavefront"] = round(dt / wf_dt - 1.0, 3)
    line(out)

    # ---- the binned learning frame (B2) and the guided render (B3) -------
    from rlrpt_tpu_torch.ops.guided_mega import render_guided_mega
    from rlrpt_tpu_torch.ops.guided_mega_train import (
        init_bin_q, rebuild_bin_cdf, render_sarsa_mega_train)
    from rlrpt_tpu_torch.ops.megakernel import _t_pad

    gr, ub = 11, 4
    rl_k = RadianceVolumeConfig(grid_resolution=gr)
    t_pad = _t_pad(scene.n_triangles)
    q0, v0 = init_bin_q(t_pad, ub, gr, rl_k.initial_radiance, device=device)
    tb0 = rebuild_bin_cdf(q0, gr, ub, t_pad)

    def run_train(s):
        img, q1, _, aux = render_sarsa_mega_train(
            s, scene, cam, tb0, q0, v0, cfg, rl_k.radiance_threshold, device)
        tb1 = rebuild_bin_cdf(q1, gr, ub, t_pad)   # timed inside the frame
        last_aux["train_iters"] = aux["wavefront_iterations"]
        return img.sum() + tb1.cdf.float().sum() * 0.0, \
            aux["avg_path_length"]

    tdt, tplen = measure(run_train, SEED, args.frames)
    line({"which": "sarsa_mega_train", "sec_per_frame": round(tdt, 4),
          "rays_per_sec": round(tplen * total / tdt, 1),
          "iters": int(last_aux["train_iters"]),
          "uv_bins": ub, "sector_grid": gr,
          "state_space": f"{t_pad * ub * ub} bins x {gr * gr} sectors",
          "overhead_vs_default_mega":
              round(tdt / mega_dt - 1.0, 3) if mega_dt else None,
          "speedup_vs_xla_sarsa_wavefront": round(dt / tdt, 2)})

    def run_infer(s):
        img, aux = render_guided_mega(s, scene, cam, tb0, cfg, device)
        return img.sum(), aux["avg_path_length"]

    idt, iplen = measure(run_infer, SEED, args.frames)
    line({"which": "sarsa_guided_infer", "sec_per_frame": round(idt, 4),
          "rays_per_sec": round(iplen * total / idt, 1),
          "overhead_vs_default_mega":
              round(idt / mega_dt - 1.0, 3) if mega_dt else None})


if __name__ == "__main__":
    main()
