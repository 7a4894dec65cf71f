"""Record the reference's neural-Q training-stats protocol (counterpart of
``rlrpt_tpu/tools/nn_training_stats.py``).

The reference appends one `avg_path_length loss zero_contribution_paths`
line per spp sample while training (neural_q_pathtracer.cu:577-583 ->
Radiance_Map_Data/nn_training_stats.txt).  This harness writes that file
for the port's trainer: N frames x S spp of online neural-Q training on a
scene, one stats line per spp sample (utils.stats.StatsLogger), plus the
training-curve plots (tools.training_curves) with --plot.

The per-spp granularity comes from driving the regenerative wavefront
trainer (deep.deep_wavefront) in 1-spp chunks: each chunk is one spp
sample's budget, so its totals ARE the per-sample line; --impl lockstep
runs the bounce-synchronous trainer (deep.neural_q), which reports true
per-spp arrays.  Chunk s of frame f takes the seed
``evaluate.fold_in(1984, 100 + f * spp + s)`` (lockstep frame f:
``fold_in(1984, 100 + f)``), the net ``fold_in(1984, 7)``, the JAX tool's
stream numbers.

Usage: python -m rlrpt_tpu_torch.tools.nn_training_stats [--frames 8]
       [--spp 8] [--size 720] [--scene cornell] [--out nn_training_stats.txt]
       [--plot] [--json PATH] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.config import (DeepLearningConfig, RadianceVolumeConfig,
                                    RenderConfig)
from rlrpt_tpu_torch.tools.evaluate import fold_in
from rlrpt_tpu_torch.utils.stats import StatsLogger

SEED = 1984


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--size", type=int, default=720)
    ap.add_argument("--bounces", type=int, default=80)
    ap.add_argument("--scene", default="cornell")
    ap.add_argument("--impl", choices=("wavefront", "lockstep"),
                    default="wavefront")
    ap.add_argument("--pix-mux", type=int, default=8)
    ap.add_argument("--out", default="nn_training_stats.txt")
    ap.add_argument("--eps-start", type=float, default=None,
                    help="initial epsilon; default = the reference's "
                         "EPSILON_START 0.05 (deep_learning_settings.h:5; "
                         "with EPSILON_MIN also 0.05 the reference runs a "
                         "CONSTANT 0.05)")
    ap.add_argument("--plot", action="store_true",
                    help="also render the three training-curve PNGs")
    ap.add_argument("--json", default=None,
                    help="write a summary JSON (first/last rows, timing)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda runs the CUDA kernels, cpu "
                         "their plain torch twins")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    from rlrpt_tpu_torch.deep.neural_q import init_neural_q
    from rlrpt_tpu_torch.scene import presets

    device = torch.device(args.device)
    p = presets.get(args.scene)
    scene, cam = p.load(device=device), Camera.create(p.camera_position)
    rl = RadianceVolumeConfig()
    dl = DeepLearningConfig()
    net, opt_state = init_neural_q(fold_in(SEED, 7), scene, dl,
                                   rl.grid_resolution, device)
    log = StatsLogger(args.out, reset=True)
    eps = dl.epsilon_start if args.eps_start is None else args.eps_start
    t0 = time.perf_counter()
    rows = []
    extras = []  # per-sample [loss_rel, light_hit_fraction, avg_light_len]

    if args.impl == "wavefront":
        from rlrpt_tpu_torch.deep.deep_wavefront import (
            render_frame_neural_q_wavefront)
        cfg1 = RenderConfig(width=args.size, height=args.size,
                            samples_per_pixel=1,
                            max_ray_bounces=args.bounces)
        for f in range(args.frames):
            for s in range(args.spp):
                # One 1-spp chunk == one spp sample of the reference's
                # loop; epsilon decays once per chunk like the
                # reference's per-sample decay.
                _, net, opt_state, eps, aux = \
                    render_frame_neural_q_wavefront(
                        fold_in(SEED, 100 + f * args.spp + s), scene, cam,
                        net, opt_state, eps, cfg1, rl, dl,
                        pix_mux=args.pix_mux)
                row = (float(aux["avg_path_length"]), float(aux["loss"]),
                       int(aux["zero_contribution_light_paths"]))
                log.append(*row)
                rows.append(row)
                extras.append((float(aux["loss_rel"]),
                               float(aux["light_hit_fraction"]),
                               float(aux["avg_light_path_length"])))
    else:
        from rlrpt_tpu_torch.deep.neural_q import render_frame_neural_q
        cfg = RenderConfig(width=args.size, height=args.size,
                           samples_per_pixel=args.spp,
                           max_ray_bounces=args.bounces)
        for f in range(args.frames):
            _, net, opt_state, eps, aux = render_frame_neural_q(
                fold_in(SEED, 100 + f), scene, cam, net, opt_state, eps, cfg,
                rl, dl)
            for s in range(args.spp):
                row = (float(aux["avg_path_length"][s]),
                       float(aux["loss"][s]),
                       int(aux["zero_contribution_light_paths"][s]))
                log.append(*row)
                rows.append(row)
    train_sec = time.perf_counter() - t0

    outputs = [args.out]
    if args.plot:
        from rlrpt_tpu_torch.tools.training_curves import plot_stats
        outputs += plot_stats(args.out)

    summary = {
        "protocol": ("per-spp avg_path_length loss zclp "
                     "(neural_q_pathtracer.cu:577-583)"),
        "impl": args.impl, "scene": args.scene, "size": args.size,
        "frames": args.frames, "spp": args.spp,
        "eps_start": eps if not rows else (
            dl.epsilon_start if args.eps_start is None else args.eps_start),
        "train_sec": round(train_sec, 2),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "first": rows[0], "last": rows[-1],
        "loss_first_frame": sum(r[1] for r in rows[:args.spp]),
        "loss_last_frame": sum(r[1] for r in rows[-args.spp:]),
        "zclp_first": rows[0][2], "zclp_last": rows[-1][2],
        "files": outputs,
    }
    if extras:
        # Scale-free diagnostics (wavefront impl): the absolute loss tracks
        # the growing Q^2 magnitude; loss_rel = loss / sum(td^2) is the
        # convergence curve, and the light-terminated subset is where
        # "guidance finds lights sooner" shows.
        summary["loss_rel_first_frame"] = (
            sum(e[0] for e in extras[:args.spp]) / args.spp)
        summary["loss_rel_last_frame"] = (
            sum(e[0] for e in extras[-args.spp:]) / args.spp)
        summary["light_hit_fraction_first"] = extras[0][1]
        summary["light_hit_fraction_last"] = extras[-1][1]
        summary["avg_light_path_first"] = extras[0][2]
        summary["avg_light_path_last"] = extras[-1][2]
        summary["per_sample_extras"] = [
            {"loss_rel": round(e[0], 6), "light_hit_fraction": round(e[1], 6),
             "avg_light_path_length": round(e[2], 3)} for e in extras]
    print(json.dumps(summary))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1)
    return summary


if __name__ == "__main__":
    main()
