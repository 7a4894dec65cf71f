"""Neural-Q frame-time benchmark (counterpart of
``rlrpt_tpu/tools/neural_q_bench.py``).

The reference's deep tracer loses >100x to host<->device ping-pong
(4_critical_evaluation.tex:283-285).  This harness records the port's
seconds per frame for both schedules, the hits on kernel B4a and the MLP
on cuBLAS float32:

  * lockstep (`--impl lockstep`): deep.neural_q / deep.pretrained, the
    reference's wavefront advanced full-width every bounce;
  * regenerative (`--impl wavefront`, default): deep.deep_wavefront, the
    sarsa_wavefront slot model with ONE MLP forward per iteration serving
    both the sampling distribution and the TD bootstrap.

Emits one JSON line per variant: steady-state sec/frame and traced rays/s
on the Cornell box at the reference's config (720x720, 80-bounce cap;
default spp 1).  Frame i takes the seed ``evaluate.fold_in(1984, i)``
(warm-up 900 + i), the net's initialisation ``fold_in(1984, 0)``.  Times
are the card's, or with ``--device cpu`` the plain twins'.

Usage: python -m rlrpt_tpu_torch.tools.neural_q_bench [--impl wavefront]
       [--spp 1] [--frames 3] [--size 720] [--pix-mux 8] [--skip-train]
       [--device cuda]
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

SEED = 1984


def _measure(fn, seed: int, frames: int, warmups: int = 3):
    """Steady-state (sec/frame, mean path length): `warmups` fenced
    frames, then `frames` frames fenced by one host read."""
    acc = 0.0
    for i in range(warmups):
        probe, _ = fn(fold_in(seed, 900 + i))
        acc = acc + probe
    float(acc)
    t0 = time.perf_counter()
    acc = 0.0
    lens = []
    for i in range(frames):
        probe, plen = fn(fold_in(seed, i))
        lens.append(plen)
        acc = acc + probe
    float(acc)
    dt = (time.perf_counter() - t0) / frames
    # the lockstep reports one path length per spp: their mean
    return dt, sum(float(torch.as_tensor(p).double().mean())
                   for p in lens) / len(lens)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--impl", choices=("wavefront", "lockstep"),
                    default="wavefront")
    ap.add_argument("--spp", type=int, default=1)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--size", type=int, default=720)
    ap.add_argument("--bounces", type=int, default=80)
    ap.add_argument("--batch-size", type=int, default=4096)
    ap.add_argument("--pix-mux", type=int, default=8,
                    help="wavefront impl: pixels multiplexed per slot")
    ap.add_argument("--train-on-position", action="store_true")
    ap.add_argument("--mlp-dtype", choices=("f32", "bf16"), default="f32",
                    help="pretrained-wavefront forward precision")
    ap.add_argument("--train-batching", choices=("minibatch", "fused"),
                    default="minibatch",
                    help="wavefront trainer: the reference's sequential "
                         "4096-ray Adam scan, or ONE step per iteration")
    ap.add_argument("--skip-train", action="store_true")
    ap.add_argument("--skip-pretrained", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda runs the CUDA kernels, cpu "
                         "their plain torch twins")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    from rlrpt_tpu_torch.deep.neural_q import init_neural_q
    from rlrpt_tpu_torch.scene import cornell_box

    device = torch.device(args.device)
    cfg = RenderConfig(width=args.size, height=args.size,
                       samples_per_pixel=args.spp,
                       max_ray_bounces=args.bounces)
    rl = RadianceVolumeConfig()
    dl = DeepLearningConfig(batch_size=args.batch_size,
                            train_on_position=args.train_on_position)
    scene = cornell_box(device=device)
    cam = Camera.create([0.0, 0.0, -3.0])
    net, opt_state = init_neural_q(fold_in(SEED, 0), scene, dl,
                                   rl.grid_resolution, device)
    total = cfg.n_pixels * cfg.samples_per_pixel

    if not args.skip_train:
        # The training state is threaded outside the timed closure: the
        # net keeps training across frames like the reference's frames.
        box = {"opt": opt_state, "eps": 1.0}
        if args.impl == "wavefront":
            from rlrpt_tpu_torch.deep.deep_wavefront import (
                render_frame_neural_q_wavefront)

            def run_train(s):
                img, _, o, e, aux = render_frame_neural_q_wavefront(
                    s, scene, cam, net, box["opt"], box["eps"], cfg, rl, dl,
                    pix_mux=args.pix_mux, train_batching=args.train_batching)
                box.update(opt=o, eps=e, loss=aux["loss"])
                return img.sum(), aux["avg_path_length"]
        else:
            from rlrpt_tpu_torch.deep.neural_q import render_frame_neural_q

            def run_train(s):
                img, _, o, e, aux = render_frame_neural_q(
                    s, scene, cam, net, box["opt"], box["eps"], cfg, rl, dl)
                box.update(opt=o, eps=e, loss=aux["loss"][-1])
                return img.sum(), aux["avg_path_length"]

        dt, plen = _measure(run_train, SEED, args.frames)
        out = {"which": f"neural_q_train_{args.impl}",
               "sec_per_frame": round(dt, 4), "spp": args.spp,
               "size": args.size, "pix_mux": args.pix_mux,
               "train_batching": args.train_batching,
               "final_loss": float(torch.as_tensor(box["loss"]).sum())}
        if args.impl == "wavefront":
            # path_sum counts every traced segment: the training frame's
            # true throughput (the lockstep's image-path stat leaves out
            # the learning-only respawns, a lower bound).
            out["rays_per_sec"] = round(plen * total / dt, 1)
        else:
            out["image_rays_per_sec_lower_bound"] = round(plen * total / dt,
                                                          1)
        print(json.dumps(out), flush=True)

    if not args.skip_pretrained:
        if args.impl == "wavefront":
            from rlrpt_tpu_torch.deep.deep_wavefront import (
                render_frame_pretrained_wavefront)

            def run_inf(s):
                img, aux = render_frame_pretrained_wavefront(
                    s, scene, cam, net, cfg, rl, dl, pix_mux=args.pix_mux,
                    mlp_dtype=args.mlp_dtype)
                return img.sum(), aux["avg_path_length"]
        else:
            from rlrpt_tpu_torch.deep.pretrained import render_frame_pretrained

            def run_inf(s):
                img, aux = render_frame_pretrained(s, scene, cam, net, cfg,
                                                   rl, dl)
                return img.sum(), aux["avg_path_length"]

        dt, plen = _measure(run_inf, SEED, args.frames)
        print(json.dumps({
            "which": f"neural_q_pretrained_{args.impl}",
            "sec_per_frame": round(dt, 4), "spp": args.spp,
            "size": args.size, "pix_mux": args.pix_mux,
            "mlp_dtype": args.mlp_dtype,
            "rays_per_sec": round(plen * total / dt, 1)}), flush=True)


if __name__ == "__main__":
    main()
