"""Render CLI (counterpart of ``rlrpt_tpu/tools/render.py``):

    python -m rlrpt_tpu_torch.tools.render --mode mega --scene cornell \\
        --width 720 --height 720 --spp 32 --out render.png --device cuda

Modes ported so far:
  default     the plain torch wavefront tracer (integrators.default_tracer)
  wavefront   the persistent-wavefront tracer (integrators.wavefront), one
              closest-hit launch per bounce (CUDA kernel B4a)
  mega        the default path-tracing megakernel (ops.megakernel, CUDA
              kernel B1)
  sarsa-mega  the binned expected-SARSA pipeline: --frames learning frames
              (ops.guided_mega_train, CUDA kernel B2) with a CDF rebuild
              after each, then a guided render with the learned map
              (ops.guided_mega, CUDA kernel B3).  Prints avg_path and
              td_scatters per frame.  --stats (the training stats file)
              comes with utils/stats.py, not ported yet.

Kernel seeds come from a torch.Generator seeded with --seed: learning
frame f takes the f-th draw and the final guided render the next one, so
images differ from the JAX CLI's for the same --seed (both are unbiased).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.config import RadianceVolumeConfig, RenderConfig
from rlrpt_tpu_torch.scene import presets
from rlrpt_tpu_torch.utils.image import write_bmp, write_png

MODES = ("default", "wavefront", "mega", "sarsa-mega")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rlrpt-render", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--mode", choices=MODES, default="default")
    p.add_argument("--scene", choices=tuple(presets.PRESETS),
                   default="cornell")
    p.add_argument("--width", type=int, default=720)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--spp", type=int, default=32)
    p.add_argument("--bounces", type=int, default=80)
    p.add_argument("--frames", type=int, default=1,
                   help="sarsa-mega learning frames")
    p.add_argument("--seed", type=int, default=1984)
    p.add_argument("--out", default="render.png", help=".png or .bmp")
    p.add_argument("--grid-resolution", type=int, default=12)
    p.add_argument("--russian-roulette", action="store_true")
    p.add_argument("--rr-start-bounce", type=int, default=3)
    p.add_argument("--rr-min-prob", type=float, default=0.05)
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda runs the CUDA kernels, cpu "
                        "their plain torch twins")
    return p


def render(args: argparse.Namespace):
    """Render as ``args`` say; returns (image (H, W, 3) float32 tensor,
    aux dict).  For sarsa-mega, aux also holds "frames" (per learning
    frame: avg_path, td_scatters, seconds), "guided_seconds" and the
    learned "q" and "visits"."""
    device = torch.device(args.device)
    cfg = RenderConfig(width=args.width, height=args.height,
                       samples_per_pixel=args.spp,
                       max_ray_bounces=args.bounces,
                       russian_roulette=args.russian_roulette,
                       rr_start_bounce=args.rr_start_bounce,
                       rr_min_prob=args.rr_min_prob)
    preset = presets.get(args.scene)
    scene = preset.load(device=device)
    camera = Camera.create(preset.camera_position)
    seeds = torch.Generator().manual_seed(args.seed)

    def next_seed() -> int:   # the kernels' int seed, as JAX draws it
        return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=seeds))

    if args.mode == "default":
        from rlrpt_tpu_torch.integrators.default_tracer import render_default
        return render_default(next_seed(), scene, camera, cfg, device)
    if args.mode == "wavefront":
        from rlrpt_tpu_torch.integrators.wavefront import render_wavefront
        return render_wavefront(next_seed(), scene, camera, cfg, device)
    if args.mode == "mega":
        from rlrpt_tpu_torch.ops.megakernel import render_default_mega
        return render_default_mega(next_seed(), scene, camera, cfg, device)

    # sarsa-mega: the pipeline of rlrpt_tpu/tools/render.py:160-193.
    from rlrpt_tpu_torch.ops.guided_mega import render_guided_mega
    from rlrpt_tpu_torch.ops.guided_mega_train import (
        init_bin_q, rebuild_bin_cdf, render_sarsa_mega_train)
    from rlrpt_tpu_torch.ops.megakernel import _t_pad
    rl = RadianceVolumeConfig(grid_resolution=args.grid_resolution)
    if rl.grid_resolution == 12:
        rl = dataclasses.replace(rl, grid_resolution=11)
    gr, ub = rl.grid_resolution, 4
    t_pad = _t_pad(scene.n_triangles)
    q, vis = init_bin_q(t_pad, ub, gr, rl.initial_radiance, device=device)
    table = rebuild_bin_cdf(q, gr, ub, t_pad,
                            defensive_mix=rl.defensive_mix)
    frames = []
    for fr in range(args.frames):
        t0 = time.perf_counter()
        _, q, vis, aux = render_sarsa_mega_train(
            next_seed(), scene, camera, table, q, vis, cfg,
            rl.radiance_threshold, device)
        table = rebuild_bin_cdf(q, gr, ub, t_pad,
                                defensive_mix=rl.defensive_mix)
        stats = {"avg_path": float(aux["avg_path_length"]),
                 "td_scatters": int(aux["td_scatter_count"])}
        stats["seconds"] = time.perf_counter() - t0   # the reads waited
        frames.append(stats)
        print(f"frame {fr}: avg_path {stats['avg_path']:.2f}  td_scatters "
              f"{stats['td_scatters']}")
    t0 = time.perf_counter()
    img, aux = render_guided_mega(next_seed(), scene, camera, table, cfg,
                                  device)
    float(aux["avg_path_length"])   # wait for the device
    aux.update(frames=frames, guided_seconds=time.perf_counter() - t0, q=q,
               visits=vis)
    return img, aux


def save(img, path: str) -> None:
    if path.lower().endswith(".bmp"):
        write_bmp(path, img)
    else:
        write_png(path, img)
    print(f"saved {path}")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    t0 = time.perf_counter()
    img, aux = render(args)
    img = img.cpu()   # waits for the device
    print(f"render time {time.perf_counter() - t0:.3f}s  avg_path_length "
          f"{float(aux['avg_path_length']):.4f}")
    save(img, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
