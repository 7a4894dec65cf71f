"""Render CLI (counterpart of ``rlrpt_tpu/tools/render.py``):

    python -m rlrpt_tpu_torch.tools.render --mode mega --scene cornell \\
        --width 720 --height 720 --spp 32 --out render.png --device cuda

Modes ported so far:
  default     the plain torch wavefront tracer (integrators.default_tracer)
  wavefront   the persistent-wavefront tracer (integrators.wavefront), one
              closest-hit launch per bounce (CUDA kernel B4a)
  mega        the default path-tracing megakernel (ops.megakernel, CUDA
              kernel B1)
  sarsa       the lockstep expected-SARSA tracer, learning while it renders
              (integrators.reinforcement_tracer, kernel B4b): --frames
              learning frames; the image is the last frame's
  sarsa-fast  `sarsa` on the regenerative wavefront with the answer-table
              nearest-volume search (integrators.sarsa_wavefront, kernel
              B4a with the table's class ids); --pix-mux pixels per slot
  sarsa-mega  the binned expected-SARSA pipeline: --frames learning frames
              (ops.guided_mega_train, CUDA kernel B2) with a CDF rebuild
              after each, then a guided render with the learned map
              (ops.guided_mega, CUDA kernel B3); --grid-resolution 12
              runs 11x11 sectors, as the JAX tool does, unless
              --keep-grid is given
  voronoi     primary hits coloured by their nearest radiance volume
  importance  a path trace guided by a frozen map: --load-q, else one
              precomputed with --precompute-spp paths per sector
  precomputed the interpolated irradiance of such a map at primary hits
  neural-q    the deep-Q tracer training its MLP online (Adam, cuBLAS
              matmuls) for --frames frames; --impl wavefront (the
              regenerative slot wavefront, deep.deep_wavefront, --pix-mux
              pixels per slot) or lockstep (deep.neural_q); kernel B4a
  pretrained  the deep-Q tracer with a frozen net (--model, a DyNet text
              file; else a random one): --impl wavefront (--mlp-dtype
              f32|bf16) or lockstep (deep.pretrained); kernel B4a
  q-probe     the normalised Q rows of --model at the --probe points,
              written to --out-probe (deep.q_probe)
  distill     the offline trainer: a Q table (--load-q) and the scene's
              vertices (--vertices) distilled into a net for --epochs
              epochs (deep.distill), saved with --save-model

--scene takes every preset of scene/presets.py: the built-in cornell and
test_room, and the OBJ scenes, read from RLRPT_MODELS_DIR (a missing
model raises FileNotFoundError naming it).  sarsa-mega runs single-chunk
scenes only (at most 256 triangles), as the JAX package's does.

The radiance volumes are placed one per --area-per-sample of surface
(V = 24,526 on the Cornell box at the default 0.001).  --save-q writes the
learned Q table as radiance_map_data.txt text, --load-q starts from one,
--stats appends `avg_path loss zclp` per learning frame (loss 0), and for
neural-q one line per frame (wavefront) or per spp (lockstep).  The deep
modes' --save-model writes the net as DyNet text, which the JAX package
reads.

Kernel seeds and generators come from a torch.Generator seeded with
--seed: learning frame f takes the f-th draw and a final render the next
one, so images differ from the JAX CLI's for the same --seed (both are
unbiased).
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
from rlrpt_tpu_torch.utils.stats import StatsLogger

MODES = ("default", "wavefront", "mega", "sarsa", "sarsa-fast", "sarsa-mega",
         "voronoi", "importance", "precomputed", "neural-q", "pretrained",
         "q-probe", "distill")
DEEP_MODES = ("neural-q", "pretrained", "q-probe", "distill")


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
                   help="learning frames of sarsa, sarsa-fast, sarsa-mega, "
                        "neural-q")
    p.add_argument("--seed", type=int, default=1984)
    p.add_argument("--out", default="render.png", help=".png or .bmp")
    p.add_argument("--grid-resolution", type=int, default=12)
    p.add_argument("--keep-grid", action="store_true",
                   help="sarsa-mega: run --grid-resolution as given (the "
                        "default maps 12 to 11, as the JAX tool does)")
    p.add_argument("--area-per-sample", type=float, default=0.001)
    p.add_argument("--pix-mux", type=int, default=4,
                   help="pixels per wavefront slot (sarsa-fast, the deep "
                        "wavefront)")
    p.add_argument("--stats", default=None,
                   help="training stats file (sarsa, sarsa-fast, sarsa-mega, "
                        "neural-q)")
    p.add_argument("--save-q", default=None, help="save Q-table text file")
    p.add_argument("--load-q", default=None,
                   help="load Q-table text file (distill: its input)")
    p.add_argument("--model", default=None, help="DyNet-format model path")
    p.add_argument("--save-model", default=None,
                   help="write the net as a DyNet-format model")
    p.add_argument("--probe", default=None, help="to_select.txt (q-probe)")
    p.add_argument("--out-probe", default="selected_deep.txt")
    p.add_argument("--vertices", default=None,
                   help="vertices.txt (distill)")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--impl", choices=("wavefront", "lockstep"),
                   default="wavefront",
                   help="neural-q / pretrained schedule: the regenerative "
                        "slot wavefront or the reference-shaped lockstep")
    p.add_argument("--mlp-dtype", choices=("f32", "bf16"), default="f32",
                   help="Q-forward precision of the pretrained wavefront")
    p.add_argument("--precompute-spp", type=int, default=16)
    p.add_argument("--russian-roulette", action="store_true")
    p.add_argument("--rr-start-bounce", type=int, default=3)
    p.add_argument("--rr-min-prob", type=float, default=0.05)
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda runs the CUDA kernels, cpu "
                        "their plain torch twins")
    return p


def render(args: argparse.Namespace):
    """Render as ``args`` say; returns (image (H, W, 3) float32 tensor,
    aux dict); q-probe and distill return no image (None).  For
    sarsa-mega, aux also holds "frames" (per learning frame: avg_path,
    td_scatters, seconds, visits: the total after the frame, read after
    its seconds), "guided_seconds" and the learned "q" and "visits"."""
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
    stats = StatsLogger(args.stats) if args.stats else None
    if args.mode in DEEP_MODES:
        return _render_deep(args, scene, camera, cfg, device, next_seed,
                            stats)
    if args.mode != "sarsa-mega":
        return _render_volumes(args, scene, camera, cfg, device, next_seed,
                               stats)

    # sarsa-mega: the pipeline of rlrpt_tpu/tools/render.py:160-193.
    from rlrpt_tpu_torch.ops.guided_mega import render_guided_mega
    from rlrpt_tpu_torch.ops.guided_mega_train import (
        init_bin_q, rebuild_bin_cdf, render_sarsa_mega_train)
    from rlrpt_tpu_torch.ops.megakernel import _t_pad
    rl = RadianceVolumeConfig(grid_resolution=args.grid_resolution)
    if rl.grid_resolution == 12 and not args.keep_grid:
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
        row = {"avg_path": float(aux["avg_path_length"]),
               "td_scatters": int(aux["td_scatter_count"])}
        row["seconds"] = time.perf_counter() - t0   # the reads waited
        row["visits"] = int(vis.double().sum())
        frames.append(row)
        print(f"frame {fr}: avg_path {row['avg_path']:.2f}  td_scatters "
              f"{row['td_scatters']}")
        if stats:
            stats.append(row["avg_path"], 0.0, 0)
    t0 = time.perf_counter()
    img, aux = render_guided_mega(next_seed(), scene, camera, table, cfg,
                                  device)
    float(aux["avg_path_length"])   # wait for the device
    aux.update(frames=frames, guided_seconds=time.perf_counter() - t0, q=q,
               visits=vis)
    return img, aux


def _render_volumes(args, scene, camera, cfg, device, next_seed, stats):
    """The modes on the fine radiance map (rlrpt_tpu/tools/render.py:
    195-263): sarsa, sarsa-fast, voronoi, importance, precomputed.

    aux of sarsa / sarsa-fast: "frames" (per learning frame: seconds,
    avg_path, zclp, td_scatters, visits (the total after the frame) and,
    for sarsa-fast, iterations, phase widths and phase iterations), the
    learned "vols", and for sarsa-fast the answer "table" and its
    "table_seconds" (its host build, not in any frame's seconds)."""
    from rlrpt_tpu_torch.radiance import map_io
    from rlrpt_tpu_torch.radiance.volumes import (build_radiance_volumes,
                                                  rebuild_cdf)
    rl = RadianceVolumeConfig(grid_resolution=args.grid_resolution,
                              area_per_sample=args.area_per_sample)
    vols = build_radiance_volumes(scene, rl)
    gen = lambda: torch.Generator(device=device).manual_seed(  # noqa: E731
        next_seed())
    if args.mode == "voronoi":
        from rlrpt_tpu_torch.integrators.voronoi import (render_voronoi,
                                                         voronoi_colours)
        g = gen()
        cols = voronoi_colours(g, vols.n_volumes)
        return render_voronoi(g, scene, camera, vols, cols, cfg), {}
    if args.load_q:
        _, q, _ = map_io.load_radiance_map_data(args.load_q)
        vols = rebuild_cdf(dataclasses.replace(
            vols, q=torch.as_tensor(q, device=device)))
    if args.mode in ("importance", "precomputed"):
        from rlrpt_tpu_torch.integrators import precompute as pc
        if not args.load_q:
            vols = pc.precompute_radiance_grids(gen(), scene, vols, cfg,
                                                spp=args.precompute_spp)
        if args.mode == "importance":
            img, aux = pc.render_importance_sampled(gen(), scene, camera,
                                                    vols, cfg, rl)
        else:
            img, aux = pc.render_precomputed_irradiance(gen(), scene, camera,
                                                        vols, cfg), {}
        return img, dict(aux, vols=vols)

    if args.frames < 1:
        raise ValueError(f"{args.mode} needs --frames >= 1")
    aux_out = {}
    if args.mode == "sarsa-fast":
        from rlrpt_tpu_torch.integrators.sarsa_wavefront import \
            render_frame_sarsa_wavefront
        from rlrpt_tpu_torch.radiance.grid_bucket import \
            build_volume_class_table
        t0 = time.perf_counter()
        table = build_volume_class_table(vols, scene)
        aux_out.update(table=table, table_seconds=time.perf_counter() - t0)
        print(f"{vols.n_volumes} volumes; answer table {table.dims} = "
              f"{table.table.shape[0]} cells, {table.nbytes} bytes, built in "
              f"{aux_out['table_seconds']:.2f}s")

        def frame(g, vols):
            return render_frame_sarsa_wavefront(g, scene, camera, vols, table,
                                                cfg, rl, pix_mux=args.pix_mux)
    else:
        from rlrpt_tpu_torch.integrators.reinforcement_tracer import \
            render_frame_sarsa

        def frame(g, vols):
            return render_frame_sarsa(g, scene, camera, vols, cfg, rl)
    frames = []
    for fr in range(args.frames):
        t0 = time.perf_counter()
        img, vols, aux = frame(gen(), vols)
        row = {"avg_path": float(aux["avg_path_length"]),
               "zclp": int(aux["zero_contribution_light_paths"]),
               "td_scatters": int(aux["td_scatter_count"]),
               "visits": int(vols.visits.sum())}
        if "phase_widths" in aux:
            row.update(iterations=int(aux["wavefront_iterations"]),
                       phase_widths=list(aux["phase_widths"]),
                       phase_iterations=aux["phase_iterations"].tolist())
        row["seconds"] = time.perf_counter() - t0   # the reads waited
        frames.append(row)
        extra = (f"  iterations {row['iterations']}  phases "
                 + " ".join(f"{n}@{w}" for w, n in zip(
                     row["phase_widths"], row["phase_iterations"]))
                 if "iterations" in row else "")
        print(f"frame {fr}: avg_path {row['avg_path']:.2f}  zclp "
              f"{row['zclp']}  td_scatters {row['td_scatters']}{extra}  "
              f"{row['seconds']:.3f}s")
        if stats:
            stats.append(row["avg_path"], 0.0, row["zclp"])
    if args.save_q:
        map_io.save_q_vals_to_file(vols, args.save_q)
        print(f"saved {args.save_q}")
    return img, dict(aux, frames=frames, vols=vols, **aux_out)


def _render_deep(args, scene, camera, cfg, device, next_seed, stats):
    """The deep-Q modes (rlrpt_tpu/tools/render.py:123-134, 265-331).

    aux of neural-q: "frames" (per frame: seconds, loss, avg_path, zclp,
    epsilon after it, moved: the largest change of any weight in it, and
    for the wavefront loss_rel, iterations, phase widths and iterations),
    and the trained "net" and "opt_state"; of pretrained the frame's aux
    and "seconds"; of distill "history" (epoch, train loss, test MSE)."""
    from rlrpt_tpu_torch.config import DeepLearningConfig, TrainerConfig
    from rlrpt_tpu_torch.deep.neural_q import init_neural_q
    from rlrpt_tpu_torch.nn.adam import adam_init
    from rlrpt_tpu_torch.nn.dynet_io import load_dynet_model, save_dynet_model
    rl = RadianceVolumeConfig(grid_resolution=args.grid_resolution,
                              area_per_sample=args.area_per_sample)
    dl = DeepLearningConfig()
    gen = lambda: torch.Generator(device=device).manual_seed(  # noqa: E731
        next_seed())

    def save_model(net):
        if args.save_model:
            save_dynet_model(net, args.save_model)
            print(f"saved {args.save_model}")

    if args.mode == "distill":
        from rlrpt_tpu_torch.deep.distill import distill
        if not (args.load_q and args.vertices):
            raise ValueError("distill needs --load-q and --vertices")
        net, history = distill(args.load_q, args.vertices,
                               TrainerConfig(epochs=args.epochs),
                               seed=next_seed(), verbose=True, device=device)
        save_model(net)
        return None, {"history": history, "net": net}

    if args.model:
        net, opt_state = load_dynet_model(args.model, device=device), None
    else:
        net, opt_state = init_neural_q(next_seed(), scene, dl,
                                       rl.grid_resolution, device)

    if args.mode == "q-probe":
        from rlrpt_tpu_torch.deep.q_probe import save_selected_q_values_nn
        if not args.probe:
            raise ValueError("q-probe needs --probe to_select.txt")
        save_selected_q_values_nn(net, scene, args.probe, args.out_probe)
        print(f"saved {args.out_probe}")
        return None, {"net": net}

    if args.mode == "pretrained":
        t0 = time.perf_counter()
        if args.impl == "wavefront":
            from rlrpt_tpu_torch.deep.deep_wavefront import \
                render_frame_pretrained_wavefront
            img, aux = render_frame_pretrained_wavefront(
                gen(), scene, camera, net, cfg, rl, dl, pix_mux=args.pix_mux,
                mlp_dtype=args.mlp_dtype)
        else:
            from rlrpt_tpu_torch.deep.pretrained import \
                render_frame_pretrained
            if args.mlp_dtype != "f32":
                raise ValueError("--mlp-dtype bf16 needs --impl wavefront")
            img, aux = render_frame_pretrained(gen(), scene, camera, net, cfg,
                                               rl, dl)
        float(aux["avg_path_length"])   # wait for the device
        return img, dict(aux, seconds=time.perf_counter() - t0)

    # neural-q: online training
    if opt_state is None:
        opt_state = adam_init(net.parameters())
    if args.impl == "wavefront":
        from rlrpt_tpu_torch.deep.deep_wavefront import \
            render_frame_neural_q_wavefront

        def frame(g, eps):
            return render_frame_neural_q_wavefront(
                g, scene, camera, net, opt_state, eps, cfg, rl, dl,
                pix_mux=args.pix_mux)
    else:
        from rlrpt_tpu_torch.deep.neural_q import render_frame_neural_q

        def frame(g, eps):
            return render_frame_neural_q(g, scene, camera, net, opt_state,
                                         eps, cfg, rl, dl)
    eps = dl.epsilon_start
    frames = []
    for fr in range(args.frames):
        before = [p.detach().clone() for p in net.parameters()]
        t0 = time.perf_counter()
        img, _, _, eps, aux = frame(gen(), eps)
        moved = max(float((p.detach() - b).abs().max())
                    for p, b in zip(net.parameters(), before))
        row = {"loss": float(aux["loss"].sum()),
               "avg_path": float(aux["avg_path_length"].reshape(-1)[-1]),
               "zclp": int(aux["zero_contribution_light_paths"].sum()),
               "epsilon": eps, "moved": moved}
        if "phase_widths" in aux:
            row.update(loss_rel=float(aux["loss_rel"]),
                       iterations=int(aux["wavefront_iterations"]),
                       phase_widths=list(aux["phase_widths"]),
                       phase_iterations=aux["phase_iterations"].tolist())
        row["seconds"] = time.perf_counter() - t0   # the reads waited
        frames.append(row)
        extra = (f"  loss_rel {row['loss_rel']:.4g}  iterations "
                 f"{row['iterations']}" if "iterations" in row else "")
        print(f"frame {fr}: loss {row['loss']:.1f}  avg_path "
              f"{row['avg_path']:.2f}  zclp {row['zclp']}  epsilon "
              f"{eps:.3f}{extra}  moved {moved:.3g}  {row['seconds']:.3f}s")
        if stats:
            # one line per spp for the lockstep (the reference protocol),
            # one per frame for the wavefront (frame totals)
            for a, lo, z in zip(aux["avg_path_length"].reshape(-1).tolist(),
                                aux["loss"].reshape(-1).tolist(),
                                aux["zero_contribution_light_paths"]
                                .reshape(-1).tolist()):
                stats.append(a, lo, z)
        save_model(net)
    return img, dict(aux, frames=frames, net=net, opt_state=opt_state)


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
    if img is None:   # q-probe, distill
        return 0
    img = img.cpu()   # waits for the device
    # the lockstep neural-q gives one value per spp: print the last
    path = (f"  avg_path_length "
            f"{float(torch.as_tensor(aux['avg_path_length']).reshape(-1)[-1]):.4f}"
            if "avg_path_length" in aux else "")
    print(f"render time {time.perf_counter() - t0:.3f}s{path}")
    save(img, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
