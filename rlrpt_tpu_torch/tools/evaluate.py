"""Thesis evaluation protocol: method-vs-method MAPE at a fixed budget
(counterpart of ``rlrpt_tpu/tools/evaluate.py``).

Reproduces the reference's headline quality experiment
(Descriptions/write_up/chapters/4_critical_evaluation.tex:47-69; metric
Graphing/mape.py:10-21): per scene, render a high-spp ground truth once,
then equal-budget test renders for

  * the default path tracer (uniform hemisphere sampling, kernel B1),
  * expected SARSA on the fine map (trained online for N frames first,
    the regenerative wavefront on kernel B4a, or B4b with
    ``--sarsa-hit-mode f32``), its map baked into the guided megakernel
    (B3), and the binned in-kernel learner (B2, then B3),
  * neural-Q (an MLP trained online for N frames, then an inference
    render),

and score each against the GT with the reference's MAPE.  The thesis
protocol is a 4096-spp GT against 128-spp tests at 720x720; every knob is
a flag, so the same harness runs as a small CPU test.  The flags, rows,
row keys, chunk sizes and the rounding of the equal-time spp are the JAX
tool's.

Seeds.  Where the JAX tool keys a render with
``jax.random.fold_in(key, n)``, this one takes ``fold_in(seed, n)``, an
int: the megakernels' seed, and the seed of the torch.Generator of a
torch loop (the wavefronts make their generator from it on their
device).  The stream numbers n are the JAX tool's, so every render has
its own stream; images differ from the JAX tool's (both are unbiased).

The guided rows run where the scene's padded triangle count fits one
chunk (``t_pad <= T_CHUNK``, 256), as in the JAX tool, so both give the
same rows on the same scene; B3 itself takes larger scenes.  The JAX
tool's hit precision ("highest"/"high3") has no counterpart: the port's
hits are exact f32.

Usage:
  python -m rlrpt_tpu_torch.tools.evaluate [--size 720] [--gt-spp 4096]
      [--spp 128] [--sarsa-frames 10] [--nq-frames 8] [--out EVAL.json]
      [--gt-cache-dir artifacts/gt_cache] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from rlrpt_tpu_torch.config import (DeepLearningConfig, RadianceVolumeConfig,
                                    RenderConfig)
from rlrpt_tpu_torch.utils.image import mape_score, write_png
from rlrpt_tpu_torch.utils.profiling import host_fence
from rlrpt_tpu_torch.utils.rng import fold_in

PROTOCOL = "thesis MAPE (4_critical_evaluation.tex:47-69)"
SEED = 1984         # the JAX tool's root key, jax.random.PRNGKey(1984)


def _split_chunks(total: int, chunk: int) -> list:
    """Chunk sizes covering `total` exactly (final chunk may be partial)."""
    out = []
    while total > 0:
        out.append(min(chunk, total))
        total -= out[-1]
    return out


def _mape(img, gt):
    """Reference MAPE between [0,1] float images (Graphing/mape.py:10-21
    operates on 8-bit values scaled back to [0,1]; match that exactly by
    quantising both sides)."""
    host = lambda a: np.asarray(  # noqa: E731
        a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a)
    a = np.round(np.clip(host(img), 0.0, 1.0) * 255.0)
    b = np.round(np.clip(host(gt), 0.0, 1.0) * 255.0)
    return mape_score(b, a)


def gt_cache_name(scene: str, size: int, gt_spp: int, bounces: int,
                  russian_roulette: bool = False) -> str:
    """The JAX tool's ground-truth file name, so either package reads the
    other's cache: gt_{scene}_{size}_{gt_spp}_{bounces}[_rr].npz."""
    return (f"gt_{scene}_{size}_{gt_spp}_{bounces}"
            f"{'_rr' if russian_roulette else ''}.npz")


def render_gt(scene, cam, *, size: int, gt_spp: int, bounces: int, seed: int,
              device):
    """The ground truth: B1 frames of <= 256 spp (streams 999 + c),
    averaged with their spp as weights and fenced per chunk.  Returns an
    (H, W, 3) float32 tensor on ``device``."""
    from rlrpt_tpu_torch.ops.megakernel import render_default_mega

    acc = None
    for c, cs in enumerate(_split_chunks(gt_spp, 256)):
        img, _ = render_default_mega(
            fold_in(seed, 999 + c), scene, cam,
            RenderConfig(width=size, height=size, samples_per_pixel=cs,
                         max_ray_bounces=bounces), device)
        acc = img * cs if acc is None else acc + img * cs
        host_fence(acc)
    return acc / gt_spp


def load_gt(path: str) -> np.ndarray:
    with np.load(path) as z:
        return np.asarray(z["gt"], np.float32)


def save_gt(path: str, gt) -> None:
    """Write a GT cache file; an existing file is never overwritten (the
    open fails instead)."""
    with open(path, "xb") as f:
        np.savez_compressed(f, gt=np.asarray(gt.detach().cpu().numpy()
                                             if isinstance(gt, torch.Tensor)
                                             else gt, np.float32))


def evaluate_scene(scene, cam, *, size, gt_spp, spp, bounces, sarsa_frames,
                   sarsa_spp, nq_frames, nq_spp, area_per_sample, device,
                   seed, out_prefix=None, skip_nq=False, skip_sarsa=False,
                   nq_impl="wavefront", russian_roulette=False,
                   sarsa_search="table", nq_train_batching="minibatch",
                   sarsa_defensive_mix=0.0, sarsa_hit_mode="mxu",
                   nq_eps_start=0.05, guided=True, guided_uv_bins=4,
                   guided_sector_grid=11, budget_sec=0.0,
                   gt_cache: str | None = None):
    """Returns a list of result-row dicts for one scene, rendered on
    ``device`` (the kernels on a CUDA device, their plain twins on the
    CPU); ``seed`` is the int that every stream folds in.

    `russian_roulette=True` enables RR on every NON-GT render (method and
    default test renders alike — RR is unbiased, so the GT stays plain;
    BASELINE.json config #3: door_room 'RL + Russian roulette')."""
    from rlrpt_tpu_torch.ops.megakernel import render_default_mega

    device = torch.device(device)
    scene = scene.to(device)
    rows = []
    rl = RadianceVolumeConfig(area_per_sample=area_per_sample,
                              defensive_mix=sarsa_defensive_mix)
    mk_cfg = lambda s: RenderConfig(  # noqa: E731
        width=size, height=size, samples_per_pixel=s, max_ray_bounces=bounces,
        russian_roulette=russian_roulette)
    key = lambda n: fold_in(seed, n)  # noqa: E731

    def clock(fn, warm=None):
        """Time fn(); if `warm` is given, run-and-fence it first so the
        timed region excludes first-use set-up (a kernel build)."""
        if warm is not None:
            host_fence(warm())
        t0 = time.perf_counter()
        out = fn()
        host_fence(out)
        return out, time.perf_counter() - t0

    def chunked(render, total, chunk, first):
        """The spp-weighted mean of render(stream, cs) over chunks of
        `total` spp, stream `first` + c for chunk c, fenced per chunk."""
        acc = None
        for c, cs in enumerate(_split_chunks(total, chunk)):
            img = render(key(first + c), cs)
            acc = img * cs if acc is None else acc + img * cs
            host_fence(acc)
        return acc / total

    def default_frame(k, cs):
        return render_default_mega(k, scene, cam, mk_cfg(cs), device)[0]

    # ---- ground truth ----------------------------------------------------
    if gt_cache and os.path.exists(gt_cache):
        gt = torch.from_numpy(load_gt(gt_cache))
        gt_dt = 0.0
    else:
        gt, gt_dt = clock(lambda: render_gt(
            scene, cam, size=size, gt_spp=gt_spp, bounces=bounces, seed=seed,
            device=device))
        if gt_cache:
            save_gt(gt_cache, gt)
    if out_prefix:
        write_png(f"{out_prefix}_gt.png", gt)

    # ---- default tracer @ test budget ------------------------------------
    img_d, d_dt = clock(lambda: default_frame(key(1), spp),
                        warm=lambda: default_frame(key(2), spp))
    rows.append({"method": "default", "spp": spp,
                 "mape": round(_mape(img_d, gt), 4),
                 "render_sec": round(d_dt, 2)})
    if out_prefix:
        write_png(f"{out_prefix}_default.png", img_d)

    # ---- expected SARSA: train N frames, then the test render ------------
    if not skip_sarsa:
        from rlrpt_tpu_torch.integrators.sarsa_wavefront import (
            render_frame_sarsa_wavefront)
        from rlrpt_tpu_torch.radiance.volumes import build_radiance_volumes

        vols = build_radiance_volumes(scene, rl)
        if sarsa_search == "table":
            from rlrpt_tpu_torch.radiance.grid_bucket import (
                build_volume_class_table)
            grid = build_volume_class_table(vols, scene)
        else:
            from rlrpt_tpu_torch.radiance.grid_bucket import build_volume_grid
            grid = build_volume_grid(vols)

        def sarsa_frame(k, v, cs):
            return render_frame_sarsa_wavefront(
                k, scene, cam, v, grid, mk_cfg(cs), rl, pix_mux=4,
                hit_mode=sarsa_hit_mode)

        t0 = time.perf_counter()
        # Training frames chunk at <=8 spp as in the JAX tool: the total
        # training budget is unchanged, the CDF rebuild runs per chunk.
        tr_chunks = _split_chunks(sarsa_spp, 8)
        for f in range(sarsa_frames):
            for c, cs in enumerate(tr_chunks):
                _, vols, _ = sarsa_frame(key(100 + f * len(tr_chunks) + c),
                                         vols, cs)
                host_fence(vols.q)
        s_train_dt = time.perf_counter() - t0

        # Chunked test render; learning continues across chunks exactly as
        # the reference's test render keeps learning through its frame.
        def render_sarsa_test():
            state = {"v": vols}

            def chunk(k, cs):
                img, state["v"], _ = sarsa_frame(k, state["v"], cs)
                return img
            return chunked(chunk, spp, 16, 2000)

        img_s, s_dt = clock(render_sarsa_test)
        rows.append({"method": "sarsa", "spp": spp,
                     "mape": round(_mape(img_s, gt), 4),
                     "train_frames": sarsa_frames, "train_spp": sarsa_spp,
                     "n_volumes": int(vols.n_volumes),
                     "search": sarsa_search,
                     "defensive_mix": sarsa_defensive_mix,
                     "hit_mode": sarsa_hit_mode,
                     "train_sec": round(s_train_dt, 2),
                     "render_sec": round(s_dt, 2)})
        if out_prefix:
            write_png(f"{out_prefix}_sarsa.png", img_s)

        # ---- guided megakernel: frozen trained map, in-kernel sampling --
        # Bake the trained map, render the test budget with B3, then give
        # the DEFAULT megakernel the guided row's wall-clock and score
        # both: the reference's "+20% overhead" claim surface
        # (4_critical_evaluation.tex:272) measured end to end.
        from rlrpt_tpu_torch.ops.megakernel import T_CHUNK, _t_pad
        t_pad = _t_pad(scene.n_triangles)
        if guided and t_pad <= T_CHUNK:
            from rlrpt_tpu_torch.ops.guided_mega import render_guided_mega
            from rlrpt_tpu_torch.radiance.bake import bake_tri_bin_cdf
            t0 = time.perf_counter()
            table = bake_tri_bin_cdf(scene, vols, rl, t_pad,
                                     uv_bins=guided_uv_bins,
                                     sector_grid=guided_sector_grid)
            host_fence(table.cdf)
            bake_dt = time.perf_counter() - t0

            def guided_frame(tb):
                return lambda k, cs: render_guided_mega(
                    k, scene, cam, tb, mk_cfg(cs), device)[0]

            img_g, g_dt = clock(
                lambda: chunked(guided_frame(table), spp, 32, 4000),
                warm=lambda: guided_frame(table)(
                    key(4900), _split_chunks(spp, 32)[0]))
            rows.append({"method": "sarsa_guided", "spp": spp,
                         "mape": round(_mape(img_g, gt), 4),
                         "train_frames": sarsa_frames,
                         "train_spp": sarsa_spp,
                         "train_sec": round(s_train_dt, 2),
                         "bake_sec": round(bake_dt, 2),
                         "uv_bins": guided_uv_bins,
                         "sector_grid": guided_sector_grid,
                         "render_sec": round(g_dt, 2),
                         "render_sec_ratio_vs_default":
                             round(g_dt / max(d_dt, 1e-9), 3)})
            if out_prefix:
                write_png(f"{out_prefix}_sarsa_guided.png", img_g)

            # Equal-wall-clock default: same budget as the guided render.
            eq_spp = max(1, int(round(g_dt / max(d_dt / spp, 1e-9))))
            if eq_spp > 128:          # full chunks only; rounding UP
                eq_spp = -(-eq_spp // 128) * 128   # favours the default
                # comparator, the conservative direction
            img_e, e_dt = clock(
                lambda: chunked(default_frame, eq_spp, 128, 5000))
            rows.append({"method": "default_eqtime", "spp": eq_spp,
                         "mape": round(_mape(img_e, gt), 4),
                         "render_sec": round(e_dt, 2),
                         "matched_to": "sarsa_guided",
                         "time_budget_sec": round(g_dt, 2)})

            # ---- the in-kernel pipeline: binned-SARSA learning frames
            # (B2) + the guided render (B3), the sarsa row's training
            # budget.
            from rlrpt_tpu_torch.ops.guided_mega_train import (
                init_bin_q, rebuild_bin_cdf, render_sarsa_mega_train)
            gr = guided_sector_grid
            rl_k = dataclasses.replace(rl, grid_resolution=gr)
            q_b, vis_b = init_bin_q(t_pad, guided_uv_bins, gr,
                                    rl_k.initial_radiance, device=device)

            def rebuild(q):
                return rebuild_bin_cdf(q, gr, guided_uv_bins, t_pad,
                                       rl.distribution_threshold,
                                       sarsa_defensive_mix)

            def train_frame(k, tb, q, vis):
                return render_sarsa_mega_train(
                    k, scene, cam, tb, q, vis, mk_cfg(sarsa_spp),
                    rl_k.radiance_threshold, device)

            tb_k = rebuild(q_b)
            # one whole frame per launch, the CDF rebuilt per frame (the
            # reference's schedule); a discarded warm-up frame keeps
            # train_sec free of first-use set-up
            host_fence(train_frame(key(599), tb_k, q_b, vis_b)[1])
            t0 = time.perf_counter()
            for f in range(sarsa_frames):
                _, q_b, vis_b, _aux = train_frame(key(600 + f), tb_k, q_b,
                                                  vis_b)
                tb_k = rebuild(q_b)
                host_fence(q_b)
            k_train_dt = time.perf_counter() - t0

            img_k, k_dt = clock(
                lambda: chunked(guided_frame(tb_k), spp, 32, 4500))
            rows.append({"method": "sarsa_mega", "spp": spp,
                         "mape": round(_mape(img_k, gt), 4),
                         "train_frames": sarsa_frames,
                         "train_spp": sarsa_spp,
                         "train_sec": round(k_train_dt, 2),
                         "uv_bins": guided_uv_bins, "sector_grid": gr,
                         "render_sec": round(k_dt, 2),
                         "total_sec": round(k_train_dt + k_dt, 2)})
            if out_prefix:
                write_png(f"{out_prefix}_sarsa_mega.png", img_k)

            # Equal TOTAL time (training included) default render.
            eq2_spp = max(1, int(round((k_train_dt + k_dt)
                                       / max(d_dt / spp, 1e-9))))
            if eq2_spp > 128:
                eq2_spp = -(-eq2_spp // 128) * 128
            img_e2, e2_dt = clock(
                lambda: chunked(default_frame, eq2_spp, 128, 5500))
            rows.append({"method": "default_eqtotal", "spp": eq2_spp,
                         "mape": round(_mape(img_e2, gt), 4),
                         "render_sec": round(e2_dt, 2),
                         "matched_to": "sarsa_mega (train + render)",
                         "time_budget_sec": round(k_train_dt + k_dt, 2)})

            # ---- fixed WALL-CLOCK budget shootout --------------------
            # Both pipelines get `budget_sec` of total wall clock
            # (training INCLUDED for the learned side) and render 128-spp
            # frames until it runs out.
            if budget_sec and budget_sec > k_train_dt + 5.0:
                def timed_render(mk_frame, budget):
                    acc, n = None, 0
                    t0 = time.perf_counter()
                    while time.perf_counter() - t0 < budget:
                        img = mk_frame(n)
                        acc = img * 128 if acc is None else acc + img * 128
                        n += 128
                        host_fence(acc)
                    return acc / n, n, time.perf_counter() - t0

                img_b, n_b, b_dt = timed_render(
                    lambda i: guided_frame(tb_k)(key(7000 + i), 128),
                    budget_sec - k_train_dt)
                rows.append({"method": "sarsa_mega_budget", "spp": n_b,
                             "mape": round(_mape(img_b, gt), 4),
                             "budget_sec": budget_sec,
                             "train_sec": round(k_train_dt, 2),
                             "render_sec": round(b_dt, 2)})
                img_db, n_db, db_dt = timed_render(
                    lambda i: default_frame(key(8000 + i), 128), budget_sec)
                rows.append({"method": "default_budget", "spp": n_db,
                             "mape": round(_mape(img_db, gt), 4),
                             "budget_sec": budget_sec,
                             "render_sec": round(db_dt, 2)})

    # ---- neural-Q: online-train N frames, then inference render ----------
    if not skip_nq:
        from rlrpt_tpu_torch.deep.neural_q import init_neural_q

        if nq_impl == "wavefront":
            from rlrpt_tpu_torch.deep.deep_wavefront import (
                render_frame_neural_q_wavefront,
                render_frame_pretrained_wavefront as nq_inf_fn)

            def nq_train_fn(*a):
                return render_frame_neural_q_wavefront(
                    *a, train_batching=nq_train_batching)
            nq_chunk, inf_chunk = 16, 64
        else:
            from rlrpt_tpu_torch.deep.neural_q import (
                render_frame_neural_q as nq_train_fn)
            from rlrpt_tpu_torch.deep.pretrained import (
                render_frame_pretrained as nq_inf_fn)
            nq_chunk, inf_chunk = 4, 16

        dl = DeepLearningConfig()
        net, opt_state = init_neural_q(key(7), scene, dl, rl.grid_resolution,
                                       device)
        # The reference trains at CONSTANT eps = EPSILON_START = EPSILON_MIN
        # = 0.05 (deep_learning_settings.h:5-7).
        eps = nq_eps_start
        t0 = time.perf_counter()
        nq_chunks = _split_chunks(nq_spp, nq_chunk)
        for f in range(nq_frames):
            for c, cs in enumerate(nq_chunks):
                _, net, opt_state, eps, _ = nq_train_fn(
                    key(200 + f * len(nq_chunks) + c), scene, cam, net,
                    opt_state, eps, mk_cfg(cs), rl, dl)
                host_fence(list(net.parameters()))
        nq_train_dt = time.perf_counter() - t0

        img_n, nq_dt = clock(lambda: chunked(
            lambda k, cs: nq_inf_fn(k, scene, cam, net, mk_cfg(cs), rl,
                                    dl)[0], spp, inf_chunk, 3000))
        rows.append({"method": "neural_q", "spp": spp,
                     "mape": round(_mape(img_n, gt), 4),
                     "train_frames": nq_frames, "train_spp": nq_spp,
                     "train_sec": round(nq_train_dt, 2),
                     "render_sec": round(nq_dt, 2), "impl": nq_impl,
                     "eps_start": nq_eps_start,
                     "train_batching": nq_train_batching})
        if out_prefix:
            write_png(f"{out_prefix}_neural_q.png", img_n)

    for r in rows:
        r["gt_spp"] = gt_spp
        r["gt_render_sec"] = round(gt_dt, 2)
        r["size"] = size
        r["bounces"] = bounces
        if russian_roulette:
            r["russian_roulette"] = True
    return rows


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="cornell")
    ap.add_argument("--size", type=int, default=720)
    ap.add_argument("--gt-spp", type=int, default=4096)
    ap.add_argument("--spp", type=int, default=128)
    ap.add_argument("--bounces", type=int, default=80)
    ap.add_argument("--sarsa-frames", type=int, default=10)
    ap.add_argument("--sarsa-spp", type=int, default=32)
    ap.add_argument("--nq-frames", type=int, default=8)
    ap.add_argument("--nq-spp", type=int, default=8)
    ap.add_argument("--area-per-sample", type=float, default=0.001)
    ap.add_argument("--skip-nq", action="store_true")
    ap.add_argument("--skip-sarsa", action="store_true")
    ap.add_argument("--nq-impl", choices=("wavefront", "lockstep"),
                    default="wavefront")
    ap.add_argument("--russian-roulette", action="store_true",
                    help="RR on all non-GT renders (BASELINE config #3)")
    ap.add_argument("--sarsa-search", choices=("table", "grid"),
                    default="table")
    ap.add_argument("--nq-train-batching", choices=("minibatch", "fused"),
                    default="minibatch")
    ap.add_argument("--sarsa-defensive-mix", type=float, default=0.0,
                    help="blend mix*uniform into the sector CDF "
                         "(defensive importance sampling; 0 = reference)")
    ap.add_argument("--gt-cache-dir", default=None,
                    help="cache the ground truth per (scene,size,spp,"
                         "bounces) as .npz here (the JAX tool's file names; "
                         "an existing file is read, never overwritten)")
    ap.add_argument("--budget-sec", type=float, default=60.0,
                    help="fixed wall-clock budget for the train+render "
                         "vs default shootout rows (0 = skip)")
    ap.add_argument("--skip-guided", action="store_true",
                    help="skip the guided-megakernel + equal-wall-clock "
                         "rows (they run whenever sarsa runs and the "
                         "scene fits one triangle chunk)")
    ap.add_argument("--guided-uv-bins", type=int, default=4)
    ap.add_argument("--guided-sector-grid", type=int, default=11)
    ap.add_argument("--nq-eps-start", type=float, default=0.05,
                    help="neural-Q initial epsilon (the reference runs "
                         "CONSTANT 0.05, deep_learning_settings.h:5-7)")
    ap.add_argument("--sarsa-hit-mode", choices=("mxu", "f32"),
                    default="mxu",
                    help="the fine map's hit: mxu = kernel B4a with the "
                         "material row, f32 = kernel B4b and gathers (both "
                         "exact f32 here)")
    ap.add_argument("--append", action="store_true",
                    help="merge rows into an existing --out file, "
                         "replacing rows with the same (scene, method)")
    ap.add_argument("--out", default="EVAL.json")
    ap.add_argument("--out-prefix", default=None,
                    help="if set, write PNGs <prefix>_{gt,default,...}.png")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda runs the CUDA kernels, cpu "
                         "their plain torch twins")
    return ap


def main(argv=None):
    from rlrpt_tpu_torch.camera import Camera
    from rlrpt_tpu_torch.scene import presets

    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        from rlrpt_tpu_torch import _cuda
        _cuda.library()      # build the kernels before any clock starts
    p = presets.get(args.scene)
    scene = p.load(device=device)
    cam = Camera.create(p.camera_position)

    rows = evaluate_scene(
        scene, cam, size=args.size, gt_spp=args.gt_spp, spp=args.spp,
        bounces=args.bounces, sarsa_frames=args.sarsa_frames,
        sarsa_spp=args.sarsa_spp, nq_frames=args.nq_frames,
        nq_spp=args.nq_spp, area_per_sample=args.area_per_sample,
        device=device, seed=SEED,
        out_prefix=args.out_prefix, skip_nq=args.skip_nq,
        skip_sarsa=args.skip_sarsa, nq_impl=args.nq_impl,
        russian_roulette=args.russian_roulette,
        sarsa_search=args.sarsa_search,
        nq_train_batching=args.nq_train_batching,
        sarsa_defensive_mix=args.sarsa_defensive_mix,
        sarsa_hit_mode=args.sarsa_hit_mode,
        nq_eps_start=args.nq_eps_start, guided=not args.skip_guided,
        guided_uv_bins=args.guided_uv_bins,
        guided_sector_grid=args.guided_sector_grid,
        budget_sec=args.budget_sec,
        gt_cache=(os.path.join(args.gt_cache_dir, gt_cache_name(
            args.scene, args.size, args.gt_spp, args.bounces,
            args.russian_roulette)) if args.gt_cache_dir else None))
    for r in rows:
        r["scene"] = args.scene
    result = {"protocol": PROTOCOL, "backend": device.type,
              "device": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
              "rows": rows}
    if args.append and os.path.exists(args.out):
        with open(args.out) as f:
            old = json.load(f)
        # Preserve any top-level keys a previous run added (e.g. "notes").
        for k, v in old.items():
            if k not in ("rows", "protocol", "backend", "device"):
                result[k] = v
        new_keys = {(r["scene"], r["method"]) for r in rows}
        kept = [r for r in old.get("rows", [])
                if (r.get("scene"), r.get("method")) not in new_keys]
        result["rows"] = kept + rows
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
