"""Smoke test of the rlrpt_tpu_torch port on one NVIDIA card (H100).

    python3 chip_smoke.py [--out DIR]

Builds the CUDA kernels from rlrpt_tpu_torch/csrc, holds each against its
plain torch twin on the card (at small extra cases and at the main path's
shapes) and times both at the main path's shapes, then
drives the main path through the entry points a user calls — the default
megakernel at the bench point (Cornell 720x720, 1 spp, 80-bounce cap) and
``tools/render.py --mode sarsa-mega --frames 0`` plus ``--mode mega`` at
720x720, 32 spp — and checks that every kernel of that path launched.

Prints one line per phase; then the card line, one JSON line describing
the kernels, and as the last line {"ok": true, "device": {...}}.  Any
failure raises, exits non-zero and prints no result.  Images and a
results.json go to --out (default build/smoke/).  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CAM = (0.0, 0.0, -3.0)
TOL = "99% of pixels within atol 1e-4 rtol 1e-3; mean 0.5%; avg path 1%"


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    """A failed check ends the run (kept under `python -O`, unlike assert)."""
    if not bool(ok):
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def compare(name: str, kernel_out, twin_out, cfg) -> float:
    """Kernel vs twin frame at the test tolerance; returns the largest
    absolute pixel error.  Built without FMA contraction the kernel rounds
    as the twin does, so the frames are expected to be bit-identical; the
    gate is the tolerance the CPU tests hold the twin to against JAX."""
    from rlrpt_tpu_torch.ops.megakernel import assemble
    torch.cuda.synchronize()
    img_k, aux_k = assemble(*kernel_out, cfg)
    img_p, aux_p = assemble(*twin_out, cfg)
    check(torch.isfinite(img_k).all(), f"{name}: non-finite pixels")
    close = torch.isclose(img_k, img_p, atol=1e-4, rtol=1e-3).all(-1)
    frac = float(close.float().mean())
    equal = float((img_k == img_p).all(-1).float().mean())
    mk_, mp = float(img_k.mean()), float(img_p.mean())
    ak, ap = float(aux_k["avg_path_length"]), float(aux_p["avg_path_length"])
    err = float((img_k - img_p).abs().max())
    log(f"  {name}: {frac:.4%} of pixels within tolerance ({equal:.4%} "
        f"bit-equal), mean {mk_:.6f} vs {mp:.6f}, avg path {ak:.4f} vs "
        f"{ap:.4f}, max abs err {err:.3g}")
    check(frac >= 0.99, f"{name}: only {frac:.4%} of pixels agree")
    check(abs(mk_ - mp) <= 0.005 * mp, f"{name}: frame means differ")
    check(abs(ak - ap) <= 0.01 * ap, f"{name}: path lengths differ")
    return err


def clutter_scene(device):
    """The Cornell box plus 250 small random triangles (numpy seed 7):
    288 triangles, two shared-memory tiles of 256 in the kernels."""
    from rlrpt_tpu_torch.scene import build_scene, cornell_box
    c = cornell_box()
    ns = c.n_surfaces
    rng = np.random.default_rng(7)
    cen = rng.uniform(-0.9, 0.9, (250, 3)).astype(np.float32)
    tri = cen[:, None, :] + rng.normal(0, 0.03, (250, 3, 3)).astype(
        np.float32)
    rgb = rng.uniform(0.1, 0.9, (250, 3)).astype(np.float32)
    a = lambda t: t.numpy()  # noqa: E731
    return build_scene(
        np.concatenate([a(c.v0)[:ns], tri[:, 0]]),
        np.concatenate([a(c.v1)[:ns], tri[:, 1]]),
        np.concatenate([a(c.v2)[:ns], tri[:, 2]]),
        np.concatenate([a(c.diffuse_c)[:ns], rgb]),
        a(c.v0)[ns:], a(c.v1)[ns:], a(c.v2)[ns:], a(c.emission)[ns:],
        device=device)


def skewed_table(device, skew: float):
    """The initial binned Q (Cornell, 11x11 sectors, uv_bins 4) skewed per
    entry by exp(skew * U[0, 1)) from numpy seed 3, rebuilt to a CDF."""
    from rlrpt_tpu_torch.ops.guided_mega_train import (init_bin_q,
                                                       rebuild_bin_cdf)
    q, _ = init_bin_q(40, 4, 11, 100.0 / 121)
    u = np.random.default_rng(3).random(q.shape)
    q = q * torch.from_numpy(np.exp(skew * u).astype(np.float32))
    return rebuild_bin_cdf(q.to(device), 11, 4, 40)


def host_ms(fn):
    """(host time of one fn() call in ms, its result)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=ROOT / "build" / "smoke",
                        help="directory for the images and results.json")
    out_dir = parser.parse_args(argv).out
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card: "
                         "torch.cuda.is_available() is false")
    from rlrpt_tpu_torch import _cuda
    from rlrpt_tpu_torch.camera import Camera
    from rlrpt_tpu_torch.config import RenderConfig
    from rlrpt_tpu_torch.ops import guided_mega as gm
    from rlrpt_tpu_torch.ops import megakernel as mk
    from rlrpt_tpu_torch.scene import cornell_box
    from rlrpt_tpu_torch.tools import render
    from rlrpt_tpu_torch.tools.mega_sweep import kernel_ms
    from rlrpt_tpu_torch.utils.image import mape_score, tonemap, write_png

    dev = torch.device("cuda")
    card = card_line()
    out_dir.mkdir(parents=True, exist_ok=True)

    # ---- 1: card, versions, kernel build -------------------------------
    log(f"[1] card: {card}")
    log(f"[1] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _cuda.library()
    log(f"[1] kernels built from {_cuda.CSRC.relative_to(ROOT)} in "
        f"{time.perf_counter() - t0:.2f} s (nvcc "
        f"{_cuda.BuildInfo.seconds if _cuda.BuildInfo.seconds is not None else 'cached'}"
        f" s) -> {_cuda.BuildInfo.path.name}")
    for line in _cuda.BuildInfo.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[1]   ptxas: {line.strip()}")

    cam = mk.camera_vector(Camera.create(CAM))
    tris, mat = mk.pack_scene(cornell_box(device=dev))

    # ---- 2: B1 kernel vs twin ------------------------------------------
    log(f"[2] B1 mega_default vs its torch twin ({TOL})")
    b1_err = 0.0
    for label, scene_tables, rr in (
            ("cornell 64x64 4spp rr off", (tris, mat), False),
            ("cornell 64x64 4spp rr on", (tris, mat), True),
            ("cornell+250 tris 64x64 4spp",
             mk.pack_scene(clutter_scene(dev)), False)):
        cfg = RenderConfig(width=64, height=64, samples_per_pixel=4,
                           max_ray_bounces=10, russian_roulette=rr)
        n_slots = mk.n_slots_for(cfg.n_pixels, 128, 4)
        before = mk.KERNEL.launches
        k_out = mk.mega_default_frame(20240, cam, *scene_tables, cfg,
                                      n_slots, 4)
        check(mk.KERNEL.launches == before + 1, "B1 launch not counted")
        p_out = mk.mega_default_frame_plain(20240, cam, *scene_tables, cfg,
                                            n_slots, 4)
        b1_err = max(b1_err, compare(label, k_out, p_out, cfg))

    # ---- 3: B3 kernel vs twin ------------------------------------------
    log(f"[3] B3 mega_guided vs its torch twin ({TOL})")
    b3_err = 0.0
    cfg = RenderConfig(width=64, height=64, samples_per_pixel=4,
                       max_ray_bounces=10)
    n_slots = mk.n_slots_for(cfg.n_pixels, 128, 1)
    for label, skew in (("initial table", 0.0), ("skewed table", 3.0)):
        cdf_t = skewed_table(dev, skew).cdf.T.contiguous()
        before = gm.KERNEL.launches
        k_out = gm.mega_guided_frame(777, cam, tris, mat, cdf_t, 11, 4, cfg,
                                     n_slots, 1)
        check(gm.KERNEL.launches == before + 1, "B3 launch not counted")
        p_out = gm.mega_guided_frame_plain(777, cam, tris, mat, cdf_t, 11, 4,
                                           cfg, n_slots, 1)
        b3_err = max(b3_err, compare(label, k_out, p_out, cfg))

    # ---- kernel vs twin, output and time, at the main path's shapes -----
    # (r_tile R_TILE, pix_mux PIX_MUX as render_default_mega and
    # render_guided_mega launch them; the initial 11x11 / uv 4 table)
    log(f"[4] B1 and B3 vs their twins at the main path's shapes ({TOL})")
    bench = RenderConfig(width=720, height=720, samples_per_pixel=1,
                         max_ray_bounces=80)
    n_slots = mk.n_slots_for(bench.n_pixels, mk.R_TILE, mk.PIX_MUX)
    b1_main = lambda: mk.mega_default_frame(  # noqa: E731
        5, cam, tris, mat, bench, n_slots, mk.PIX_MUX)
    b1_plain_ms, b1_plain_out = host_ms(lambda: mk.mega_default_frame_plain(
        5, cam, tris, mat, bench, n_slots, mk.PIX_MUX))
    b1_err = max(b1_err, compare("B1 cornell 720x720 1spp 80 bounces",
                                 b1_main(), b1_plain_out, bench))
    b1_ms = kernel_ms(b1_main, 20)
    log(f"[4] B1 at 720x720 1spp 80 bounces: kernel {b1_ms:.4f} ms, "
        f"torch twin {b1_plain_ms:.1f} ms")
    sarsa = RenderConfig(width=720, height=720, samples_per_pixel=32,
                         max_ray_bounces=80)
    cdf_t = skewed_table(dev, 0.0).cdf.T.contiguous()
    b3_main = lambda: gm.mega_guided_frame(  # noqa: E731
        6, cam, tris, mat, cdf_t, 11, 4, sarsa, n_slots, mk.PIX_MUX)
    b3_plain_ms, b3_plain_out = host_ms(lambda: gm.mega_guided_frame_plain(
        6, cam, tris, mat, cdf_t, 11, 4, sarsa, n_slots, mk.PIX_MUX))
    b3_err = max(b3_err, compare("B3 initial table 720x720 32spp 80 bounces",
                                 b3_main(), b3_plain_out, sarsa))
    b3_ms = kernel_ms(b3_main, 5)
    log(f"[4] B3 at 720x720 32spp 80 bounces: kernel {b3_ms:.3f} ms, "
        f"torch twin {b3_plain_ms:.1f} ms")

    # ---- the main path, counted from zero -------------------------------
    mk.KERNEL.launches = 0
    gm.KERNEL.launches = 0

    # 4: the bench point through the user entry point
    scene = cornell_box(device=dev)
    camera = Camera.create(CAM)
    for i in range(3):
        mk.render_default_mega(1000 + i, scene, camera, bench, dev)
    torch.cuda.synchronize()
    trials = []
    for trial in range(5):
        reps = 10
        paths = torch.zeros((), dtype=torch.float64, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(reps):
            img, aux = mk.render_default_mega(trial * reps + i, scene,
                                              camera, bench, dev)
            paths += aux["avg_path_length"]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rays = float(paths) * bench.n_pixels * bench.samples_per_pixel
        trials.append(rays / dt)
        log(f"[4] trial {trial}: {trials[-1] / 1e9:.4f} G rays/s "
            f"({dt / reps * 1e3:.4f} ms/frame)")
    check(bool(torch.isfinite(img).all()) and float(img.mean()) > 0.0,
          "the bench frame is not finite and lit")
    rays_per_s = statistics.median(trials)
    log(f"[4] bench point rays/s (median of 5): {rays_per_s:.6g} "
        f"on {card}")

    # 5: the CLI pipeline, sarsa-mega --frames 0 vs mega at 32 spp
    common = ["--width", "720", "--height", "720", "--spp", "32",
              "--device", "cuda", "--seed", "1984"]
    imgs, secs = {}, {}
    for mode in ("sarsa-mega", "mega"):
        argv = ["--mode", mode, *common]
        if mode == "sarsa-mega":
            argv += ["--frames", "0"]
        args = render.build_parser().parse_args(argv)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, aux = render.render(args)
        torch.cuda.synchronize()
        secs[mode] = time.perf_counter() - t0
        check(img.shape == (720, 720, 3),
              f"{mode}: image shape {tuple(img.shape)}")
        check(torch.isfinite(img).all(), f"{mode}: non-finite pixels")
        check(float(img.max()) > 0.0, f"{mode}: black image")
        imgs[mode] = img.cpu()
        write_png(str(out_dir / f"{mode}.png"), imgs[mode])
        log(f"[5] {mode} 720x720 32spp: {secs[mode]:.4f} s, mean "
            f"{float(img.mean()):.6f}, avg path "
            f"{float(aux['avg_path_length']):.4f}")
    mape = mape_score(tonemap(imgs["mega"]), tonemap(imgs["sarsa-mega"]))
    mg, mm = float(imgs["sarsa-mega"].mean()), float(imgs["mega"].mean())
    log(f"[5] MAPE(sarsa-mega vs mega, equal spp) {mape}; frame means "
        f"{mg:.6f} vs {mm:.6f}")
    # The initial table weights sectors by Q*cos (close to cosine-weighted
    # sampling), so path lengths differ from the uniform default; both
    # estimators are unbiased, so the frame means agree within MC noise
    # (about 0.1% at 16.6M samples).
    check(abs(mg - mm) <= 0.02 * mm, "sarsa-mega and mega means differ")

    launches = {"B1": mk.KERNEL.launches, "B3": gm.KERNEL.launches}
    log(f"[5] main-path launches: {launches}")
    check(all(n > 0 for n in launches.values()),
          f"a main-path kernel never launched: {launches}")

    results = {"kernels": [
        {"name": "B1 mega_default", "route": "cuda",
         "source": "rlrpt_tpu_torch/csrc/mega_default.cu",
         "replaces": "rlrpt_tpu/ops/megakernel.py:247",
         "launches": launches["B1"], "max_abs_err": b1_err,
         "ms": b1_ms, "plain_ms": b1_plain_ms},
        {"name": "B3 mega_guided", "route": "cuda",
         "source": "rlrpt_tpu_torch/csrc/mega_guided.cu",
         "replaces": "rlrpt_tpu/ops/guided_mega.py:137",
         "launches": launches["B3"], "max_abs_err": b3_err,
         "ms": b3_ms, "plain_ms": b3_plain_ms},
    ]}
    (out_dir / "results.json").write_text(json.dumps({
        **results, "card": card, "rays_per_s": rays_per_s,
        "rays_per_s_trials": trials, "cli_seconds": secs, "mape": mape},
        indent=1))
    print(card)
    print(json.dumps(results))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
