"""Smoke test of the rlrpt_tpu_torch port on one NVIDIA card (H100).

    python3 chip_smoke.py [--out DIR]

Builds the CUDA kernels from rlrpt_tpu_torch/csrc, holds each against its
plain torch twin on the card (at small extra cases and at the main path's
shapes) and times both at the main path's shapes, then drives each path
through the entry points a user calls, with every launch count set to 0
just before it and read just after:

* the default megakernel at the bench point (Cornell 720x720, 1 spp,
  80-bounce cap): B1;
* ``tools/render.py --mode sarsa-mega --frames 0`` and ``--mode mega`` at
  720x720, 32 spp: B3, B1;
* the learning path, ``--mode sarsa-mega --frames 10 --spp 32`` at
  720x720 (the EVAL protocol): B2, then B3;
* the wavefront path, ``--mode wavefront`` (B4a) and
  ``render_wavefront(hit_mode="f32")`` (B4b) at 720x720, 32 spp;
* ``closest_hit_packed_mxu`` (B4c) on 518,400 camera rays and a bounce
  batch: no integrator of either package calls it, so its public launcher
  is its path.

Fails if a kernel of a path was never launched in it.  Prints one line per
phase; then the card line, one JSON line describing the kernels, and as
the last line {"ok": true, "device": {...}}.  Any failure raises, exits
non-zero and prints no result.  Images and a results.json go to --out
(default build/smoke/).  Imports nothing of JAX.
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


def skewed_q(device, skew: float):
    """The initial binned Q (Cornell, 11x11 sectors, uv_bins 4) skewed per
    entry by exp(skew * U[0, 1)) from numpy seed 3."""
    from rlrpt_tpu_torch.ops.guided_mega_train import init_bin_q
    q, _ = init_bin_q(40, 4, 11, 100.0 / 121)
    u = np.random.default_rng(3).random(q.shape)
    return (q * torch.from_numpy(np.exp(skew * u).astype(np.float32))).to(
        device)


def skewed_table(device, skew: float):
    """skewed_q rebuilt to a CDF."""
    from rlrpt_tpu_torch.ops.guided_mega_train import rebuild_bin_cdf
    return rebuild_bin_cdf(skewed_q(device, skew), 11, 4, 40)


def compare_train(name: str, k_out, p_out, b3_out, q_in, v_in) -> float:
    """B2 kernel vs twin: rad, path_sum and iters bit-equal to the twin's
    and to B3's frame for the same seed and table; visits equal; q within
    rtol 1e-4 (the atomics and the irradiance sums add in another order);
    sum(V_out - V_in) == the TD scatter count on both sides.  Returns the
    largest absolute difference of the frame and of q."""
    torch.cuda.synchronize()
    names = ("rad", "path_sum", "iters")
    for n, a, b, c in zip(names, k_out[:3], p_out[:3], b3_out):
        check(torch.equal(a, b), f"{name}: {n} differs from the twin's")
        check(torch.equal(a, c), f"{name}: {n} differs from B3's frame")
    q_k, v_k, td_k = k_out[3:]
    q_p, v_p, td_p = p_out[3:]
    check(torch.equal(v_k, v_p), f"{name}: visits differ from the twin's")
    rel = float(((q_k - q_p).abs() / q_p.abs().clamp(min=1e-30)).max())
    check(bool(torch.isfinite(q_k).all()) and rel <= 1e-4,
          f"{name}: q differs from the twin's by {rel:.3g} relative")
    inv_k, inv_p = float((v_k - v_in).sum()), float((v_p - v_in).sum())
    n_k, n_p = float(td_k.double().sum()), float(td_p.double().sum())
    check(inv_k == n_k and inv_p == n_p and n_k > 0,
          f"{name}: visit invariant broken: {inv_k} vs {n_k}, {inv_p} vs "
          f"{n_p}")
    check(not torch.equal(q_k, q_in), f"{name}: q did not move")
    err = float((q_k - q_p).abs().max())
    log(f"  {name}: frame bit-equal to the twin's and B3's, visits equal, "
        f"q max rel diff {rel:.3g}, td scatters {n_k:.0f} == visit delta")
    return err


def hit_rays(device, tris, mat, gen):
    """518,400 jittered camera rays (720x720, Cornell camera) and one
    bounce ray from each camera ray's hit (uniform about the normal)."""
    from rlrpt_tpu_torch.camera import Camera, pixel_rays
    from rlrpt_tpu_torch.ops import intersect_pallas as ip
    from rlrpt_tpu_torch.ops.hemisphere import sample_uniform_direction
    jitter = torch.rand((720, 720, 2), generator=gen, device=device)
    o, d = pixel_rays(jitter, Camera.create(CAM), 720, 720, 720.0)
    o, d = o.contiguous(), d.contiguous()
    t, _, rows = ip.closest_hit_plain(o, d, tris, o.shape[0], mat)
    hit = t < 1e38
    nd, _ = sample_uniform_direction(gen, rows[:, 0:3])
    o2 = o + torch.where(hit, t, 0.0)[:, None] * d + 1e-4 * nd
    return (o, d, torch.cat([o, o2[hit]]).contiguous(),
            torch.cat([d, nd[hit]]).contiguous())


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
    from rlrpt_tpu_torch.config import RadianceVolumeConfig, RenderConfig
    from rlrpt_tpu_torch.integrators.wavefront import render_wavefront
    from rlrpt_tpu_torch.ops import guided_mega as gm
    from rlrpt_tpu_torch.ops import guided_mega_train as gt
    from rlrpt_tpu_torch.ops import intersect_pallas as ip
    from rlrpt_tpu_torch.ops import megakernel as mk
    from rlrpt_tpu_torch.ops.hemisphere import sector_cos_thetas
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

    # ---- 6: B2 vs its twin and vs B3 -----------------------------------
    log("[6] B2 mega_train vs its torch twin and B3 (frame bit-equal, "
        "visits equal, q rtol 1e-4, visit invariant exact)")
    cornell = cornell_box(device=dev)
    lum = gt.bin_luminance(cornell, 40, 4)[0].contiguous()
    sec_cos = sector_cos_thetas(11, dev).contiguous()
    rl = RadianceVolumeConfig(grid_resolution=11)
    thr = rl.radiance_threshold
    b2_err = 0.0
    n_small = mk.n_slots_for(64 * 64, 128, 1)
    for label, skew, rr in (("initial table rr off", 0.0, False),
                            ("initial table rr on", 0.0, True),
                            ("skewed table rr off", 3.0, False),
                            ("skewed table rr on", 3.0, True)):
        cfg = RenderConfig(width=64, height=64, samples_per_pixel=4,
                           max_ray_bounces=10, russian_roulette=rr)
        q_in = skewed_q(dev, skew)
        v_in = torch.from_numpy(np.random.default_rng(5).integers(
            0, 3, q_in.shape).astype(np.float32)).to(dev)
        b2_cdf = gt.rebuild_bin_cdf(q_in, 11, 4, 40).cdf.T.contiguous()
        args = (888, cam, tris, mat, b2_cdf, lum, sec_cos, q_in, v_in, 11, 4,
                thr, cfg, n_small, 1)
        before = gt.KERNEL.launches
        k_out = gt.mega_train_frame(*args)
        check(gt.KERNEL.launches == before + 1, "B2 launch not counted")
        b3_out = gm.mega_guided_frame(888, cam, tris, mat, b2_cdf, 11, 4, cfg,
                                      n_small, 1)
        b2_err = max(b2_err, compare_train(
            f"cornell 64x64 4spp {label}", k_out,
            gt.mega_train_frame_plain(*args), b3_out, q_in, v_in))
    # the main path's shape: 720x720, 32 spp, 80 bounces, pix_mux 1, from
    # the initial Q and phase 4's table (its rebuild), so B3's frame there
    # is b3_main()
    q_in = skewed_q(dev, 0.0)
    v_in = torch.zeros_like(q_in)
    args = (6, cam, tris, mat, cdf_t, lum, sec_cos, q_in, v_in, 11, 4, thr,
            sarsa, n_slots, mk.PIX_MUX)
    b2_plain_ms, b2_plain_out = host_ms(
        lambda: gt.mega_train_frame_plain(*args))
    b2_err = max(b2_err, compare_train(
        "B2 initial table 720x720 32spp 80 bounces",
        gt.mega_train_frame(*args), b2_plain_out, b3_main(), q_in, v_in))
    b2_ms = kernel_ms(lambda: gt.mega_train_frame(*args), 5)
    log(f"[6] B2 at 720x720 32spp 80 bounces: {b2_ms:.3f} ms per learning "
        f"frame (CUDA events around the wrapper: its 2 launches per "
        f"iteration and the host reads of the alive flag), torch twin "
        f"{b2_plain_ms:.1f} ms; B3 at the same point {b3_ms:.3f} ms")

    # ---- 7: B4a, B4b, B4c vs their twins --------------------------------
    log("[7] B4a/b/c closest_hit vs the torch twin (t, idx and mat rows "
        "bit-equal; active_count at half the batch)")
    b4_err = dict.fromkeys(("B4a", "B4b", "B4c"), 0.0)
    b4_ms, b4_plain_ms = {}, {}
    gen = torch.Generator(device=dev).manual_seed(11)
    clutter = clutter_scene(dev)
    for scene_name, sc in (("cornell", cornell), ("clutter", clutter)):
        s_tris, s_mat = ip.pack_scene_mxu(sc)
        cam_o, cam_d, o, d = hit_rays(dev, s_tris, s_mat, gen)
        half = torch.tensor([o.shape[0] // 2], dtype=torch.int32, device=dev)
        full = torch.tensor([cam_o.shape[0]], dtype=torch.int32, device=dev)
        for name, fn, kern, tables in (
                ("B4b", ip.closest_hit_packed, ip.KERNEL_F32, (s_tris,)),
                ("B4c", ip.closest_hit_packed_mxu, ip.KERNEL_MXU, (s_tris,)),
                ("B4a", ip.closest_hit_mat_mxu, ip.KERNEL_MAT,
                 (s_tris, s_mat))):
            before = kern.launches
            k_out = fn(o, d, *tables, half)
            check(kern.launches == before + 1, f"{name} launch not counted")
            torch.cuda.synchronize()
            p_out = ip.closest_hit_plain(o, d, s_tris, int(half), *tables[1:])
            for a, b in zip(k_out, p_out):
                check(torch.equal(a, b), f"{name} {scene_name}: kernel and "
                                         "twin differ")
                b4_err[name] = max(b4_err[name], float(
                    (a.double() - b.double()).abs().max()))
            check(bool((k_out[0][int(half):] >= 1e38).all()),
                  f"{name}: a ray past active_count was traced")
            ms = kernel_ms(lambda: fn(cam_o, cam_d, *tables, full), 50)
            plain_ms, _ = host_ms(lambda: ip.closest_hit_plain(
                cam_o, cam_d, s_tris, cam_o.shape[0], *tables[1:]))
            if scene_name == "cornell":
                b4_ms[name], b4_plain_ms[name] = ms, plain_ms
            hits = float((k_out[0] < 1e38).float().mean())
            log(f"  {name} {scene_name} ({s_tris.shape[0]} triangles), "
                f"{o.shape[0]} rays, count {int(half)}: bit-equal, "
                f"{hits:.4f} hit; 518,400 camera rays: kernel {ms:.4f} ms, "
                f"torch twin {plain_ms:.1f} ms")

    # ---- the paths, each counted from zero ------------------------------
    kernels = {"B1": mk.KERNEL, "B3": gm.KERNEL, "B2": gt.KERNEL,
               "B4a": ip.KERNEL_MAT, "B4b": ip.KERNEL_F32,
               "B4c": ip.KERNEL_MXU}
    launches = dict.fromkeys(kernels, 0)

    def drive(path: str, expect, fn):
        """fn() with every count at 0; the expected kernels must launch."""
        for kern in kernels.values():
            kern.launches = 0
        out = fn()
        torch.cuda.synchronize()
        counts = {n: k.launches for n, k in kernels.items()}
        log(f"[{path}] launches: " + ", ".join(
            f"{n} {c}" for n, c in counts.items() if c))
        check(all(counts[n] > 0 for n in expect),
              f"{path}: a kernel of the path never launched: {counts}")
        for n in expect:
            launches[n] += counts[n]
        return out

    # 4: the bench point through the user entry point
    scene = cornell_box(device=dev)
    camera = Camera.create(CAM)

    def bench_point():
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
        return trials

    trials = drive("4", ("B1",), bench_point)
    rays_per_s = statistics.median(trials)
    log(f"[4] bench point rays/s (median of 5): {rays_per_s:.6g} "
        f"on {card}")

    # 5, 8, 9: the CLI at 720x720, 32 spp
    common = ["--width", "720", "--height", "720", "--spp", "32",
              "--device", "cuda", "--seed", "1984"]
    imgs, secs, auxes = {}, {}, {}

    def cli(phase: str, label: str, argv):
        args = render.build_parser().parse_args(argv + common)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, aux = render.render(args)
        torch.cuda.synchronize()
        secs[label] = time.perf_counter() - t0
        check(img.shape == (720, 720, 3),
              f"{label}: image shape {tuple(img.shape)}")
        check(torch.isfinite(img).all(), f"{label}: non-finite pixels")
        check(float(img.max()) > 0.0, f"{label}: black image")
        imgs[label], auxes[label] = img.cpu(), aux
        write_png(str(out_dir / f"{label}.png"), imgs[label])
        log(f"[{phase}] {label} 720x720 32spp: {secs[label]:.4f} s, mean "
            f"{float(img.mean()):.6f}, avg path "
            f"{float(aux['avg_path_length']):.4f}")

    drive("5", ("B3", "B1"), lambda: (
        cli("5", "sarsa-mega", ["--mode", "sarsa-mega", "--frames", "0"]),
        cli("5", "mega", ["--mode", "mega"])))
    mape = mape_score(tonemap(imgs["mega"]), tonemap(imgs["sarsa-mega"]))
    mg, mm = float(imgs["sarsa-mega"].mean()), float(imgs["mega"].mean())
    log(f"[5] MAPE(sarsa-mega vs mega, equal spp) {mape}; frame means "
        f"{mg:.6f} vs {mm:.6f}")
    # The initial table weights sectors by Q*cos (close to cosine-weighted
    # sampling), so path lengths differ from the uniform default; both
    # estimators are unbiased, so the frame means agree within MC noise
    # (about 0.1% at 16.6M samples).
    check(abs(mg - mm) <= 0.02 * mm, "sarsa-mega and mega means differ")

    # 8: the learning path, the EVAL protocol's 10 frames x 32 spp
    drive("8", ("B2", "B3"), lambda: cli(
        "8", "sarsa-mega-10", ["--mode", "sarsa-mega", "--frames", "10"]))
    aux = auxes["sarsa-mega-10"]
    frames = aux["frames"]
    for i, fr in enumerate(frames):
        log(f"[8] learning frame {i}: {fr['seconds']:.4f} s, td_scatters "
            f"{fr['td_scatters']}, avg path {fr['avg_path']:.4f}")
    td_total = sum(fr["td_scatters"] for fr in frames)
    visits = float(aux["visits"].double().sum())
    check(len(frames) == 10 and visits == td_total,
          f"learning path: visits {visits} != td scatters {td_total}")
    q = aux["q"][:121]
    moved = float((q != rl.initial_radiance).float().mean())
    check(bool(torch.isfinite(q).all()) and moved > 0.5
          and float(q.std()) > 0.01, "learning path: q did not move")
    frame_s = statistics.median(fr["seconds"] for fr in frames)
    gap = (float(imgs["sarsa-mega-10"].mean()) - mm) / mm
    log(f"[8] {frame_s:.4f} s per learning frame (median of 10), guided "
        f"render {aux['guided_seconds']:.4f} s, {secs['sarsa-mega-10']:.4f} s "
        f"in all; {moved:.4f} of q entries moved, q std "
        f"{float(q.std()):.4f}; visits == td scatters == {td_total}; "
        f"guided mean after learning vs mega: {gap:+.4%}")
    # Learned tables are skewed, and a bf16 CDF never draws a sector whose
    # probability is below its spacing (ROADMAP C): the guided frame is
    # biased low.  The same learned Q as an f32 table, rendered by B3's
    # twin, shows how much of the gap that is; it must be unbiased.
    lt = gt.rebuild_bin_cdf(aux["q"], 11, 4, 40)
    lt32 = gt.rebuild_bin_cdf(aux["q"], 11, 4, 40, dtype=torch.float32)
    zero = float(((lt.cdf[1:121].float() == lt.cdf[:120].float()).float()
                  .mean()))
    img32 = mk.assemble(*gm.mega_guided_frame_plain(
        7, cam, tris, mat, lt32.cdf.T.contiguous(), 11, 4, sarsa, n_slots,
        mk.PIX_MUX), sarsa)[0]
    gap32 = (float(img32.mean()) - mm) / mm
    log(f"[8] learned table: {zero:.4f} of sectors 2..121 have zero bf16 "
        f"probability; the same Q as an f32 table (B3's twin, 32 spp): mean "
        f"vs mega {gap32:+.4%}")
    check(abs(gap32) <= 0.02, f"the f32 learned table is biased by "
                              f"{gap32:+.2%}")
    check(abs(gap) <= 0.10, f"learned guided mean off by {gap:+.2%}")

    # 9: the wavefront path, B4a through the CLI and B4b through hit_mode
    drive("9", ("B4a",), lambda: cli("9", "wavefront",
                                      ["--mode", "wavefront"]))

    def wavefront_f32():
        t0 = time.perf_counter()
        img, aux = render_wavefront(1985, scene, camera, sarsa, dev,
                                    hit_mode="f32")
        torch.cuda.synchronize()
        secs["wavefront-f32"] = time.perf_counter() - t0
        imgs["wavefront-f32"] = img.cpu()
        log(f"[9] render_wavefront hit_mode f32: "
            f"{secs['wavefront-f32']:.4f} s, mean {float(img.mean()):.6f}, "
            f"{int(aux['wavefront_iterations'])} iterations")

    drive("9", ("B4b",), wavefront_f32)
    for label in ("wavefront", "wavefront-f32"):
        gap_w = (float(imgs[label].mean()) - mm) / mm
        log(f"[9] {label} mean vs mega: {gap_w:+.4%}")
        check(abs(gap_w) <= 0.02, f"{label} and mega means differ")

    # 10: B4c through its public launcher
    def b4c_path():
        s_tris = ip.pack_triangles(scene)
        gen = torch.Generator(device=dev).manual_seed(12)
        _, _, o, d = hit_rays(dev, s_tris, ip.pack_scene_mxu(scene)[1], gen)
        t, _ = ip.closest_hit_packed_mxu(o, d, s_tris, o.shape[0])
        check(bool((t < 1e38).float().mean() > 0.5), "B4c: few hits")

    drive("10", ("B4c",), b4c_path)

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
        {"name": "B2 mega_train", "route": "cuda",
         "source": "rlrpt_tpu_torch/csrc/mega_train.cu",
         "replaces": "rlrpt_tpu/ops/guided_mega_train.py:101",
         "launches": launches["B2"], "max_abs_err": b2_err,
         "ms": b2_ms, "plain_ms": b2_plain_ms},
    ] + [
        {"name": f"{n} {fn}", "route": "cuda",
         "source": "rlrpt_tpu_torch/csrc/closest_hit.cu",
         "replaces": f"rlrpt_tpu/ops/intersect_pallas.py:{line}",
         "launches": launches[n], "max_abs_err": b4_err[n],
         "ms": b4_ms[n], "plain_ms": b4_plain_ms[n]}
        for n, fn, line in (("B4a", "closest_hit_mat_mxu", 203),
                            ("B4b", "closest_hit_packed", 48),
                            ("B4c", "closest_hit_packed_mxu", 116))]}
    (out_dir / "results.json").write_text(json.dumps({
        **results, "card": card, "rays_per_s": rays_per_s,
        "rays_per_s_trials": trials, "cli_seconds": secs, "mape": mape,
        "learning_frames": frames, "guided_gap_after_learning": gap},
        indent=1))
    print(card)
    print(json.dumps(results))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
