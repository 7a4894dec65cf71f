"""Smoke test of the rlrpt_tpu_torch port on one NVIDIA card (H100).

    python3 chip_smoke.py [--out DIR]

Builds the CUDA kernels from rlrpt_tpu_torch/csrc, holds each against its
plain torch twin on the card (at small extra cases and at the main path's
shapes), times both at the main path's shapes beside the kernel's bound
(the least time for its work, from this run's segment counts, and for
B4 from the plain BVH walk's node visits and triangle tests), holds B4a-c
(a BVH walk) bit for bit against the brute-force sweep kernel on full-width
camera and bounce rays, edge, vertex and grazing rays and a half
active_count on every scene, and times the two in turns in CUDA graphs
(the kernels line's B4 ``ms`` stays stream-timed, the wrappers' host time
included, with ``graph_ms`` beside it; B4a's device time in the OBJ
loops is their B4a launches replayed in a CUDA graph), checks
that a decreasing CDF table is refused, times B2's grid barrier and counts
the device kernels of one B2 learning frame under torch.profiler (one
launch of the train kernel, no host sync inside the frame), then drives
each path through the entry points a user calls, with every launch count
set to 0 just before it and read just after:

* the default megakernel at the bench point (Cornell 720x720, 1 spp,
  80-bounce cap): B1;
* ``render_guided_mega(ablate="uniform")`` and ``ablate="fetch"`` at
  720x720, 32 spp: B3's ablated kernels (perf attribution; phase 4 holds
  them bit for bit to their twins at 128x128, 4 spp and at that point,
  and times B3's three modes in turns there, per traced segment);
* ``tools/render.py --mode sarsa-mega --frames 0`` and ``--mode mega`` at
  720x720, 32 spp: B3, B1;
* the learning path, ``--mode sarsa-mega --frames 10 --spp 32`` at
  720x720 (the EVAL protocol): B2, then B3;
* the wavefront path, ``--mode wavefront`` (B4a) and
  ``render_wavefront(hit_mode="f32")`` (B4b) at 720x720, 32 spp;
* ``closest_hit_packed_mxu`` (B4c) on 518,400 camera rays and a bounce
  batch: no integrator of either package calls it, so its public launcher
  is its path;
* the fine-map expected-SARSA stack: ``--mode sarsa-fast`` at 720x720,
  10 learning frames of 8 spp (phase 19 runs the EVAL protocol's 40),
  with V = 24,526 volumes and the class table (B4a, its class column
  live; B4a held against its twin on the path's own rays; the visit
  invariant in every frame; a 32-spp test render within 2% of
  ``--mode mega``), the other fine-map modes at 128x128 (B4b), and the
  learned map baked into B3's table and rendered at 720x720 (B3);
* the deep-Q family, kernel B4a under cuBLAS f32 matmuls (TF32 off):
  ``--mode neural-q --impl wavefront`` at 720x720, 2 frames of 1 spp,
  pix_mux 8, the full 342-200-300-200-144 net (epsilon exact, weights
  finite and moved, zclp not rising, B4a bit-equal to its twins on three
  of the frames' calls, no host sync inside a minibatch loop in a
  profiled window of iterations, ended after them, which also gives
  kernels per iteration, the device's idle share and the Adam and
  forward_relative device time), one ``train_batching="fused"`` frame,
  the MLP's forward against its f32 bound; ``--mode pretrained`` from
  the saved model at 4 spp in f32 and bf16 (bf16 within 3x the f32
  seed-to-seed noise per
  pixel, and its frame and block means within the standard errors that
  seed pairs give; the f32 frame means within -8% to -2% of
  ``--mode mega``'s, the reference estimator's darkening); the lockstep
  ``neural-q`` and ``pretrained`` at
  128x128 (the wavefront held to the lockstep in the same ways);
  ``--mode distill`` of the phase-11 map (test MSE falls) and
  ``--mode q-probe`` (rows sum to 1);
* the new scenes (phase 18): the test room (B1, B3, B2, B4a/b bit-equal
  to their twins; ``--mode mega`` and ``--mode sarsa-mega --frames 10``
  at 720x720, 32 spp, the learned Q as an f32 table within 2%) and a
  generated OBJ at bunny.obj's size, 4,980 triangles (native parse equal
  to the Python one; B1, B3 with a baked per-triangle table and B4a/b
  bit-equal to their twins; B1, B3 and B4a-c timed against their bounds
  at 720x720; ``--mode wavefront`` and ``--mode sarsa-fast`` through the
  CLI, means within 2%, the fine map saved for phase 22); the BVH build
  kernel (``csrc/bvh_build.cu``, which builds every tree of the card's
  paths) bit-equal to the numpy build and to ``build_bvh_plain`` on
  every scene table and edge case, timed by CUDA events on the OBJ beside
  the host build, and the culled frame end to end at 1 and 32 spp with
  the tree built on the card and on the host; the culled B1
  (``render_default_mega(cull=...)``, a BVH walk in the slot loop) on
  the OBJ and on the 288-triangle clutter scene at 720x720: bit-equal to
  the sweep kernel at 1 and 32 spp, each timed in turns, and to its twin
  (the plain walk) at 1 spp, 720x720 on the OBJ and 128x128 on the clutter,
  its counted bound from the count-only build (equal to the twin's
  counts), which also gives the walk's SIMT efficiency (active lanes over
  32 lanes a warp step); ``--mode mega`` on the OBJ, culled by default,
  bit-equal to ``cull=False`` at its seed; and scene_bench rows with
  ``--cull both`` for Cornell, the test room and the OBJ, Morton-sorted
  and not;
* the deep-Q family on that OBJ (phase 22, run after 18; the
  relative-vertex input 44,820 wide): ``--mode neural-q`` at 720x720, 2
  frames of 1 spp, then ``--save-model`` (the checks of phase 14, every
  layer moved, the first layer (200, 44,820), peak device memory; B4a
  bit-equal to both twins on three of the frames' calls), a profiled
  window of full-width iterations beside phase 14's, the DyNet file's
  save and load seconds (the load bit for bit), ``--mode pretrained`` at
  4 spp in f32 (two seeds, above -10% of ``--mode mega``'s mean at the
  same spp and not 4 standard errors above it) and bf16 (held to f32 as
  in phase 15), the zero-Q share, the lockstep tracers at 128x128 (held
  to the wavefront as in phase 16), ``--mode distill`` of phase 18's OBJ
  map for 2 epochs (finite losses, the input 44,820 wide) and ``--mode
  q-probe`` of the distilled net (the net's rows; each sums to 1 or, as
  in phase 17, stays 0 where the output ReLU zeroes every sector: at this
  width the reference's distillation zeroes nearly all of them), and of
  the trained neural-q net at the same volumes (every row sums to 1);
* the thesis MAPE protocol (phase 19, ``tools/evaluate.py``) on Cornell
  at 720x720, 128 spp: the port's own 4096-spp GT (B1) within 0.5% of
  the cached GT's mean, then every row but neural_q against the cached
  GT with a 10 s budget (B1, B4a, B3, B2); every learned row's MAPE must
  be below the default row's, each printed beside EVAL.json's;
* the tools (phase 20): ``mega_sweep --variants`` (the default grid and
  a high3 spec) at the bench point, 2 frames a trial (B1: a row per
  variant with rays/s and a lane use in (0, 1], the high3 spec's error
  row); the bench twin's line, ``sarsa_bench`` at
  720x720, ``neural_q_bench`` at 128x128, ``nn_training_stats`` at 64x64
  (its line count), the interactive renderers of each mode at 96x96, and
  ``pixel_gradients`` through ``render_diff`` at 720x720, 2 spp, 80
  bounces (B4b), finite and equal to the same render's with the plain
  hit on the same draws, with its peak memory;
* the multi-device layer (phase 21, ``rlrpt_tpu_torch/parallel``): a
  world of one over NCCL (``multihost.initialize``), every dp and
  multiscene entry point beside the single-process call it shards, with
  their seconds: ``render_default_dp`` at 8 spp (mean within 2% of
  ``--mode mega``), 10 ``sarsa_mega_train_dp`` frames at 32 spp and
  ``render_guided_mega_dp`` (B2, B3; each frame's image and visits
  bit-equal to the launcher's with the rank-0 seed, q within rtol 1e-4,
  the visit invariant exact), ``render_frame_sarsa_wavefront_dp`` on
  phase 11's volumes and the pretrained (4 spp) and neural-Q (360x360)
  wavefront dp frames (B4a; bit-equal to the single-process frames),
  ``render_frame_sarsa_dp`` at 128x128 (B4b), ``neural_q_train_step_dp``
  at 128x128 (B4a), ``render_multiscene_dp`` and
  ``train_multiscene_deep_dp`` on Cornell and the test room at 256x256,
  and the scaling bench's rows for sizes 1 and 2 (2 skipped: one card);
  then two spawned ranks sharing the card over gloo
  (``sarsa_mega_train_dp`` at 16 spp a rank, ``render_guided_mega_dp``,
  ``render_frame_neural_q_wavefront_dp`` at 128x128): the replicated q,
  visits, net and Adam state bit-identical on both ranks, the visits
  v0 + c_0 + c_1 exactly, and B2, B3 and B4a launched on each rank.

Fails if a kernel of a path was never launched in it, if the brute-force
sweep or an ablated B3 kernel was, if the culled B1 was on a path that
sweeps (Cornell, the test
room: one chunk; ``cull=True`` on Cornell is forced off, as in JAX), if
a tree of a path was built other than by the build kernel, or if a
wavefront or sarsa-fast frame built more than one BVH.
Prints one line per
phase and, after the last, each phase's seconds; then the card line, one
JSON line describing the kernels, and as the last line {"ok": true,
"device": {...}}.  Any failure raises, exits
non-zero and prints no result.  Images and a results.json go to --out
(default build/smoke/).  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from rlrpt_tpu_torch.tools.mega_sweep import (APPLY_OPS, BOX_OPS, MT_OPS,
                                              ablate_turns, bound_ms,
                                              frame_bound, graph_ms,
                                              kernel_ms)

ROOT = Path(__file__).resolve().parent
CAM = (0.0, 0.0, -3.0)
TOL = "99% of pixels within atol 1e-4 rtol 1e-3; mean 0.5%; avg path 1%"
# a pretrained f32 frame's mean relative to --mode mega's ([15]), and its
# spp (32 before phase 21 came, 16 before phase 22; at 4 the frame mean's
# standard error is still ~0.1%, against a band 6% wide)
PRETRAINED_BAND = (-0.08, -0.02)
PRETRAINED_SPP = 4

PHASE_START: dict = {}   # phase tag -> perf_counter at its first line


def log(msg: str) -> None:
    """Print a line; a line that opens with a "[n]" tag starts phase n's
    clock (phase_seconds)."""
    m = re.match(r"\[(\w+)\]", msg)
    if m:
        PHASE_START.setdefault(m.group(1), time.perf_counter())
    print(msg, flush=True)


def phase_seconds(end: float) -> dict:
    """Seconds from each phase's first line to the next phase's, in order
    of their first lines (a phase whose lines interleave with another's,
    as the paths' launch lines do, counts from its first line)."""
    tags = sorted(PHASE_START, key=PHASE_START.get)
    ends = [PHASE_START[t] for t in tags[1:]] + [end]
    return {t: e - PHASE_START[t] for t, e in zip(tags, ends)}


def log_timing(seconds: dict, note: str = "") -> None:
    log(f"[timing] seconds per phase{note}: " + ", ".join(
        f"[{t}] {s:.1f}" for t, s in seconds.items()))


def kernel_name(symbol: str) -> str:
    """The kernel's own name in a mangled symbol: the first <length><name>
    run whose name ends in "kernel" (a length may follow hex digits)."""
    for m in re.finditer(r"\d+", symbol):
        for i in range(m.start(), m.end()):
            n = int(symbol[i:m.end()])
            name = symbol[m.end():m.end() + n]
            if len(name) == n and name.endswith("kernel"):
                return name
    return symbol


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
    c = cornell_box(device="cpu")
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


def skewed_q(device, skew: float, t_pad: int = 40):
    """The initial binned Q (11x11 sectors, uv_bins 4; t_pad 40 is the
    Cornell box's) skewed per entry by exp(skew * U[0, 1)) from numpy
    seed 3."""
    from rlrpt_tpu_torch.ops.guided_mega_train import init_bin_q
    q, _ = init_bin_q(t_pad, 4, 11, 100.0 / 121, device="cpu")
    u = np.random.default_rng(3).random(q.shape)
    return (q * torch.from_numpy(np.exp(skew * u).astype(np.float32))).to(
        device)


def skewed_table(device, skew: float, t_pad: int = 40):
    """skewed_q rebuilt to a CDF."""
    from rlrpt_tpu_torch.ops.guided_mega_train import rebuild_bin_cdf
    return rebuild_bin_cdf(skewed_q(device, skew, t_pad), 11, 4, t_pad)


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


def camera_rays(device, gen, size: int = 720):
    """size x size jittered camera rays (518,400 at 720), the camera at
    CAM: (origins, directions), contiguous."""
    from rlrpt_tpu_torch.camera import Camera, pixel_rays
    jitter = torch.rand((size, size, 2), generator=gen, device=device)
    o, d = pixel_rays(jitter, Camera.create(CAM), size, size, float(size))
    return o.contiguous(), d.contiguous()


def hit_rays(device, tris, mat, gen, size: int = 720, hit=None):
    """camera_rays and one bounce ray from each camera ray's hit (uniform
    about the normal): (camera o, d, camera + bounce o, d).  ``hit``: the
    closest-hit function for the camera rays (default the plain twin; the
    brute-force sweep kernel at thousands of triangles)."""
    from rlrpt_tpu_torch.ops import intersect_pallas as ip
    from rlrpt_tpu_torch.ops.hemisphere import sample_uniform_direction
    o, d = camera_rays(device, gen, size)
    hit = hit or ip.closest_hit_plain
    t, _, rows = hit(o, d, tris, o.shape[0], mat)
    hit = t < 1e38
    nd, _ = sample_uniform_direction(gen, rows[:, 0:3])
    o2 = o + torch.where(hit, t, 0.0)[:, None] * d + 1e-4 * nd
    return (o, d, torch.cat([o, o2[hit]]).contiguous(),
            torch.cat([d, nd[hit]]).contiguous())


def edge_rays(tris, seed: int):
    """Rays aimed exactly at every triangle's vertices, edge midpoints and
    a random point of each edge (so at both sides of every shared edge),
    from the camera and from random origins inside [-0.95, 0.95]^3, and
    rays grazing each triangle's plane (from outside the triangle towards
    its centroid, tilted off the plane by 1e-7 to 1e-2 rad): (o, d) on
    the table's device."""
    rng = np.random.default_rng(seed)
    r = tris.cpu().numpy()
    v0 = r[:, 0:3]
    v1, v2 = v0 + r[:, 4:7], v0 + r[:, 8:11]
    pts = []
    for a, b in ((v0, v1), (v1, v2), (v2, v0)):
        s = rng.uniform(0, 1, (len(a), 1)).astype(np.float32)
        pts += [a, (a + b) * np.float32(0.5), a + s * (b - a)]
    pts = np.concatenate(pts)
    org = np.concatenate([np.broadcast_to(np.float32(CAM), pts.shape),
                          rng.uniform(-0.95, 0.95, pts.shape)])
    d = np.concatenate([pts, pts]) - org
    cen = (v0.astype(np.float64) + v1 + v2) / 3
    n = np.cross(v1 - v0, v2 - v0).astype(np.float64)
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-30)
    g_o = cen + 3.0 * ((v0 + v1) / 2 - cen)
    g_d = cen - g_o
    g_d /= np.maximum(np.linalg.norm(g_d, axis=1, keepdims=True), 1e-30)
    g_d += 10.0 ** rng.uniform(-7, -2, (len(v0), 1)) * rng.choice(
        [-1.0, 1.0], (len(v0), 1)) * n
    o = np.concatenate([org, g_o]).astype(np.float32)
    d = np.concatenate([d, g_d]).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.from_numpy(o).to(tris.device),
            torch.from_numpy(d.astype(np.float32)).to(tris.device))


def walk_vs_sweep(label: str, tris, mat, bvh, ray_sets: dict) -> int:
    """B4a, B4b and B4c through the BVH against closest_hit_sweep (the
    brute-force kernel) on each named (o, d, count) ray set: t, index and
    B4a's rows must be equal bit for bit.  Logs and returns the number of
    differing rays (the gate is 0)."""
    from rlrpt_tpu_torch.ops import intersect_pallas as ip
    total = 0
    for name, (o, d, count) in ray_sets.items():
        live = torch.tensor([count], dtype=torch.int32, device=o.device)
        ref = ip.closest_hit_sweep(o, d, tris, live, mat)
        diff = {}
        for kern, fn, tabs in (("B4a", ip.closest_hit_mat_mxu, (tris, mat)),
                               ("B4b", ip.closest_hit_packed, (tris,)),
                               ("B4c", ip.closest_hit_packed_mxu, (tris,))):
            out = fn(o, d, *tabs, live, bvh=bvh)
            bad = (out[0].view(torch.int32) != ref[0].view(torch.int32)) | (
                out[1] != ref[1])
            if len(out) == 3:
                bad |= (out[2].view(torch.int32)
                        != ref[2].view(torch.int32)).any(dim=1)
            diff[kern] = int(bad.sum())
        torch.cuda.synchronize()
        total += sum(diff.values())
        log(f"  {label} {name}: {o.shape[0]} rays, count {count}, "
            f"{float((ref[0][:count] < 1e38).float().mean()):.4f} hit; "
            f"rays differing from the sweep: "
            + ", ".join(f"{k} {v}" for k, v in diff.items()))
    check(total == 0, f"{label}: {total} rays differ from the brute-force "
                      f"sweep")
    return total


def walk_timing(label: str, o, d, tris, mat, bvh, reps: int = 50) -> dict:
    """B4a through the BVH against the brute-force sweep on the same rays,
    in turns (sweep, walk, walk, sweep), ``reps`` launches each in a CUDA
    graph timed by CUDA events (graph_ms: device time, not the wrappers'
    host time; both sides timed so); then the work these rays need, from
    the plain walk's counts, and the two bounds.  Returns the figures (ms:
    means of each kind's two turns)."""
    from rlrpt_tpu_torch.ops import bvh as bv
    from rlrpt_tpu_torch.ops import intersect_pallas as ip
    r = o.shape[0]
    live = torch.tensor([r], dtype=torch.int32, device=o.device)
    runs = {
        "sweep": lambda: ip.closest_hit_sweep(o, d, tris, live, mat),
        "walk": lambda: ip.closest_hit_mat_mxu(o, d, tris, mat, live,
                                               bvh=bvh)}
    ms = {k: [] for k in runs}
    for k in ("sweep", "walk", "walk", "sweep"):
        ms[k].append(graph_ms(runs[k], reps))
    out = bv.closest_hit_bvh_plain(o, d, bvh, r, mat)
    kern = runs["walk"]()
    for a, b in zip(out[:3], kern):
        check(torch.equal(a, b), f"{label}: the plain walk and the kernel "
                                 "differ")
    visits = float(out[3].double().sum())
    tests = float(out[4].double().sum())
    t = tris.shape[0]
    io_bytes = r * (24 + 8 + 64)     # o, d read; t, index, row written
    counted = bound_ms(visits * 2 * BOX_OPS + tests * MT_OPS,
                       io_bytes + bvh.nodes.numel() * 4 + t * (48 + 4 + 64))
    brute = bound_ms(r * t * MT_OPS, io_bytes)
    res = {"rays": r, "triangles": t,
           "ms": {k: statistics.mean(v) for k, v in ms.items()},
           "turns_ms": ms, "visits_per_ray": visits / r,
           "tests_per_ray": tests / r, "max_visits": int(out[3].max()),
           "max_tests": int(out[4].max()), "counted_bound_ms": counted[0],
           "counted_bound_by": counted[1], "brute_bound_ms": brute[0],
           "brute_bound_by": brute[1]}
    res["share"] = counted[0] / res["ms"]["walk"]
    log(f"  {label}, {r} rays x {t} triangles, B4a (ms, {reps} launches a "
        f"turn in a CUDA graph, in turns): sweep {ms['sweep'][0]:.4f}, "
        f"{ms['sweep'][1]:.4f}; walk {ms['walk'][0]:.4f}, "
        f"{ms['walk'][1]:.4f} (walk/sweep "
        f"{res['ms']['walk'] / res['ms']['sweep']:.4f}); per ray "
        f"{res['visits_per_ray']:.3f} "
        f"inner-node visits (max {res['max_visits']}) and "
        f"{res['tests_per_ray']:.3f} triangle tests (max "
        f"{res['max_tests']}); counted bound {counted[0]:.5f} ms "
        f"({counted[1]}), share {res['share']:.4f}; brute-force bound "
        f"{brute[0]:.5f} ms ({brute[1]})")
    return res


def host_ms(fn):
    """(host time of one fn() call in ms, its result)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def profile_train_frame(fn) -> tuple[dict, list, list]:
    """fn() (one B2 learning frame) under torch.profiler: its device
    kernels by name (memsets and copies included), and the host's stream
    and device synchronisations before and after the train kernel's
    cooperative launch (the profile's own closing one left out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        with record_function("closing_sync"):
            torch.cuda.synchronize()
    kernels, host, starts, closing = {}, [], [], []
    for e in prof.events():
        if e.name == "closing_sync":
            closing.append(e.time_range.start)
        if e.device_type == DeviceType.CUDA:
            name = "train_kernel" if "train_kernel" in e.name else e.name[:48]
            kernels[name] = kernels.get(name, 0) + 1
            if name == "train_kernel":
                starts.append(e.time_range.start)
        elif "Synchronize" in e.name or "LaunchCooperative" in e.name:
            host.append((e.time_range.start, e.name))
    host.sort()
    # the launch call where the profiler records it, else the kernel's start
    launch = [t for t, n in host if "LaunchCooperative" in n] or starts
    check(len(launch) == 1, f"{len(launch)} train kernel launches profiled")
    check(len(closing) == 1, "the profile's closing sync not found")
    syncs = [(t, n) for t, n in host
             if "Synchronize" in n and t < closing[0]]
    return (kernels, [n for t, n in syncs if t < launch[0]],
            [n for t, n in syncs if t > launch[0]])


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def check_image(label: str, img, size: int) -> None:
    check(tuple(img.shape) == (size, size, 3),
          f"{label}: image shape {tuple(img.shape)}")
    check(torch.isfinite(img).all(), f"{label}: non-finite pixels")
    check(float(img.max()) > 0.0, f"{label}: black image")


def check_visits(label: str, frames, visits0: int = 0) -> None:
    """Per learning frame, the visit-count delta equals the TD scatters."""
    for i, fr in enumerate(frames):
        check(fr["visits"] - visits0 == fr["td_scatters"] > 0,
              f"{label} frame {i}: visit delta {fr['visits'] - visits0} != "
              f"td scatters {fr['td_scatters']}")
        visits0 = fr["visits"]


class CallRecorder:
    """Stands in for a loop module's closest_hit_mat_mxu (B4a) and keeps a
    copy of every call's inputs, so that the frame's B4a launches can be
    replayed afterwards.  The copies add device work to the frame, so it
    records an extra, untimed one."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, o, d, tris, mat, m, bvh=None):
        self.calls.append((o.clone(), d.clone(), tris, mat, m.clone(), bvh))
        return self.fn(o, d, tris, mat, m, bvh)

    def device_seconds(self) -> float:
        """B4a's device time in the recorded frame: its launches, on their
        recorded inputs, replayed back to back in one CUDA graph timed by
        CUDA events (graph_ms), so no host time falls between them."""
        def replay():
            for o, d, tris, mat, m, bvh in self.calls:
                self.fn(o, d, tris, mat, m, bvh)
        return graph_ms(replay, 1) / 1e3


class HitRecorder:
    """Stands in for sarsa_wavefront's closest_hit_mat_mxu (B4a) and keeps
    copies of the inputs of the calls numbered in ``at`` and of the last
    two calls (the last may be an idle one after the frame drained), so
    the kernel can be held against its twin on the path's own rays
    afterwards.  The copies add three clones to every iteration: phase 11
    records an extra, untimed frame (315 kernels an iteration); the deep
    phases record their timed frames (~4,000 kernels an iteration)."""

    def __init__(self, fn, at):
        self.fn, self.at, self.n, self.calls = fn, set(at), 0, {}

    def __call__(self, o, d, tris, mat, m, bvh):
        keep = (o.clone(), d.clone(), tris, mat, m.clone(), bvh)
        if "last" in self.calls:
            self.calls["next to last"] = self.calls["last"]
        self.calls["last"] = keep
        if self.n in self.at:
            self.calls[self.n] = keep
        self.n += 1
        return self.fn(o, d, tris, mat, m, bvh)


def fine_map_phases(dev, out_dir: Path, drive, mega_mean: float,
                    size: int = 720, learn_frames: int = 10,
                    area: float = 0.001, small: int = 128,
                    nn_queries: int = 100_000, keep: dict | None = None
                    ) -> dict:
    """Phases 11-13, the fine-map expected-SARSA stack; returns their
    figures.  ``drive`` runs a path with every launch count at 0 and
    fails it if an expected kernel never launched; ``mega_mean`` is the
    mean of a ``--mode mega`` frame at size x size, 32 spp.  ``keep``
    receives phase 11's learned volumes and class table (phase 21 reuses
    them)."""
    from rlrpt_tpu_torch.camera import Camera
    from rlrpt_tpu_torch.config import RadianceVolumeConfig, RenderConfig
    from rlrpt_tpu_torch.integrators import sarsa_wavefront as sw
    from rlrpt_tpu_torch.ops import bvh as bv
    from rlrpt_tpu_torch.ops import intersect_pallas as ip
    from rlrpt_tpu_torch.ops.guided_mega import render_guided_mega
    from rlrpt_tpu_torch.ops.megakernel import _t_pad
    from rlrpt_tpu_torch.radiance import map_io
    from rlrpt_tpu_torch.radiance.bake import bake_tri_bin_cdf
    from rlrpt_tpu_torch.radiance.grid_bucket import build_volume_class_table
    from rlrpt_tpu_torch.radiance.nn_search import find_closest_volume
    from rlrpt_tpu_torch.radiance.volumes import build_radiance_volumes
    from rlrpt_tpu_torch.scene import cornell_box
    from rlrpt_tpu_torch.scene.geometry import sample_points_on_triangles
    from rlrpt_tpu_torch.scene.scene import surface_areas
    from rlrpt_tpu_torch.tools import render
    from rlrpt_tpu_torch.utils.image import write_png

    scene = cornell_box(device=dev)
    camera = Camera.create(CAM)
    res = {}

    def run_cli(argv):
        sync(dev)
        t0 = time.perf_counter()
        img, aux = render.render(render.build_parser().parse_args(
            argv + ["--device", dev.type]))
        sync(dev)
        return img, aux, time.perf_counter() - t0

    # ---- 11: sarsa-fast at full width -----------------------------------
    log(f"[11] sarsa-fast: Cornell {size}x{size}, 80 bounces, area_per_sample"
        f" {area}, class table, pix_mux 4, hit_mode mxu; {learn_frames} "
        f"learning frames x 8 spp (a quarter of the EVAL protocol's "
        f"training, which phase 19 runs whole), then a 32-spp test render "
        f"that keeps learning")
    img, aux, sec = drive("11", ("B4a",), lambda: run_cli([
        "--mode", "sarsa-fast", "--frames", str(learn_frames),
        "--spp", "8", "--width", str(size), "--height", str(size),
        "--bounces", "80", "--area-per-sample", str(area),
        "--pix-mux", "4", "--seed", "1984"]))
    b4a_learn = ip.KERNEL_MAT.launches
    vols, table, frames = aux["vols"], aux["table"], aux["frames"]
    if keep is not None:
        keep.update(vols=vols, table=table)
    check(bv.BUILDS == len(frames), f"sarsa-fast: {bv.BUILDS} BVH builds in "
                                    f"{len(frames)} frames")
    check_image("sarsa-fast learning frame", img, size)
    log(f"[11] V = {vols.n_volumes} volumes; answer table {table.dims} = "
        f"{table.table.shape[0]} cells, {table.nbytes} bytes, host build "
        f"{aux['table_seconds']:.4f} s (not in any frame's seconds); "
        f"{len(torch.unique(table.tri_class))} triangle classes")
    for i, fr in enumerate(frames):
        log(f"[11] learning frame {i}: {fr['seconds']:.4f} s, "
            f"{fr['iterations']} iterations, phases "
            + " ".join(f"{n}@{w}" for w, n in zip(fr["phase_widths"],
                                                 fr["phase_iterations"]))
            + f", avg path {fr['avg_path']:.4f}, zclp {fr['zclp']}, "
            f"td scatters {fr['td_scatters']}")
    check_visits("sarsa-fast", frames)
    check(frames[-1]["zclp"] <= frames[0]["zclp"],
          f"zclp rose: {frames[0]['zclp']} -> {frames[-1]['zclp']}")
    learn_s = [fr["seconds"] for fr in frames]
    log(f"[11] {b4a_learn} B4a launches in {len(frames)} frames; "
        f"{statistics.median(learn_s):.4f} s per learning frame (median), "
        f"{sum(learn_s):.4f} s in all; CLI {sec:.4f} s")

    test_cfg = RenderConfig(width=size, height=size, samples_per_pixel=32,
                            max_ray_bounces=80)
    rl = RadianceVolumeConfig(area_per_sample=area)

    def test_render():
        sync(dev)
        t0 = time.perf_counter()
        out = sw.render_frame_sarsa_wavefront(
            torch.Generator(device=dev).manual_seed(2000), scene, camera,
            vols, table, test_cfg, rl, pix_mux=4)
        sync(dev)
        return out, time.perf_counter() - t0

    (t_img, t_vols, t_aux), t_sec = drive("11", ("B4a",), test_render)
    check(bv.BUILDS == 1, f"sarsa-fast test render: {bv.BUILDS} BVH builds")
    check_image("sarsa-fast test render", t_img, size)
    check_visits("sarsa-fast test render", [{
        "visits": int(t_vols.visits.sum()),
        "td_scatters": int(t_aux["td_scatter_count"])}],
        int(vols.visits.sum()))
    t_gap = (float(t_img.mean()) - mega_mean) / mega_mean
    write_png(str(out_dir / "sarsa-fast.png"), t_img.cpu())
    # phase 17 distills the learned map, and probes 16 of the volumes
    # whose largest Q is above the median (those that gathered light)
    map_io.save_q_vals_to_file(t_vols, str(out_dir / "q_fine_map.txt"))
    write_probes(t_vols, out_dir / "probes.txt", 17)
    log(f"[11] test render 32 spp: {t_sec:.4f} s, "
        f"{int(t_aux['wavefront_iterations'])} iterations, avg path "
        f"{float(t_aux['avg_path_length']):.4f}, zclp "
        f"{int(t_aux['zero_contribution_light_paths'])}, mean "
        f"{float(t_img.mean()):.6f} vs mega {mega_mean:.6f}: {t_gap:+.4%}")
    check(abs(t_gap) <= 0.02, f"sarsa-fast test mean off by {t_gap:+.2%}")

    # B4a on the phase's own rays, with the class column live: one more
    # 8-spp learning frame on the learned map, untimed and uncounted, keeps
    # its calls' inputs; the rows carry each hit triangle's class
    rec = HitRecorder(sw.closest_hit_mat_mxu, at=(0, 100))
    sw.closest_hit_mat_mxu = rec
    try:
        sw.render_frame_sarsa_wavefront(
            torch.Generator(device=dev).manual_seed(2001), scene, camera,
            t_vols, table, dataclasses.replace(test_cfg, samples_per_pixel=8),
            rl, pix_mux=4)
    finally:
        sw.closest_hit_mat_mxu = rec.fn
    sync(dev)
    seen = set()
    for key, (o, d, tris, mat, m, bvh) in rec.calls.items():
        check(torch.equal(mat[:, 11], table.tri_class.float()),
              f"B4a call {key}: column 11 is not the table's tri_class")
        k_out = ip.closest_hit_mat_mxu(o, d, tris, mat, m, bvh)
        sync(dev)
        p_out = ip.closest_hit_plain(o, d, tris, int(m), mat)
        for a, b in zip(k_out, p_out):
            check(torch.equal(a, b), f"B4a call {key}: kernel and twin "
                                     "differ on the path's rays")
        t, idx, rows = k_out
        hit = t < 1e38
        check(torch.equal(rows[hit, 11],
                          table.tri_class[idx[hit].long()].float()),
              f"B4a call {key}: hits do not carry their triangle's class")
        ids = torch.unique(rows[hit, 11]).tolist()
        seen.update(ids)
        log(f"[11] B4a call {key} ({o.shape[0]} slots, active_count "
            f"{int(m)}): t, index and material rows bit-equal to the "
            f"twin; {len(ids)} class ids among its hits")
    check(len(seen) > 1, f"B4a: class column not live ({sorted(seen)})")
    res["sarsa_fast"] = {
        "n_volumes": vols.n_volumes, "table_cells": table.table.shape[0],
        "table_bytes": table.nbytes, "table_seconds": aux["table_seconds"],
        "learning_frames": frames, "b4a_launches_learning": b4a_learn,
        "test_seconds": t_sec, "test_mean_vs_mega": t_gap,
        "test_iterations": int(t_aux["wavefront_iterations"]),
        "test_avg_path": float(t_aux["avg_path_length"])}

    # ---- 12: the rest of the slice at a smaller size --------------------
    log(f"[12] the rest of the slice at {small}x{small}, 4 spp, "
        f"area_per_sample 0.01")
    sm = ["--width", str(small), "--height", str(small), "--spp", "4",
          "--bounces", "80", "--area-per-sample", "0.01", "--seed", "7"]
    small_s = {}

    def small_cli(label, expect, argv):
        img, aux, sec = drive("12", expect, lambda: run_cli(argv + sm))
        check_image(label, img, small)
        small_s[label] = sec
        write_png(str(out_dir / f"{label}.png"), img.cpu())
        log(f"[12] {label}: {sec:.4f} s, mean {float(img.mean()):.6f}")
        return img, aux

    _, aux = small_cli("sarsa", ("B4b",), ["--mode", "sarsa", "--frames",
                                           "2"])
    check_visits("lockstep sarsa", aux["frames"])
    q_path = out_dir / "q_sarsa_fast.txt"
    _, aux = small_cli("sarsa-fast", ("B4a",), [
        "--mode", "sarsa-fast", "--frames", "2", "--save-q", str(q_path)])
    check_visits("small sarsa-fast", aux["frames"])
    learned, s_table = aux["vols"].q, aux["table"]
    _, aux = small_cli("precomputed-loaded", ("B4b",), [
        "--mode", "precomputed", "--load-q", str(q_path)])
    check(torch.allclose(aux["vols"].q, learned, rtol=1e-5, atol=0),
          "--load-q did not reproduce the saved Q table")
    q2_path = out_dir / "q_reloaded.txt"
    map_io.save_q_vals_to_file(aux["vols"], str(q2_path))
    check(q2_path.read_bytes() == q_path.read_bytes(),
          "the reloaded Q table saves to other text")
    log("[12] --save-q then --load-q: Q within rtol 1e-5 (the text's 6 "
        "digits), saved again byte-equal")
    img, _ = small_cli("voronoi", ("B4b",), ["--mode", "voronoi"])
    n_col = len(torch.unique(img.reshape(-1, 3), dim=0))
    check(n_col > 100, f"voronoi: only {n_col} colours")
    small_cli("importance", ("B4b",), ["--mode", "importance",
                                        "--precompute-spp", "2"])
    small_cli("precomputed", ("B4b",), ["--mode", "precomputed",
                                         "--precompute-spp", "2"])

    small_rl = RadianceVolumeConfig(area_per_sample=0.01)
    s_vols = build_radiance_volumes(scene, small_rl)
    s_cfg = RenderConfig(width=small, height=small, samples_per_pixel=4,
                         max_ray_bounces=80)
    f_img, f_vols, f_aux = drive("12", ("B4b",), lambda: (
        sw.render_frame_sarsa_wavefront(
            torch.Generator(device=dev).manual_seed(8), scene, camera,
            s_vols, s_table, s_cfg, small_rl, pix_mux=4, hit_mode="f32")))
    check(ip.KERNEL_MAT.launches == 0, "hit_mode f32 launched B4a")
    check_image("sarsa-fast hit_mode f32", f_img, small)
    check_visits("sarsa-fast hit_mode f32", [{
        "visits": int(f_vols.visits.sum()),
        "td_scatters": int(f_aux["td_scatter_count"])}])
    log(f"[12] sarsa-fast hit_mode f32: mean {float(f_img.mean()):.6f}, "
        f"{int(f_aux['wavefront_iterations'])} iterations")

    # dense nearest-volume search against a float64 brute force, on
    # random surface points of the phase-11 volume set
    rng = np.random.default_rng(12)
    ns = scene.n_surfaces
    host = lambda a: a[:ns].cpu().numpy().astype(np.float64)  # noqa: E731
    v0, v1, v2 = host(scene.v0), host(scene.v1), host(scene.v2)
    s_area = surface_areas(scene)
    per = rng.multinomial(nn_queries, s_area / s_area.sum())
    qp, qt = sample_points_on_triangles(rng, v0, v1, v2, per)
    qpos = torch.as_tensor(qp, device=dev)
    qnrm = scene.normal[torch.as_tensor(qt, device=dev)]
    got = find_closest_volume(vols, qpos, qnrm)
    vp, vn = vols.position.double(), vols.normal
    want = []
    for i in range(0, nn_queries, 1024):
        d2 = ((qpos[i:i + 1024, None].double() - vp[None]) ** 2).sum(-1)
        same = (qnrm[i:i + 1024, None] == vn[None]).all(-1)
        want.append(torch.argmin(d2 + torch.where(same, 0.0, 1e12), -1))
    agree = float((got == torch.cat(want)).double().mean())
    log(f"[12] find_closest_volume vs a float64 brute force on "
        f"{nn_queries} random surface points, V = {vols.n_volumes}: "
        f"{agree:.6f} agree (TF32 for matmuls "
        f"{torch.backends.cuda.matmul.allow_tf32})")
    check(agree >= 0.999, f"dense search agrees on only {agree:.4%}")
    res["slice_small"] = {"seconds": small_s, "nn_agree": agree}

    # ---- 13: bake the phase-11 map into B3's table ----------------------
    t_pad = _t_pad(scene.n_triangles)
    sync(dev)
    t0 = time.perf_counter()
    baked = bake_tri_bin_cdf(scene, t_vols, rl, t_pad, uv_bins=4,
                             sector_grid=11)
    sync(dev)
    bake_s = time.perf_counter() - t0
    surf = baked.cdf[:121, :ns * 16].float()
    zero = float((surf[1:] == surf[:-1]).float().mean())

    def guided():
        sync(dev)
        t0 = time.perf_counter()
        out = render_guided_mega(4000, scene, camera, baked, test_cfg, dev)
        sync(dev)
        return out, time.perf_counter() - t0

    (g_img, g_aux), g_sec = drive("13", ("B3",), guided)
    check(torch.isfinite(g_img).all(), "baked guided render: non-finite")
    g_gap = (float(g_img.mean()) - mega_mean) / mega_mean
    write_png(str(out_dir / "baked-guided.png"), g_img.cpu())
    log(f"[13] bake of the phase-11 map (sector_grid 11, uv_bins 4): "
        f"{bake_s:.4f} s; {zero:.4f} of the surface columns' sectors 2..121 "
        f"have zero bf16 probability; B3 {size}x{size} 32 spp: "
        f"{g_sec:.4f} s, avg path {float(g_aux['avg_path_length']):.4f}, "
        f"mean {float(g_img.mean()):.6f} vs mega: {g_gap:+.4%}")
    res["bake"] = {"seconds": bake_s, "zero_bf16_sectors": zero,
                   "guided_seconds": g_sec, "guided_mean_vs_mega": g_gap}
    return res


def write_probes(vols, path: Path, seed: int) -> None:
    """16 probe points (``x y z nx ny nz``) at volumes whose largest Q is
    above the median (those that gathered light), drawn with numpy's
    ``seed``."""
    q_max = vols.q.max(dim=1).values
    lit = torch.nonzero(q_max > q_max.median())[:, 0].cpu().numpy()
    pick = np.random.default_rng(seed).choice(lit, 16, replace=False)
    p_pos, p_nrm = (vols.position[pick].cpu().numpy(),
                    vols.normal[pick].cpu().numpy())
    path.write_text("".join(
        " ".join(f"{float(x):.6g}" for x in (*p, *n)) + "\n"
        for p, n in zip(p_pos, p_nrm)))


class StopFrame(Exception):
    """Raised by IterationHook to end a frame after a profiled window."""


class IterationHook:
    """Stands in for deep_wavefront's closest_hit_mat_mxu, which each
    wavefront iteration calls once: records a CUDA event before every
    call (the iterations' spans on the device timeline), steps a profiler
    if it is given one, and with ``stop_at`` raises StopFrame at that
    call, after its event (the frame's later iterations are not needed)."""

    def __init__(self, fn, prof=None, sync_at=None, stop_at=None):
        self.fn, self.prof, self.sync_at, self.events = fn, prof, sync_at, []
        self.stop_at = stop_at

    def __call__(self, *args):
        if len(self.events) == self.sync_at:
            # the device finishes the window's kernels before the profiler
            # closes it
            torch.cuda.synchronize()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append(ev)
        if self.prof is not None:
            self.prof.step()
        if len(self.events) - 1 == self.stop_at:
            raise StopFrame
        return self.fn(*args)

    def spans_ms(self, first: int, n: int) -> list:
        torch.cuda.synchronize()
        ev = self.events[first:first + n + 1]
        return [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]


def stopped(fn):
    """fn() until an IterationHook ends it; None then."""
    try:
        return fn()
    except StopFrame:
        return None


def profile_deep_window(dw, frame, first: int, n: int) -> dict:
    """frame() (one training frame of deep_wavefront) under
    torch.profiler, recording only iterations first..first+n-1 (the
    closest-hit call that opens each iteration steps the profiler) and
    ending the frame there, with every train_on_batches call marked
    "minibatch_loop", every Adam step "adam" and every forward_relative
    call "forward_relative" (the sampler's forward and the minibatches';
    their backward runs under autograd.grad, outside it).  Returns the
    device kernels (memsets and copies included) of those iterations,
    their busy time (union of intervals), the cuBLAS kernels' time, the
    device time of the kernels launched inside each marked range, and
    the host synchronisations and device-to-host copies issued inside a
    minibatch loop."""
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)
    from rlrpt_tpu_torch.deep import neural_q as nq
    from rlrpt_tpu_torch.nn.dq_network import DQNetwork
    from rlrpt_tpu_torch.tools.sarsa_fast_profile import (busy_us,
                                                          device_events,
                                                          trace_events)
    hit, train = dw.closest_hit_mat_mxu, dw.train_on_batches
    adam, fwd = nq.adam_update, DQNetwork.forward_relative

    def marked(name, fn):
        def run(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return run

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=first, warmup=1, active=n,
                                   repeat=1)) as prof:
        dw.closest_hit_mat_mxu = IterationHook(hit, prof, first + n,
                                               first + n)
        dw.train_on_batches = marked("minibatch_loop", train)
        nq.adam_update = marked("adam", adam)
        DQNetwork.forward_relative = marked("forward_relative", fwd)
        try:
            stopped(frame)
            torch.cuda.synchronize()
        finally:
            dw.closest_hit_mat_mxu, dw.train_on_batches = hit, train
            nq.adam_update, DQNetwork.forward_relative = adam, fwd
    events = trace_events(prof)
    dev = device_events(events)
    ranges = {k: [(e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") == "user_annotation" and e.get("name") == k]
              for k in ("minibatch_loop", "adam", "forward_relative")}
    inside = lambda k, ts: any(s <= ts <= t for s, t in ranges[k])  # noqa: E731
    host_ts = {e["args"]["correlation"]: e["ts"] for e in events
               if e.get("cat") in ("cuda_runtime", "cuda_driver")
               and "correlation" in e.get("args", {})}
    launched = lambda e: host_ts.get(  # noqa: E731
        e.get("args", {}).get("correlation"), -1.0)
    syncs = [e["name"] for e in events
             if ((e.get("cat") in ("cuda_runtime", "cuda_driver")
                  and "Synchronize" in e["name"])
                 or (e.get("cat") == "cpu_op" and e["name"] in (
                     "aten::item", "aten::_local_scalar_dense")))
             and inside("minibatch_loop", e["ts"])]
    d2h = [e for e in dev if "DtoH" in e["name"]]
    d2h_in = [e for e in d2h if inside("minibatch_loop", launched(e))]
    gemm = [e for e in dev if re.search("gemm|gemv", e["name"], re.I)]
    in_range = {k: [e for e in dev if inside(k, launched(e))]
                for k in ("adam", "forward_relative")}
    return {"kernels": len(dev), "loops": len(ranges["minibatch_loop"]),
            "busy_us": busy_us((e["ts"], e["ts"] + e["dur"]) for e in dev),
            "gemm_us": sum(e["dur"] for e in gemm), "gemm_kernels": len(gemm),
            "adam_us": sum(e["dur"] for e in in_range["adam"]),
            "adam_kernels": len(in_range["adam"]),
            "forward_us": sum(e["dur"] for e in in_range["forward_relative"]),
            "forward_kernels": len(in_range["forward_relative"]),
            "syncs_in_loop": syncs, "d2h": len(d2h), "d2h_in_loop": len(d2h_in)}


def deep_window(dw, net, opt_state, frame, first: int, n: int) -> dict:
    """Iterations first..first+n-1 of frame() (a training frame), run twice
    from the same weights and Adam state, each ended after the window:
    with a CUDA event before each iteration (the spans on the device
    timeline), then under torch.profiler (profile_deep_window).  Returns
    the profile's figures with the spans and the idle share (1 - busy /
    span per iteration)."""
    state = list(net.parameters()) + [opt_state.count, *opt_state.mu,
                                       *opt_state.nu]
    saved = [t.detach().clone() for t in state]
    clock = IterationHook(dw.closest_hit_mat_mxu, stop_at=first + n)
    dw.closest_hit_mat_mxu = clock
    try:
        stopped(frame)
    finally:
        dw.closest_hit_mat_mxu = clock.fn
    spans = clock.spans_ms(first, n)
    with torch.no_grad():
        for t, s in zip(state, saved):
            t.copy_(s)
    prof = profile_deep_window(dw, frame, first, n)
    busy_it = prof["busy_us"] / n
    span_it = statistics.mean(spans) * 1e3
    return dict(prof, spans_ms=spans, busy_us_per_iteration=busy_it,
                span_us_per_iteration=span_it, idle=1.0 - busy_it / span_it,
                per_iteration={k: prof[k] / n for k in (
                    "kernels", "gemm_us", "adam_us", "adam_kernels",
                    "forward_us", "forward_kernels")})


def window_line(prof: dict, n: int) -> str:
    """The log text of deep_window's figures."""
    it = prof["per_iteration"]
    return (f"{it['kernels']:.1f} device kernels per iteration, device busy "
            f"{prof['busy_us_per_iteration']:.2f} us per iteration under the "
            f"profiler against {prof['span_us_per_iteration']:.2f} us per "
            f"iteration on the device timeline of the unprofiled run ("
            + ", ".join(f"{s:.3f}" for s in prof["spans_ms"])
            + f" ms): idle share {prof['idle']:.4f}; cuBLAS kernels "
            f"{prof['gemm_kernels']} ({it['gemm_us']:.2f} us per iteration); "
            f"Adam {it['adam_us']:.2f} us ({it['adam_kernels']:.0f} kernels) "
            f"and forward_relative {it['forward_us']:.2f} us "
            f"({it['forward_kernels']:.0f} kernels) of device time per "
            f"iteration; {prof['loops']} minibatch loops profiled over {n} "
            f"iterations, host syncs inside them {prof['syncs_in_loop']}, "
            f"device-to-host copies {prof['d2h']} ({prof['d2h_in_loop']} "
            f"issued inside them)")


def window_figures(prof: dict) -> dict:
    """deep_window's figures for results.json."""
    keys = ("per_iteration", "busy_us_per_iteration", "span_us_per_iteration",
            "idle", "spans_ms", "loops", "gemm_kernels", "d2h")
    return {k: prof[k] for k in keys}


def check_learning(tag: str, frames, net, dl) -> None:
    """Logs each neural-q learning frame the CLI ran and holds them:
    epsilon at its closed form after the frames, every frame moved the
    net, finite weights and loss, zclp not rising."""
    for i, fr in enumerate(frames):
        log(f"{tag} learning frame {i}: {fr['seconds']:.4f} s, "
            f"{fr['iterations']} iterations, phases "
            + " ".join(f"{n}@{w}" for w, n in zip(fr["phase_widths"],
                                                 fr["phase_iterations"]))
            + f", avg path {fr['avg_path']:.4f}, zclp {fr['zclp']}, loss "
            f"{fr['loss']:.6g}, loss_rel {fr['loss_rel']:.6g}, epsilon "
            f"{fr['epsilon']!r}, largest weight change {fr['moved']:.4g}")
    eps = np.float32(dl.epsilon_start)
    for _ in frames:
        eps = max(eps - np.float32(dl.epsilon_decay * 1),
                  np.float32(dl.epsilon_min))
    check(frames[-1]["epsilon"] == float(eps),
          f"{tag} epsilon {frames[-1]['epsilon']!r} != closed form "
          f"{float(eps)!r}")
    check(all(fr["moved"] > 0 for fr in frames), f"{tag} the net did not "
                                                  f"move")
    check(all(bool(torch.isfinite(p).all()) for p in net.parameters()),
          f"{tag} non-finite weights")
    check(all(np.isfinite(fr["loss"]) and np.isfinite(fr["loss_rel"])
              for fr in frames), f"{tag} loss not finite")
    check(frames[-1]["zclp"] <= frames[0]["zclp"],
          f"{tag} zclp rose: {frames[0]['zclp']} -> {frames[-1]['zclp']}")


def hold_recorded(tag: str, rec) -> None:
    """B4a on a deep loop's own rays: each call a HitRecorder kept, held
    bit for bit against the brute-force twin (closest_hit_plain) and the
    plain BVH walk (closest_hit_bvh_plain)."""
    from rlrpt_tpu_torch.ops import intersect_pallas as ip
    from rlrpt_tpu_torch.ops.bvh import closest_hit_bvh_plain
    for key, (o, d, tris, mat, m, bvh) in rec.calls.items():
        k_out = ip.closest_hit_mat_mxu(o, d, tris, mat, m, bvh)
        torch.cuda.synchronize()
        for twin, p_out in (
                ("brute-force twin", ip.closest_hit_plain(o, d, tris, int(m),
                                                          mat)),
                ("plain walk", closest_hit_bvh_plain(o, d, bvh, int(m),
                                                     mat)[:3])):
            for a, b in zip(k_out, p_out):
                check(torch.equal(a, b), f"{tag} B4a call {key}: kernel and "
                                         f"{twin} differ on the path's rays")
        log(f"{tag} B4a call {key} ({o.shape[0]} slots, active_count "
            f"{int(m)}, {tris.shape[0]} triangles): t, index and material "
            f"rows bit-equal to the brute-force twin and the plain walk, "
            f"{float((k_out[0] < 1e38).float().mean()):.4f} hit")
    check(any(o.shape[0] >= 64_800 for o, *_ in rec.calls.values()),
          f"{tag}: no full-width B4a call recorded")


def noise_gap(a, b, c) -> tuple:
    """(mean |a - b|, mean |c - a|): a frame's seed-to-seed noise and
    another estimator's distance from it."""
    return (float((a - b).abs().mean()), float((c - a).abs().mean()))

def hold_means(label: str, img, ref, pairs, grid: int) -> dict:
    """Holds img's frame mean and its grid x grid block means to ref's,
    each in standard errors of the difference.  Pixels are independent,
    so the variance of a mean over pixels is the sum of the pixels'
    variances over the count squared; a pixel's variance in one frame
    is (a - b)^2 / 2 for a seed pair (a, b) of one estimator.  pairs:
    ref's estimator's pair (img's variance taken as the same), or
    ref's and then img's.  Fails if the frame mean lies 4 or more
    standard errors off, or the blocks' mean squared z is 2 or more
    (about 1 for frames of one estimator)."""
    lum = lambda x: x.double().mean(-1)  # noqa: E731
    var = [(lum(a) - lum(b)) ** 2 / 2 for a, b in pairs]
    var = 2 * var[0] if len(var) == 1 else var[0] + var[1]
    d = lum(img) - lum(ref)
    h = d.shape[0] // grid
    blocks = lambda x: x.reshape(grid, h, grid, h).sum((1, 3))  # noqa: E731
    z = float(d.sum() / var.sum().sqrt())
    zb = blocks(d) / blocks(var).sqrt()
    # a block that no seed changes (inside the light) must not change
    zb = torch.where(zb.isnan(), 0.0, zb)
    chi2, zmax = float((zb ** 2).mean()), float(zb.abs().max())
    rel = float(lum(img).mean() / lum(ref).mean() - 1.0)
    log(f"{label}: frame mean {rel:+.4%} off, z {z:+.3f} (limit 4); "
        f"{grid}x{grid} block means: mean squared z {chi2:.4f} (limit "
        f"2), largest |z| {zmax:.3f}")
    check(abs(z) < 4.0 and chi2 < 2.0,
          f"{label}: frame or block means apart (z {z}, chi2 {chi2})")
    return {"rel": rel, "z": z, "block_chi2": chi2, "block_zmax": zmax}


def deep_phases(dev, out_dir: Path, drive, mega_mean: float,
                size: int = 720, small: int = 128) -> dict:
    """Phases 14-17, the deep-Q family; returns their figures.  ``drive``
    runs a path with every launch count at 0 and fails it if an expected
    kernel never launched; ``mega_mean`` is the mean of a ``--mode mega``
    frame at size x size, 32 spp.  Phase 11 left the learned fine map and
    16 probe points in ``out_dir``."""
    from rlrpt_tpu_torch.camera import Camera
    from rlrpt_tpu_torch.config import (DeepLearningConfig,
                                        RadianceVolumeConfig, RenderConfig)
    from rlrpt_tpu_torch.deep import deep_wavefront as dw
    from rlrpt_tpu_torch.nn.dynet_io import load_dynet_model
    from rlrpt_tpu_torch.ops import intersect_pallas as ip
    from rlrpt_tpu_torch.scene import cornell_box
    from rlrpt_tpu_torch.scene.scene import save_vertices_to_file
    from rlrpt_tpu_torch.tools import render
    from rlrpt_tpu_torch.utils.image import write_png

    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "float32 matmuls would run in TF32")
    scene = cornell_box(device=dev)
    camera = Camera.create(CAM)
    rl, dl = RadianceVolumeConfig(), DeepLearningConfig()
    res = {}

    def run_cli(argv):
        sync(dev)
        t0 = time.perf_counter()
        img, aux = render.render(render.build_parser().parse_args(
            [str(a) for a in argv] + ["--device", dev.type]))
        sync(dev)
        return img, aux, time.perf_counter() - t0

    # ---- 14: neural-q on the wavefront at full width --------------------
    model = out_dir / "neural_q.model"
    n_learn = 2
    log(f"[14] neural-q wavefront: Cornell {size}x{size}, 80 bounces, pix_mux "
        f"8, {n_learn} learning frames x 1 spp, the 342-200-300-200-144 net "
        f"trained online (Adam per 4096-ray minibatch), then --save-model; "
        f"TF32 off (allow_tf32 {torch.backends.cuda.matmul.allow_tf32})")
    # B4a on the path's own rays: the frames' calls 12 (width 64,800) and
    # the last two are kept (three clones an iteration, against ~4,000
    # kernels)
    rec = HitRecorder(dw.closest_hit_mat_mxu, at=(12,))
    dw.closest_hit_mat_mxu = rec
    try:
        img, aux, sec = drive("14", ("B4a",), lambda: run_cli([
            "--mode", "neural-q", "--impl", "wavefront", "--frames",
            n_learn, "--spp", 1, "--width", size, "--height", size,
            "--bounces", 80, "--pix-mux", 8, "--seed", 1984,
            "--save-model", model]))
    finally:
        dw.closest_hit_mat_mxu = rec.fn
    b4a_learn = ip.KERNEL_MAT.launches
    frames, net, opt_state = aux["frames"], aux["net"], aux["opt_state"]
    trained = [p.detach().clone() for p in net.parameters()]
    check_image("neural-q frame", img, size)
    check_learning("[14]", frames, net, dl)
    check(model.exists(), "--save-model wrote nothing")
    learn_s = [fr["seconds"] for fr in frames]
    iters = [fr["iterations"] for fr in frames]
    log(f"[14] {b4a_learn} B4a launches in {n_learn} frames; "
        f"{statistics.median(learn_s):.4f} s per learning frame (median), "
        f"{sum(learn_s) / sum(iters) * 1e3:.4f} ms per iteration; epsilon "
        f"{frames[-1]['epsilon']!r} == the closed form; CLI {sec:.4f} s")
    hold_recorded("[14]", rec)

    cfg = RenderConfig(width=size, height=size, samples_per_pixel=1,
                       max_ray_bounces=80)
    eps = frames[-1]["epsilon"]

    def train_frame(seed, **kw):
        return dw.render_frame_neural_q_wavefront(
            torch.Generator(device=dev).manual_seed(seed), scene, camera, net,
            opt_state, eps, cfg, rl, dl, pix_mux=8, **kw)

    # the idle share of iterations 10-14 (full width) of a frame, seed 2002
    # from the same weights and Adam state, run twice and ended after them
    first, n_win = 10, 5
    prof = deep_window(dw, net, opt_state, lambda: train_frame(2002), first,
                       n_win)
    width = cfg.n_pixels // 8
    log(f"[14] iterations {first}-{first + n_win - 1} of a learning frame "
        f"(width {width}, {-(-width // dl.batch_size)} minibatches each), "
        f"seed 2002 run twice from the same state, each ended after them: "
        + window_line(prof, n_win))
    check(prof["loops"] >= n_win and prof["kernels"] > 0,
          "the profiled window holds no minibatch loop or kernel")
    check(not prof["syncs_in_loop"] and not prof["d2h_in_loop"],
          f"the minibatch loop synchronised: {prof['syncs_in_loop']}")

    # the MLP at full width: one forward over 64,800 positions, its f32
    # bound, and the training iteration's (forward, then forward and
    # backward over the same rows: 4 forwards' work)
    rows = cfg.n_pixels // 8
    pos = torch.as_tensor(np.random.default_rng(14).uniform(
        -0.9, 0.9, (rows, 3)).astype(np.float32), device=dev)
    verts = scene.vertices_flat
    with torch.no_grad():
        fwd_ms = kernel_ms(lambda: net.forward_relative(verts, pos), 20)
    sizes = [3, 200, 300, 200, 144]
    macs = sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))
    fwd_bound, fwd_by = bound_ms(2.0 * rows * macs, 4 * (
        rows * (3 + 144) + sum(a * b + b for a, b in zip(
            [342] + sizes[1:-1], sizes[1:]))))
    log(f"[14] MLP forward over {rows} positions ({macs} MACs a row, "
        f"{2 * rows * macs / 1e9:.4f} GFLOP): {fwd_ms:.4f} ms, f32 bound "
        f"{fwd_bound:.4f} ms ({fwd_by}); a training iteration at that "
        f"width: bound {4 * fwd_bound:.4f} ms, cuBLAS device time "
        f"{prof['per_iteration']['gemm_us'] / 1e3:.4f} ms")

    def fused():
        sync(dev)
        t0 = time.perf_counter()
        before = [p.detach().clone() for p in net.parameters()]
        out = train_frame(2003, train_batching="fused")
        sync(dev)
        return out, before, time.perf_counter() - t0

    (f_img, _, _, f_eps, f_aux), before, f_sec = drive("14", ("B4a",), fused)
    check_image("neural-q fused frame", f_img, size)
    f_moved = max(float((p.detach() - b).abs().max())
                  for p, b in zip(net.parameters(), before))
    check(np.isfinite(float(f_aux["loss"])) and f_moved > 0,
          "the fused frame did not train")
    log(f"[14] train_batching fused: {f_sec:.4f} s, "
        f"{int(f_aux['wavefront_iterations'])} iterations, zclp "
        f"{int(f_aux['zero_contribution_light_paths'])}, loss_rel "
        f"{float(f_aux['loss_rel']):.6g}, largest weight change "
        f"{f_moved:.4g}")
    res["neural_q"] = {
        "frames": frames, "b4a_launches": b4a_learn, "cli_seconds": sec,
        "window_iterations": [first, first + n_win - 1],
        "window": window_figures(prof),
        "forward_ms": fwd_ms, "forward_bound_ms": fwd_bound,
        "fused_seconds": f_sec,
        "fused_iterations": int(f_aux["wavefront_iterations"])}

    # ---- 15: pretrained on the wavefront from the saved file ------------
    loaded = load_dynet_model(str(model), device=dev)
    check(all(torch.equal(a, b) for a, b in zip(loaded.parameters(),
                                                 trained)),
          "the DyNet file does not give back the trained weights")
    log(f"[15] pretrained wavefront from {model.name} (load_dynet_model on "
        f"the card gives back the trained weights bit for bit): {size}x"
        f"{size}, {PRETRAINED_SPP} spp, pix_mux 8")
    pre, secs_p = {}, {}
    for label, argv in (("f32", ["--mlp-dtype", "f32", "--seed", 1984]),
                        ("f32-seed2", ["--mlp-dtype", "f32", "--seed", 1985]),
                        ("bf16", ["--mlp-dtype", "bf16", "--seed", 1986])):
        img, p_aux, sec = drive("15", ("B4a",), lambda: run_cli([
            "--mode", "pretrained", "--impl", "wavefront", "--model", model,
            "--width", size, "--height", size, "--spp", PRETRAINED_SPP,
            "--bounces", 80, "--pix-mux", 8] + argv))
        check_image(f"pretrained {label}", img, size)
        apl = float(p_aux["avg_path_length"])
        rays = apl * size * size * PRETRAINED_SPP / sec
        pre[label], secs_p[label] = img, sec
        write_png(str(out_dir / f"pretrained-{label}.png"), img.cpu())
        log(f"[15] {label}: {sec:.4f} s, "
            f"{int(p_aux['wavefront_iterations'])} iterations, avg path "
            f"{apl:.4f}, {rays:.6g} rays/s, mean {float(img.mean()):.6f} "
            f"vs mega {mega_mean:.6f} ({(float(img.mean()) - mega_mean) / mega_mean:+.4%})")
        res.setdefault("pretrained", {})[label] = {
            "seconds": sec, "rays_per_s": rays, "avg_path": apl,
            "iterations": int(p_aux["wavefront_iterations"]),
            "mean": float(img.mean())}
    noise, err = noise_gap(pre["f32"], pre["f32-seed2"], pre["bf16"])
    log(f"[15] bf16 vs f32: mean |diff| {err:.6f}, f32 seed-to-seed "
        f"{noise:.6f} (limit 3x + 1e-3)")
    res["pretrained"]["bf16_vs_f32"] = hold_means(
        "[15] bf16 vs f32", pre["bf16"], pre["f32"],
        [(pre["f32"], pre["f32-seed2"])], 8)
    # a sector whose Q the output ReLU zeroes is never sampled, so its
    # light is never gathered: the share of such entries at 20,000 random
    # surface points (area-weighted, numpy seed 15)
    from rlrpt_tpu_torch.scene.geometry import sample_points_on_triangles
    from rlrpt_tpu_torch.scene.scene import surface_areas
    ns = scene.n_surfaces
    rng = np.random.default_rng(15)
    s_area = surface_areas(scene)
    host = lambda a: a[:ns].cpu().numpy().astype(np.float64)  # noqa: E731
    pts, _ = sample_points_on_triangles(
        rng, host(scene.v0), host(scene.v1), host(scene.v2),
        rng.multinomial(20_000, s_area / s_area.sum()))
    with torch.no_grad():
        q = loaded.forward_relative(scene.vertices_flat, torch.as_tensor(
            pts, dtype=torch.float32, device=dev))
    zero_q = float((q == 0).float().mean())
    log(f"[15] the trained net's Q at 20,000 surface points: {zero_q:.4f} "
        f"of the entries are 0 (never sampled), "
        f"{float((q.sum(-1) == 0).float().mean()):.4f} of the rows")
    res["pretrained"]["zero_q_share"] = zero_q
    check(err < 3.0 * noise + 1e-3, f"bf16 frame off by {err} (noise "
                                    f"{noise})")
    # The reference estimator renders pretrained frames dark (zero-Q
    # sectors are never drawn): JAX 5.62% +- 0.53% below its default on
    # the same net, the port 4.96-4.99% (ROADMAP C).  A band of -8% to -2%
    # around that holds the frame mean, which a 0.7x per-bounce factor
    # (tens of percent darker) leaves far behind; the CPU test at 24x24
    # cannot see it.
    for label in ("f32", "f32-seed2"):
        rel = res["pretrained"][label]["mean"] / mega_mean - 1.0
        log(f"[15] {label} frame mean vs mega {rel:+.4%} (band "
            f"{PRETRAINED_BAND[0]:+.0%} to {PRETRAINED_BAND[1]:+.0%})")
        check(PRETRAINED_BAND[0] <= rel <= PRETRAINED_BAND[1],
              f"pretrained {label} frame mean {rel:+.4%} from mega, outside "
              f"{PRETRAINED_BAND}")

    # ---- 16: the lockstep tracers at a smaller size ---------------------
    sm = ["--width", small, "--height", small, "--spp", 1, "--bounces", 80]
    img, l_aux, l_sec = drive("16", ("B4a",), lambda: run_cli(
        ["--mode", "neural-q", "--impl", "lockstep", "--frames", 1,
         "--seed", 7] + sm))
    check_image("lockstep neural-q", img, small)
    l_fr = l_aux["frames"][0]
    check(np.isfinite(l_fr["loss"]) and l_fr["moved"] > 0,
          "the lockstep frame did not train")
    log(f"[16] lockstep neural-q {small}x{small} 1 spp: {l_sec:.4f} s, loss "
        f"{l_fr['loss']:.6g}, avg path {l_fr['avg_path']:.4f}, zclp "
        f"{l_fr['zclp']}")
    lock = {}
    for label, argv in (("lockstep", ["--impl", "lockstep", "--seed", 1984]),
                        ("lockstep-seed2", ["--impl", "lockstep", "--seed",
                                            1985]),
                        ("wavefront", ["--impl", "wavefront", "--pix-mux", 8,
                                       "--seed", 1984]),
                        ("wavefront-seed2", ["--impl", "wavefront",
                                             "--pix-mux", 8, "--seed",
                                             1985])):
        img, _, sec = drive("16", ("B4a",), lambda: run_cli(
            ["--mode", "pretrained", "--model", model] + argv + sm))
        check_image(f"pretrained {label} {small}", img, small)
        lock[label] = img
        log(f"[16] pretrained {label} {small}x{small} 1 spp: {sec:.4f} s, "
            f"mean {float(img.mean()):.6f}")
    noise, err = noise_gap(lock["lockstep"], lock["lockstep-seed2"],
                           lock["wavefront"])
    log(f"[16] wavefront vs lockstep: mean |diff| {err:.6f}, lockstep "
        f"seed-to-seed {noise:.6f} (limit 3x + 1e-3)")
    check(err < 3.0 * noise + 1e-3, f"lockstep and wavefront differ by "
                                    f"{err} (noise {noise})")
    gap = hold_means("[16] wavefront vs lockstep", lock["wavefront"],
                     lock["lockstep"],
                     [(lock["lockstep"], lock["lockstep-seed2"]),
                      (lock["wavefront"], lock["wavefront-seed2"])], 4)
    res["lockstep"] = {"neural_q_seconds": l_sec, "err": err, "noise": noise,
                       "wavefront_vs_lockstep": gap}

    # ---- 17: the offline pipeline: distill, then probe ------------------
    verts_path, distilled = out_dir / "vertices.txt", out_dir / "distilled.model"
    save_vertices_to_file(scene, str(verts_path))
    _, d_aux, d_sec = drive("17", (), lambda: run_cli([
        "--mode", "distill", "--load-q", out_dir / "q_fine_map.txt",
        "--vertices", verts_path, "--epochs", 10, "--save-model",
        distilled]))
    hist = d_aux["history"]
    n_rows = len((out_dir / "q_fine_map.txt").read_text().splitlines()) - 1
    log(f"[17] distill of phase 11's map ({n_rows} volume rows, 80/20 split, "
        f"batch 128): "
        f"{d_sec:.4f} s for 10 epochs; test MSE "
        + " ".join(f"{h[2]:.6g}" for h in hist))
    check(hist[-1][2] < hist[0][2], "distillation test MSE did not fall")
    sel = out_dir / "selected_deep.txt"
    drive("17", (), lambda: run_cli([
        "--mode", "q-probe", "--model", distilled, "--probe",
        out_dir / "probes.txt", "--out-probe", sel]))
    rows = np.loadtxt(sel)
    sums = rows[:, 6:].sum(-1)
    # a row the output ReLU zeroes in every sector stays zero (the JAX
    # writer's choice; the reference divides by zero there)
    norm = np.abs(sums - 1.0) <= 1e-4
    log(f"[17] q-probe at 16 lit volumes of the map: rows {rows.shape}, "
        f"{int(norm.sum())} sum to 1 within 1e-4, {int((sums == 0).sum())} "
        f"all zero; sums {' '.join(f'{x:.6f}' for x in sums)}")
    check(rows.shape == (16, 150) and np.all(norm | (sums == 0))
          and norm.sum() >= 12, "q-probe rows do not sum to 1")
    res["distill"] = {"seconds": d_sec, "history": hist}
    return res


def obj_deep_phase(dev, out_dir: Path, drive, preset, cornell_window: dict,
                   size: int = 720, small: int = 128, spp: int = 4) -> dict:
    """Phase 22: the deep-Q family on phase 18's generated OBJ (its preset,
    registered for --scene; 4,980 triangles, so the relative-vertex input
    is 44,820 wide), through the CLI at size x size, 80 bounces, pix_mux
    8, TF32 off: two 1-spp learning frames of the 44,820-200-300-200-144
    net and --save-model (B4a held to both twins on three of the frames'
    calls; every layer moved), a profiled window of full-width iterations
    (Adam and forward_relative device time beside ``cornell_window``,
    phase 14's), the DyNet file's save and load (bit for bit), pretrained
    frames at ``spp`` in f32 (two seeds, within the band below
    ``--mode mega``'s mean at the same spp) and bf16 (held to f32), the
    zero-Q share, the lockstep tracers at small x small (held to the
    wavefront), distill and q-probe of phase 18's OBJ fine map (the
    q-probe rows those of the net, summing to 1 or all 0), and q-probe of
    the trained net at the same volumes (every row sums to 1).
    ``drive`` runs a path with every launch count at 0 and fails it if an
    expected kernel never launched.  Returns the phase's figures."""
    from rlrpt_tpu_torch.camera import Camera
    from rlrpt_tpu_torch.config import (DeepLearningConfig,
                                        RadianceVolumeConfig, RenderConfig)
    from rlrpt_tpu_torch.deep import deep_wavefront as dw
    from rlrpt_tpu_torch.deep import neural_q as nq
    from rlrpt_tpu_torch.deep.q_probe import probe_q_values
    from rlrpt_tpu_torch.nn import dynet_io
    from rlrpt_tpu_torch.radiance.map_io import load_radiance_map_data
    from rlrpt_tpu_torch.scene.geometry import sample_points_on_triangles
    from rlrpt_tpu_torch.scene.scene import (save_vertices_to_file,
                                             surface_areas)
    from rlrpt_tpu_torch.tools import render
    from rlrpt_tpu_torch.utils.image import write_png

    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "float32 matmuls would run in TF32")
    obj = preset.load(device=dev)
    camera = Camera.create(preset.camera_position)
    rl, dl = RadianceVolumeConfig(), DeepLearningConfig()
    n_in, res = obj.vertices_count, {}

    def run_cli(argv):
        sync(dev)
        t0 = time.perf_counter()
        img, aux = render.render(render.build_parser().parse_args(
            [str(a) for a in argv] + ["--scene", preset.name, "--device",
                                      dev.type, "--bounces", "80"]))
        sync(dev)
        return img, aux, time.perf_counter() - t0

    wide = ["--width", size, "--height", size]
    log(f"[22] deep-Q on the generated OBJ {preset.name}: {obj.n_triangles} "
        f"triangles, the {n_in}-200-300-200-144 net; {size}x{size}, 80 "
        f"bounces, pix_mux 8; TF32 off (allow_tf32 "
        f"{torch.backends.cuda.matmul.allow_tf32})")
    check(n_in == 9 * obj.n_triangles, "the input is not 9T wide")

    # the reference frames: --mode mega (culled) at the pretrained spp,
    # a seed pair for the standard error of their mean
    mega = []
    for seed in (1984, 1985):
        img, _, _ = drive("22", ("B1 culled",), lambda: run_cli(
            ["--mode", "mega", "--spp", spp, "--seed", seed] + wide))
        check_image("OBJ mega", img, size)
        mega.append(img)
    mega_mean = float(mega[0].mean())

    # ---- learning: 2 frames through the CLI, then --save-model ----------
    model = out_dir / "neural_q_torus_room.model"
    n_learn = 2
    init, saves = {}, []
    init_fn, save_fn = nq.init_neural_q, dynet_io.save_dynet_model

    def keep_init(*a, **k):
        net, state = init_fn(*a, **k)
        init["params"] = [p.detach().clone() for p in net.parameters()]
        return net, state

    def timed_save(net, path):
        sync(dev)
        t0 = time.perf_counter()
        save_fn(net, path)
        saves.append(time.perf_counter() - t0)

    rec = HitRecorder(dw.closest_hit_mat_mxu, at=(12,))
    torch.cuda.reset_peak_memory_stats()
    nq.init_neural_q, dynet_io.save_dynet_model = keep_init, timed_save
    dw.closest_hit_mat_mxu = rec
    try:
        img, aux, sec = drive("22", ("B4a",), lambda: run_cli([
            "--mode", "neural-q", "--impl", "wavefront", "--frames",
            n_learn, "--spp", 1, "--pix-mux", 8, "--seed", 1984,
            "--save-model", model] + wide))
    finally:
        nq.init_neural_q, dynet_io.save_dynet_model = init_fn, save_fn
        dw.closest_hit_mat_mxu = rec.fn
    peak = torch.cuda.max_memory_allocated()
    frames, net, opt_state = aux["frames"], aux["net"], aux["opt_state"]
    trained = [p.detach().clone() for p in net.parameters()]
    check_image("OBJ neural-q frame", img, size)
    check_learning("[22]", frames, net, dl)
    first_w = tuple(net.layers[0].weight.shape)
    check(first_w == (200, n_in), f"the first layer is {first_w}")
    moved = [float((p - q).abs().max())
             for p, q in zip(trained, init["params"])]
    check(all(m > 0 for m in moved), f"a layer did not move: {moved}")
    check(model.exists() and len(saves) == n_learn,
          "--save-model wrote nothing")
    learn_s = [fr["seconds"] for fr in frames]
    iters = [fr["iterations"] for fr in frames]
    log(f"[22] {n_learn} learning frames: "
        + ", ".join(f"{s:.4f} s ({n} iterations)"
                    for s, n in zip(learn_s, iters))
        + f", {sum(learn_s) / sum(iters) * 1e3:.4f} ms per iteration; first "
        f"layer {first_w}; every layer moved (largest change per tensor "
        + " ".join(f"{m:.3g}" for m in moved) + f"); epsilon "
        f"{frames[-1]['epsilon']!r} == the closed form; peak "
        f"torch.cuda.max_memory_allocated {peak / 2 ** 30:.3f} GiB; CLI "
        f"{sec:.4f} s (the --save-model writes after each frame included)")
    hold_recorded("[22]", rec)
    del rec

    # ---- a profiled window of full-width iterations -----------------------
    cfg = RenderConfig(width=size, height=size, samples_per_pixel=1,
                       max_ray_bounces=80)
    eps = frames[-1]["epsilon"]
    first, n_win = 10, 5
    prof = deep_window(dw, net, opt_state, lambda: (
        dw.render_frame_neural_q_wavefront(
            torch.Generator(device=dev).manual_seed(2202), obj, camera, net,
            opt_state, eps, cfg, rl, dl, pix_mux=8)), first, n_win)
    log(f"[22] iterations {first}-{first + n_win - 1} of a learning frame "
        f"(width {cfg.n_pixels // 8}), run twice from the same state, each "
        f"ended after them: " + window_line(prof, n_win))
    check(prof["loops"] >= n_win and prof["kernels"] > 0,
          "the profiled window holds no minibatch loop or kernel")
    check(not prof["syncs_in_loop"] and not prof["d2h_in_loop"],
          f"the minibatch loop synchronised: {prof['syncs_in_loop']}")
    it, cw = prof["per_iteration"], cornell_window["per_iteration"]
    log(f"[22] per iteration against Cornell's 342-wide net (phase 14): "
        f"Adam {it['adam_us']:.2f} us vs {cw['adam_us']:.2f} us "
        f"({it['adam_us'] / cw['adam_us']:.2f}x), forward_relative "
        f"{it['forward_us']:.2f} us vs {cw['forward_us']:.2f} us "
        f"({it['forward_us'] / cw['forward_us']:.2f}x), cuBLAS "
        f"{it['gemm_us']:.2f} us vs {cw['gemm_us']:.2f} us, device busy "
        f"{prof['busy_us_per_iteration']:.2f} us vs "
        f"{cornell_window['busy_us_per_iteration']:.2f} us, idle share "
        f"{prof['idle']:.4f} vs {cornell_window['idle']:.4f}")

    # ---- the DyNet file: save and load --------------------------------------
    sync(dev)
    t0 = time.perf_counter()
    loaded = dynet_io.load_dynet_model(str(model), device=dev)
    sync(dev)
    load_s = time.perf_counter() - t0
    check(all(torch.equal(a, b) for a, b in zip(loaded.parameters(),
                                                 trained)),
          "the DyNet file does not give back the trained weights")
    n_bytes = model.stat().st_size
    log(f"[22] {model.name}: {n_bytes} bytes, "
        f"{sum(p.numel() for p in loaded.parameters())} weights; save "
        + ", ".join(f"{s:.3f}" for s in saves) + f" s, load {load_s:.3f} s; "
        f"load_dynet_model on the card gives back the trained weights bit "
        f"for bit")
    res["learning"] = {
        "frames": frames, "cli_seconds": sec, "peak_bytes": peak,
        "first_layer": first_w, "moved": moved, "window":
        window_figures(prof), "save_seconds": saves, "load_seconds": load_s,
        "model_bytes": n_bytes}

    # ---- pretrained frames from the saved file --------------------------------
    pre = {}
    for label, argv in (("f32", ["--mlp-dtype", "f32", "--seed", 1984]),
                        ("f32-seed2", ["--mlp-dtype", "f32", "--seed", 1985]),
                        ("bf16", ["--mlp-dtype", "bf16", "--seed", 1986])):
        img, p_aux, p_sec = drive("22", ("B4a",), lambda: run_cli([
            "--mode", "pretrained", "--impl", "wavefront", "--model", model,
            "--spp", spp, "--pix-mux", 8] + argv + wide))
        check_image(f"OBJ pretrained {label}", img, size)
        pre[label] = img
        write_png(str(out_dir / f"torus_room-pretrained-{label}.png"),
                  img.cpu())
        mean = float(img.mean())
        log(f"[22] pretrained {label} {spp} spp: {p_sec:.4f} s (the model's "
            f"load included), {int(p_aux['wavefront_iterations'])} "
            f"iterations, avg path {float(p_aux['avg_path_length']):.4f}, "
            f"mean {mean:.6f} vs mega {mega_mean:.6f} "
            f"({mean / mega_mean - 1:+.4%})")
        res.setdefault("pretrained", {})[label] = {
            "seconds": p_sec, "mean": mean,
            "iterations": int(p_aux["wavefront_iterations"])}
    # the band: below --mode mega's mean by less than 10%, and not above it
    # by 4 standard errors (each estimator's pixel variance from its seed
    # pair); the reference estimator's zero-Q sectors darken it (ROADMAP C)
    lum = lambda x: x.double().mean(-1)  # noqa: E731
    var = ((lum(pre["f32"]) - lum(pre["f32-seed2"])) ** 2 / 2
           + (lum(mega[0]) - lum(mega[1])) ** 2 / 2).sum()
    for label in ("f32", "f32-seed2"):
        rel = res["pretrained"][label]["mean"] / mega_mean - 1.0
        z = float((lum(pre[label]) - lum(mega[0])).sum() / var.sqrt())
        log(f"[22] {label} frame mean vs mega at {spp} spp {rel:+.4%}, z "
            f"{z:+.2f} (band: above -10%, z below 4)")
        check(rel > -0.10 and z < 4.0, f"OBJ pretrained {label} mean "
                                       f"{rel:+.4%} (z {z:+.2f}) from mega")
        res["pretrained"][label].update(vs_mega=rel, z=z)
    noise, err = noise_gap(pre["f32"], pre["f32-seed2"], pre["bf16"])
    log(f"[22] bf16 vs f32: mean |diff| {err:.6f}, f32 seed-to-seed "
        f"{noise:.6f} (limit 3x + 1e-3)")
    res["pretrained"]["bf16_vs_f32"] = hold_means(
        "[22] bf16 vs f32", pre["bf16"], pre["f32"],
        [(pre["f32"], pre["f32-seed2"])], 8)
    check(err < 3.0 * noise + 1e-3, f"bf16 frame off by {err} (noise "
                                    f"{noise})")
    # the zero-Q share at 20,000 surface points, as phase 15 counts it
    ns = obj.n_surfaces
    rng = np.random.default_rng(22)
    s_area = surface_areas(obj)
    host = lambda a: a[:ns].cpu().numpy().astype(np.float64)  # noqa: E731
    pts, _ = sample_points_on_triangles(
        rng, host(obj.v0), host(obj.v1), host(obj.v2),
        rng.multinomial(20_000, s_area / s_area.sum()))
    with torch.no_grad():
        q = loaded.forward_relative(obj.vertices_flat, torch.as_tensor(
            pts, dtype=torch.float32, device=dev))
    zero_q = float((q == 0).float().mean())
    log(f"[22] the trained net's Q at 20,000 surface points: {zero_q:.4f} "
        f"of the entries are 0 (never sampled), "
        f"{float((q.sum(-1) == 0).float().mean()):.4f} of the rows")
    res["pretrained"]["zero_q_share"] = zero_q

    # ---- the lockstep tracers at a smaller size -----------------------------
    sm = ["--width", small, "--height", small, "--spp", 1]
    img, l_aux, l_sec = drive("22", ("B4a",), lambda: run_cli(
        ["--mode", "neural-q", "--impl", "lockstep", "--frames", 1,
         "--seed", 7] + sm))
    check_image("OBJ lockstep neural-q", img, small)
    l_fr = l_aux["frames"][0]
    check(np.isfinite(l_fr["loss"]) and l_fr["moved"] > 0,
          "the lockstep frame did not train")
    log(f"[22] lockstep neural-q {small}x{small} 1 spp: {l_sec:.4f} s, loss "
        f"{l_fr['loss']:.6g}, avg path {l_fr['avg_path']:.4f}, zclp "
        f"{l_fr['zclp']}")
    lock = {}
    for label, argv in (("lockstep", ["--impl", "lockstep", "--seed", 1984]),
                        ("lockstep-seed2", ["--impl", "lockstep", "--seed",
                                            1985]),
                        ("wavefront", ["--impl", "wavefront", "--pix-mux", 8,
                                       "--seed", 1984]),
                        ("wavefront-seed2", ["--impl", "wavefront",
                                             "--pix-mux", 8, "--seed",
                                             1985])):
        img, _, l_s = drive("22", ("B4a",), lambda: run_cli(
            ["--mode", "pretrained", "--model", model] + argv + sm))
        check_image(f"OBJ pretrained {label} {small}", img, small)
        lock[label] = img
        log(f"[22] pretrained {label} {small}x{small} 1 spp: {l_s:.4f} s, "
            f"mean {float(img.mean()):.6f}")
    noise, err = noise_gap(lock["lockstep"], lock["lockstep-seed2"],
                           lock["wavefront"])
    log(f"[22] wavefront vs lockstep: mean |diff| {err:.6f}, lockstep "
        f"seed-to-seed {noise:.6f} (limit 3x + 1e-3)")
    check(err < 3.0 * noise + 1e-3, f"OBJ lockstep and wavefront differ by "
                                    f"{err} (noise {noise})")
    res["lockstep"] = {"neural_q_seconds": l_sec, "err": err, "noise": noise,
                       "wavefront_vs_lockstep": hold_means(
                           "[22] wavefront vs lockstep", lock["wavefront"],
                           lock["lockstep"],
                           [(lock["lockstep"], lock["lockstep-seed2"]),
                            (lock["wavefront"], lock["wavefront-seed2"])],
                           4)}

    # ---- distill phase 18's OBJ fine map, then probe it --------------------
    q_table = out_dir / "q_torus_room.txt"
    verts_path = out_dir / "vertices_torus_room.txt"
    distilled = out_dir / "distilled_torus_room.model"
    save_vertices_to_file(obj, str(verts_path))
    _, d_aux, d_sec = drive("22", (), lambda: run_cli([
        "--mode", "distill", "--load-q", q_table, "--vertices", verts_path,
        "--epochs", 2, "--save-model", distilled]))
    hist = d_aux["history"]
    n_rows = len(q_table.read_text().splitlines()) - 1
    d_in = d_aux["net"].layers[0].weight.shape[1]
    log(f"[22] distill of phase 18's OBJ map ({n_rows} volume rows, 80/20 "
        f"split, batch 128, input {d_in} wide): {d_sec:.4f} s for 2 epochs "
        f"(the model's save included); train loss "
        + " ".join(f"{h[1]:.6g}" for h in hist) + "; test MSE "
        + " ".join(f"{h[2]:.6g}" for h in hist))
    check(d_in == n_in and all(np.isfinite(h[1]) and np.isfinite(h[2])
                               for h in hist) and len(hist) == 2,
          "distill: the input width or a loss is wrong")
    # the distilled net's output over every row of the map: a row whose
    # ReLU outputs are all 0 has no distribution (ROADMAP C)
    net_d = d_aux["net"]
    m_pos, m_q, _ = load_radiance_map_data(str(q_table))
    with torch.no_grad():
        m_out = net_d.forward_relative(obj.vertices_flat, torch.as_tensor(
            m_pos, device=dev))
    dead = float((m_out.sum(-1) == 0).float().mean())
    sel = out_dir / "selected_deep_torus_room.txt"
    probes = out_dir / "probes_torus_room.txt"
    drive("22", (), lambda: run_cli([
        "--mode", "q-probe", "--model", distilled, "--probe", probes,
        "--out-probe", sel]))
    rows = np.loadtxt(sel)
    sums = rows[:, 6:].sum(-1)
    norm = np.abs(sums - 1.0) <= 1e-4
    want = probe_q_values(net_d, obj, rows[:, :3])
    log(f"[22] the distilled net over the map's {n_rows} rows: "
        f"{dead:.4f} of them all 0 (the target rows' mean sum of squares "
        f"{float((m_q.astype(np.float64) ** 2).sum(-1).mean()):.6g}); "
        f"q-probe at 16 lit volumes: rows {rows.shape}, {int(norm.sum())} "
        f"sum to 1 within 1e-4, {int((sums == 0).sum())} all 0; sums "
        + " ".join(f"{x:.6f}" for x in sums))
    # a row the output ReLU zeroes in every sector stays zero (the JAX
    # writer's choice, as in phase 17); the rest sum to 1, and every row
    # is probe_q_values' at the file's 6 digits
    check(rows.shape == (16, 150) and bool(np.all(norm | (sums == 0)))
          and np.allclose(rows[:, 6:], want, rtol=1e-5, atol=1e-6),
          "q-probe rows do not sum to 1 or are not the net's")
    # the trained 44,820-input net at the same volumes: its rows are live
    # (none was all 0 at 20,000 surface points above), so each sums to 1
    sel_t = out_dir / "selected_neural_q_torus_room.txt"
    drive("22", (), lambda: run_cli([
        "--mode", "q-probe", "--model", model, "--probe", probes,
        "--out-probe", sel_t]))
    rows_t = np.loadtxt(sel_t)
    sums_t = rows_t[:, 6:].sum(-1)
    norm_t = np.abs(sums_t - 1.0) <= 1e-4
    want_t = probe_q_values(loaded, obj, rows_t[:, :3])
    log(f"[22] q-probe of the trained neural-q net at the same volumes: "
        f"rows {rows_t.shape}, {int(norm_t.sum())} sum to 1 within 1e-4; "
        f"sums " + " ".join(f"{x:.6f}" for x in sums_t))
    check(rows_t.shape == (16, 150) and bool(np.all(norm_t))
          and np.allclose(rows_t[:, 6:], want_t, rtol=1e-5, atol=1e-6),
          "the trained net's q-probe rows do not sum to 1 or are not the "
          "net's")
    res["distill"] = {"seconds": d_sec, "history": hist, "rows": n_rows,
                      "all_zero_share": dead,
                      "probe_rows_summing_to_1": int(norm.sum()),
                      "trained_probe_rows_summing_to_1": int(norm_t.sum())}
    return res


def event_ms(fn):
    """(device time of one fn() call in ms by CUDA events, its result)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def equal_frames(name: str, k_out, p_out, cfg) -> float:
    """compare(), and then the kernel's rad, path_sum and iters must be
    the twin's bit for bit."""
    err = compare(name, k_out, p_out, cfg)
    for n, a, b in zip(("rad", "path_sum", "iters"), k_out, p_out):
        check(torch.equal(a, b), f"{name}: {n} not bit-equal to the twin's")
    return err


def equal_hits(name: str, fn, o, d, tables, count, bvh) -> float:
    """A closest-hit launcher (walking ``bvh``) against the twin on the
    same rays: t, index (and rows) bit-equal, rays past ``count`` missed.
    Returns the largest absolute difference (0)."""
    from rlrpt_tpu_torch.ops import intersect_pallas as ip
    live = torch.tensor([count], dtype=torch.int32, device=o.device)
    k_out = fn(o, d, *tables, live, bvh=bvh)
    torch.cuda.synchronize()
    p_out = ip.closest_hit_plain(o, d, tables[0], count, *tables[1:])
    err = 0.0
    for a, b in zip(k_out, p_out):
        check(torch.equal(a, b), f"{name}: kernel and twin differ")
        err = max(err, float((a.double() - b.double()).abs().max()))
    check(bool((k_out[0][count:] >= 1e38).all()),
          f"{name}: a ray past active_count was traced")
    log(f"  {name}: {o.shape[0]} rays, count {count}: bit-equal, "
        f"{float((k_out[0][:count] < 1e38).float().mean()):.4f} hit")
    return err


# The build kernel's counted work (csrc/bvh_build.cu), float64 operations:
# a triangle's corners, box, centroid and largest |corner| once; its bins
# on three axes at every level it is in; a node's SAH (45 cuts of two
# areas and a cost, and the 16-bin scans of counts and boxes on 3 axes).
BUILD_TRI_OPS = 36
BUILD_ITEM_OPS = 6
BUILD_NODE_OPS = 1700
PEAK_F64 = 34e12   # H100 SXM float64 outside the tensor cores (data sheet)


def edge_tables() -> dict:
    """CPU tables of the build's edge cases, tests/test_torch_bvh_build.py's
    (T in {0, 1, 4, 5}, coincident centroids, zero areas, duplicates,
    negative zeros) and seeded soups up to 20,000 triangles, some on a
    coarse grid (ties in the bins and the SAH costs)."""
    def rows(v0, v1, v2):
        v0, v1, v2 = (np.asarray(a, np.float32).reshape(-1, 3)
                      for a in (v0, v1, v2))
        z = np.zeros((v0.shape[0], 1), np.float32)
        return torch.from_numpy(np.concatenate(
            [v0, z, v1 - v0, z, v2 - v0, z], axis=1))

    rng = np.random.default_rng(5)
    soup = rng.normal(size=(40, 3, 3))
    out = {f"soup of {n}": rows(soup[:n, 0], soup[:n, 1], soup[:n, 2])
           for n in (0, 1, 4, 5)}
    for n, seed in ((5, 1), (40, 2)):   # centroids all at c, exactly
        r = np.random.default_rng(seed)
        a, b = (r.integers(-64, 64, (n, 3)) / 64.0 for _ in range(2))
        c = np.array([0.25, -0.5, 0.125])
        out[f"{n} coincident centroids"] = rows(c + a, c + b, c - a - b)
    out["one triangle x 12"] = rows(*np.repeat(
        soup[:1].transpose(1, 0, 2), 12, axis=1))
    p, q = rng.normal(size=(20, 3)), rng.normal(size=(20, 3))
    out["zero areas"] = rows(np.r_[p, p], np.r_[p, q],
                             np.r_[p, 0.5 * (p + q)])
    both = np.concatenate([soup, soup, soup[:7]])
    out["duplicates"] = rows(both[:, 0], both[:, 1], both[:, 2])
    z = np.zeros((9, 3), np.float32)
    out["negative zeros"] = rows(-z, z, -z)
    for n, grid in ((37, 0), (300, 8), (2000, 0), (20000, 16)):
        c = np.random.default_rng(n).normal(size=(n, 3, 3))
        if grid:
            c = np.round(c * grid) / grid
        out[f"soup of {n}" + (f" on a 1/{grid} grid" if grid else "")] = (
            rows(c[:, 0], c[:, 1], c[:, 2]))
    return out


def same_tree(a, b) -> bool:
    """The two trees are the same bits: nodes, order, tris_sorted, depth."""
    return (a.nodes.shape == b.nodes.shape and a.depth == b.depth
            and torch.equal(a.nodes.cpu().view(torch.int32),
                            b.nodes.cpu().view(torch.int32))
            and torch.equal(a.order.cpu(), b.order.cpu())
            and torch.equal(a.tris_sorted.cpu().view(torch.int32),
                            b.tris_sorted.cpu().view(torch.int32)))


def build_part(dev, tables: dict, obj, camera, size: int) -> dict:
    """Phase 18's build kernel (csrc/bvh_build.cu): its tree held bit for
    bit to the numpy build and to build_bvh_plain on every scene table and
    edge case; its time by CUDA events on the OBJ beside build_bvh's end
    to end (the kernel and the read of the tree's size), the host build's
    (the table copied to the host, numpy, the tree copied back: the build
    the card's paths ran before the kernel) and the plain version's,
    against its bound; and the culled
    render_default_mega on the OBJ end to end at 1 and 32 spp with the
    tree built on the card and on the host, in turns (host, card, card,
    host), every image bit-equal."""
    from rlrpt_tpu_torch.config import RenderConfig
    from rlrpt_tpu_torch.ops import bvh as bv
    from rlrpt_tpu_torch.ops import megakernel as mk
    from rlrpt_tpu_torch.tools.mega_sweep import PEAK_BYTES, kernel_ms

    fig, trees = {}, []
    err = 0.0
    for name, t in {**tables, **edge_tables()}.items():
        cpu = t.detach().cpu().contiguous()
        host, plain = bv.build_bvh(cpu), bv.build_bvh_plain(cpu)
        kern = bv.build_bvh(cpu.to(dev))
        check(same_tree(plain, host), f"build_bvh_plain {name}: not the "
                                      f"numpy build's tree")
        check(same_tree(kern, host), f"the build kernel {name}: not the "
                                     f"numpy build's tree")
        boxes = torch.cat([kern.nodes[:, 0:3], kern.nodes[:, 4:7],
                           kern.nodes[:, 8:11], kern.nodes[:, 12:15]], 1)
        ref = torch.cat([host.nodes[:, 0:3], host.nodes[:, 4:7],
                         host.nodes[:, 8:11], host.nodes[:, 12:15]], 1)
        err = max(err, float((boxes.cpu().double() - ref.double()).abs()
                             .nan_to_num(0.0).max()) if len(ref) else 0.0)
        trees.append(f"{name} ({cpu.shape[0]}: {host.nodes.shape[0]} "
                     f"nodes, depth {host.depth})")
    log(f"[18] the build kernel's tree is the numpy build's and "
        f"build_bvh_plain's bit for bit (nodes, order, tris_sorted, depth) "
        f"on {len(trees)} tables: " + "; ".join(trees))
    fig["tables"] = len(trees)
    fig["max_abs_err"] = err

    o = tables["torus room"].to(dev).contiguous()
    n = o.shape[0]
    ms = kernel_ms(lambda: bv.launch_build(o), 20)
    e2e, host_s = [], []
    for _ in range(5):
        t_ms, tree = host_ms(lambda: bv.build_bvh(o))
        e2e.append(t_ms)
    for _ in range(3):
        t_ms, _ = host_ms(lambda: bv._build_host(o))
        host_s.append(t_ms / 1e3)
    levels = []
    plain_ms, _ = host_ms(lambda: bv.build_bvh_plain(o.cpu(), levels))
    ops = (n * BUILD_TRI_OPS + sum(m for _, m in levels) * BUILD_ITEM_OPS
           + sum(k for k, _ in levels) * BUILD_NODE_OPS)
    nbytes = n * 48 + tree.nodes.numel() * 4 + n * (4 + 48)
    t_ops, t_bytes = ops / PEAK_F64 * 1e3, nbytes / PEAK_BYTES * 1e3
    bound, by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes,
                                                                "bytes")
    fig.update(triangles=n, nodes=tree.nodes.shape[0], depth=tree.depth,
               levels=levels, ms=ms, build_bvh_ms=e2e, host_build_s=host_s,
               plain_ms=plain_ms, bound_ms=bound, bound_by=by,
               share=bound / ms, f64_ops=ops, bytes=nbytes)
    log(f"[18] build kernel on the OBJ ({n} triangles, {tree.depth} levels, "
        f"{tree.nodes.shape[0]} nodes): {ms:.4f} ms by CUDA events (mean of "
        f"20 launches); build_bvh end to end (the kernel and the read of "
        f"the tree's size) " + ", ".join(f"{x:.4f}" for x in e2e)
        + " ms; the host build (table to the host, numpy, tree back) "
        + ", ".join(f"{x:.4f}" for x in host_s) + f" s; build_bvh_plain "
        f"(CPU) {plain_ms:.1f} ms; bound {bound * 1e3:.4f} us ({by}: "
        f"{nbytes} bytes, {ops} f64 operations), share {bound / ms:.5f}")

    phases = bv.build_phase_ns(o)
    fig["phase_ns"] = phases
    log(f"[18] the build kernel's phases on the OBJ (its device clock after "
        f"each grid barrier, summed over the {tree.depth} levels): "
        + ", ".join(f"{k} {v / 1e3:.1f} us" for k, v in phases.items()))

    e2e_fig = {}
    for spp in (1, 32):
        cfg = RenderConfig(width=size, height=size, samples_per_pixel=spp,
                           max_ray_bounces=80)
        secs, imgs = {"host": [], "card": []}, []
        for where in ("host", "card", "card", "host"):
            build = bv.build_bvh
            if where == "host":
                bv.build_bvh = bv._build_host
            try:
                t_ms, (img, _) = host_ms(lambda: mk.render_default_mega(
                    77, obj, camera, cfg, dev))
            finally:
                bv.build_bvh = build
            secs[where].append(t_ms / 1e3)
            imgs.append(img)
        check(all(torch.equal(i, imgs[0]) for i in imgs[1:]),
              f"culled frame {spp} spp: the image depends on where the tree "
              f"was built")
        e2e_fig[f"{spp} spp"] = secs
        log(f"[18] culled render_default_mega on the OBJ {size}x{size} {spp} "
            f"spp end to end: tree built on the card "
            + ", ".join(f"{x:.4f}" for x in secs["card"])
            + " s, on the host " + ", ".join(f"{x:.4f}" for x in secs["host"])
            + " s (in turns); the images bit-equal")
    fig["culled_end_to_end_s"] = e2e_fig
    return fig


def scene_phases(dev, out_dir: Path, drive, size: int = 720,
                 torus: tuple = (46, 54)) -> dict:
    """Phase 18: the test room and a generated OBJ at bunny.obj's size
    (46 x 54 torus quads, 4,968 triangles, in a room: 4,980 with the
    light) through every kernel, each against its twin, then their paths
    at size x size with an 80-bounce cap, and scene_bench rows.  ``drive``
    runs a path with every launch count at 0 and fails it if an expected
    kernel never launched.  Returns the phase's figures."""
    from rlrpt_tpu_torch.camera import Camera
    from rlrpt_tpu_torch.config import RadianceVolumeConfig, RenderConfig
    from rlrpt_tpu_torch.integrators import sarsa_wavefront as sw
    from rlrpt_tpu_torch.integrators import wavefront as wf
    from rlrpt_tpu_torch.ops import bvh as bv
    from rlrpt_tpu_torch.ops import guided_mega as gm
    from rlrpt_tpu_torch.ops import guided_mega_train as gt
    from rlrpt_tpu_torch.ops import intersect_pallas as ip
    from rlrpt_tpu_torch.ops import megakernel as mk
    from rlrpt_tpu_torch.ops.hemisphere import sector_cos_thetas
    from rlrpt_tpu_torch.radiance import map_io
    from rlrpt_tpu_torch.radiance.bake import bake_tri_bin_cdf
    from rlrpt_tpu_torch.scene import generated, presets
    from rlrpt_tpu_torch.scene.obj_importer import (normalise_vertices,
                                                    parse_obj)
    from rlrpt_tpu_torch.scene.scene import morton_sort_surfaces
    from rlrpt_tpu_torch.tools import render
    from rlrpt_tpu_torch.tools.mega_sweep import (lane_efficiency,
                                                  walk_frame_bound)
    from rlrpt_tpu_torch.tools.scene_bench import bench_scene
    from rlrpt_tpu_torch.utils import native
    from rlrpt_tpu_torch.utils.image import write_png

    res, secs = {}, {}
    errs = dict.fromkeys(("B1", "B1 culled", "B3", "B2", "B4a", "B4b"), 0.0)
    cam = mk.camera_vector(Camera.create(CAM))
    camera = Camera.create(CAM)
    full = lambda spp: RenderConfig(  # noqa: E731
        width=size, height=size, samples_per_pixel=spp, max_ray_bounces=80)
    n_full = mk.n_slots_for(size * size, mk.R_TILE, mk.PIX_MUX)

    def run_cli(argv):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, aux = render.render(render.build_parser().parse_args(
            argv + ["--device", dev.type, "--width", str(size),
                    "--height", str(size), "--bounces", "80"]))
        torch.cuda.synchronize()
        return img, aux, time.perf_counter() - t0

    # ---- 18a: the test room's kernels against their twins ---------------
    t_part = time.perf_counter()
    room = presets.load_scene("test_room", device=dev)
    r_tris, r_mat = mk.pack_scene(room)
    r_pad = mk._t_pad(room.n_triangles)
    log(f"[18] test_room: {room.n_surfaces} surfaces + "
        f"{room.n_triangles - room.n_surfaces} light triangles (t_pad "
        f"{r_pad}); kernels vs twins at 64x64, 4 spp, 80 bounces, bit-equal")
    small = RenderConfig(width=64, height=64, samples_per_pixel=4,
                         max_ray_bounces=80)
    n_small = mk.n_slots_for(small.n_pixels, 128, 1)
    errs["B1"] = equal_frames(
        "B1 test_room", mk.mega_default_frame(31, cam, r_tris, r_mat, small,
                                              n_small, 1),
        mk.mega_default_frame_plain(31, cam, r_tris, r_mat, small, n_small,
                                    1), small)
    cdf_t = skewed_table(dev, 3.0, r_pad).cdf.T.contiguous()
    errs["B3"] = equal_frames(
        "B3 test_room, skewed table",
        gm.mega_guided_frame(32, cam, r_tris, r_mat, cdf_t, 11, 4, small,
                             n_small, 1),
        gm.mega_guided_frame_plain(32, cam, r_tris, r_mat, cdf_t, 11, 4,
                                   small, n_small, 1), small)
    rl11 = RadianceVolumeConfig(grid_resolution=11)
    q_in = skewed_q(dev, 3.0, r_pad)
    v_in = torch.from_numpy(np.random.default_rng(18).integers(
        0, 3, q_in.shape).astype(np.float32)).to(dev)
    b2_cdf = gt.rebuild_bin_cdf(q_in, 11, 4, r_pad).cdf.T.contiguous()
    args = (33, cam, r_tris, r_mat, b2_cdf,
            gt.bin_luminance(room, r_pad, 4)[0].contiguous(),
            sector_cos_thetas(11, dev).contiguous(), q_in, v_in, 11, 4,
            rl11.radiance_threshold, small, n_small, 1)
    errs["B2"] = compare_train(
        "B2 test_room, skewed table", gt.mega_train_frame(*args),
        gt.mega_train_frame_plain(*args),
        gm.mega_guided_frame(33, cam, r_tris, r_mat, b2_cdf, 11, 4, small,
                             n_small, 1), q_in, v_in)
    gen = torch.Generator(device=dev).manual_seed(18)
    h_tris, h_mat = ip.pack_scene_mxu(room)
    h_bvh = bv.build_bvh(h_tris)
    _, _, o, d = hit_rays(dev, h_tris, h_mat, gen)
    for name, fn, tables in (("B4a", ip.closest_hit_mat_mxu, (h_tris, h_mat)),
                             ("B4b", ip.closest_hit_packed, (h_tris,))):
        errs[name] = equal_hits(f"{name} test_room", fn, o, d, tables,
                                o.shape[0] // 2, h_bvh)
    n_cam = size * size
    e_o, e_d = edge_rays(h_tris, 18)
    walk_vs_sweep("[18] test_room", h_tris, h_mat, h_bvh, {
        "camera + bounce rays": (o, d, o.shape[0]),
        "camera + bounce rays, count at half": (o, d, o.shape[0] // 2),
        "edge, vertex and grazing rays": (e_o, e_d, e_o.shape[0])})
    res["walk_test_room"] = {
        "camera": walk_timing("[18] test_room camera rays", o[:n_cam],
                              d[:n_cam], h_tris, h_mat, h_bvh),
        "bounce": walk_timing("[18] test_room bounce rays",
                              o[n_cam:].contiguous(), d[n_cam:].contiguous(),
                              h_tris, h_mat, h_bvh)}
    secs["test_room twins"] = time.perf_counter() - t_part

    # ---- 18b: the test room's learning path at full width ---------------
    t_part = time.perf_counter()
    log(f"[18] test_room at {size}x{size}, 32 spp: --mode mega, then "
        f"--mode sarsa-mega --frames 10 (the EVAL protocol)")
    m_img, m_aux, m_sec = drive("18", ("B1",), lambda: run_cli(
        ["--mode", "mega", "--scene", "test_room", "--spp", "32", "--seed",
         "1984"]))
    check_image("test_room mega", m_img, size)
    room_mean = float(m_img.mean())
    g_img, g_aux, g_sec = drive("18", ("B2", "B3"), lambda: run_cli(
        ["--mode", "sarsa-mega", "--scene", "test_room", "--frames", "10",
         "--spp", "32", "--seed", "1984"]))
    check_image("test_room sarsa-mega", g_img, size)
    check_visits("test_room sarsa-mega", g_aux["frames"])
    q = g_aux["q"]
    lt32 = gt.rebuild_bin_cdf(q, 11, 4, r_pad, dtype=torch.float32)
    img32 = mk.assemble(*gm.mega_guided_frame_plain(
        7, cam, r_tris, r_mat, lt32.cdf.T.contiguous(), 11, 4, full(32),
        n_full, mk.PIX_MUX), full(32))[0]
    gap = (float(g_img.mean()) - room_mean) / room_mean
    gap32 = (float(img32.mean()) - room_mean) / room_mean
    # the surfaces' columns (uv_bins 4: 16 a triangle); pads and lights
    # are never learned
    moved = float((q[:121, :room.n_surfaces * 16]
                   != rl11.initial_radiance).float().mean())
    write_png(str(out_dir / "test_room-mega.png"), m_img.cpu())
    write_png(str(out_dir / "test_room-sarsa-mega.png"), g_img.cpu())
    log(f"[18] test_room: mega {m_sec:.4f} s, mean {room_mean:.6f}, avg "
        f"path {float(m_aux['avg_path_length']):.4f}; sarsa-mega "
        f"{g_sec:.4f} s, learning frames "
        + " ".join(f"{fr['seconds']:.4f}" for fr in g_aux["frames"])
        + f" s, {moved:.4f} of q moved, visit invariant exact per frame; "
        f"guided mean (bf16 table) vs mega {gap:+.4%}, the learned Q as an "
        f"f32 table (B3's twin) {gap32:+.4%}")
    check(moved > 0.5, "test_room: q did not move")
    check(abs(gap32) <= 0.02, f"test_room f32 learned table off by "
                              f"{gap32:+.2%}")
    res["test_room"] = {"mega_mean": room_mean, "mega_seconds": m_sec,
                        "sarsa_mega_seconds": g_sec,
                        "learning_frames": g_aux["frames"],
                        "guided_bf16_vs_mega": gap,
                        "learned_f32_vs_mega": gap32}
    secs["test_room paths"] = time.perf_counter() - t_part

    # ---- 18c: the generated OBJ: importer and twins ----------------------
    t_part = time.perf_counter()
    preset = generated.torus_room(out_dir / "torus_room.obj", *torus)
    presets.PRESETS[preset.name] = preset   # --scene takes it from here
    check(native.have_native(), f"native IO library not live: "
                                f"{native.build_error()}")
    t0 = time.perf_counter()
    v_n, f_n = native.parse_obj_native(preset.obj)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    v_p, f_p = parse_obj(preset.obj)
    v_p = normalise_vertices(v_p).astype(np.float32)
    python_s = time.perf_counter() - t0
    check(np.array_equal(v_n, v_p) and np.array_equal(f_n, f_p),
          "native and Python OBJ parses differ")
    obj = preset.load(device=dev)
    obj_sorted = morton_sort_surfaces(obj)
    n_tris = obj.n_triangles
    o_pad = mk._t_pad(n_tris)
    log(f"[18] generated OBJ {Path(preset.obj).name}: {len(f_n)} faces "
        f"({len(f_n) - 10} torus + 10 room) + 2 light = {n_tris} triangles, "
        f"t_pad {o_pad} ({-(-n_tris // 256)} tiles of 256); parse native "
        f"{native_s:.4f} s (native IO library live: "
        f"{native.have_native()}), Python {python_s:.4f} s: equal arrays")
    check(n_tris == 2 * torus[0] * torus[1] + 12
          and len(f_n) == n_tris - 2, "generated OBJ size")
    small2 = dataclasses.replace(small, samples_per_pixel=2)
    tables = {}
    for label, sc in (("unsorted", obj), ("Morton-sorted", obj_sorted)):
        tables[label] = mk.pack_scene(sc)
        k_out = mk.mega_default_frame(41, cam, *tables[label], small2,
                                      n_small, 1)
        errs["B1"] = max(errs["B1"], equal_frames(
            f"B1 torus room {label} 64x64 2spp", k_out,
            mk.mega_default_frame_plain(41, cam, *tables[label], small2,
                                        n_small, 1), small2))
        c_out = mk.mega_default_frame(41, cam, *tables[label], small2,
                                      n_small, 1,
                                      bv.build_bvh(tables[label][0]))
        for n, a, b in zip(("rad", "path_sum", "iters"), c_out, k_out):
            check(torch.equal(a, b), f"culled B1 torus room {label}: {n} "
                                     f"differs from the sweep kernel's")
        log(f"  culled B1 torus room {label} 64x64 2spp: bit-equal to the "
            f"sweep kernel")
    o_tris, o_mat = ip.pack_scene_mxu(obj)
    builds = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o_bvh = bv.build_bvh(o_tris)
        torch.cuda.synchronize()
        builds.append(time.perf_counter() - t0)
    log(f"[18] BVH of the {n_tris} triangles: {o_bvh.nodes.shape[0]} inner "
        f"nodes, depth {o_bvh.depth}; build_bvh (the build kernel and the "
        f"read of the tree's size) " + ", ".join(f"{b:.4f}" for b in builds)
        + " s")
    cam_o, cam_d, o, d = hit_rays(dev, o_tris, o_mat, gen, size=256)
    for name, fn, tabs in (("B4a", ip.closest_hit_mat_mxu, (o_tris, o_mat)),
                           ("B4b", ip.closest_hit_packed, (o_tris,))):
        errs[name] = max(errs[name], equal_hits(
            f"{name} torus room camera rays", fn, cam_o, cam_d, tabs,
            cam_o.shape[0], o_bvh))
        errs[name] = max(errs[name], equal_hits(
            f"{name} torus room camera + bounce rays", fn, o, d, tabs,
            o.shape[0] // 2, o_bvh))
    f_cam_o, f_cam_d, f_o, f_d = hit_rays(dev, o_tris, o_mat, gen, size,
                                          hit=ip.closest_hit_sweep)
    e_o, e_d = edge_rays(o_tris, 19)
    walk_vs_sweep("[18] torus room", o_tris, o_mat, o_bvh, {
        "camera + bounce rays": (f_o, f_d, f_o.shape[0]),
        "camera + bounce rays, count at half": (f_o, f_d,
                                                f_o.shape[0] // 2),
        "edge, vertex and grazing rays": (e_o, e_d, e_o.shape[0])})
    secs["OBJ import and twins"] = time.perf_counter() - t_part

    # ---- the build kernel against the numpy build and its plain version --
    t_part = time.perf_counter()
    res["bvh_build"] = build_part(dev, {
        "Cornell": ip.pack_triangles(presets.load_scene("cornell", dev)),
        "test room": h_tris, "clutter": mk.pack_scene(clutter_scene(dev))[0],
        "torus room": o_tris,
        "torus room, Morton-sorted": tables["Morton-sorted"][0]}, obj,
        camera, size)
    secs["BVH build"] = time.perf_counter() - t_part

    # ---- 18d: the culled B1 against the sweep kernel and its twin ---------
    t_part = time.perf_counter()
    tris, mat = tables["unsorted"]
    kern = {}
    log(f"[18] the culled B1 (a BVH walk in the slot loop) against the sweep "
        f"kernel at {size}x{size}, 80 bounces, 1 and 32 spp (one launch "
        f"each by CUDA events, in turns sweep, culled, culled, sweep), and "
        f"at 1 spp against its twin (the plain walk in the slot loop; "
        f"{size}x{size} on the OBJ, 128x128 on the clutter): rad, path_sum "
        f"and iters bit-equal; bound counted from the walks' box and "
        f"triangle tests (the count-only build, equal to the twin's counts)")

    def culled_b1(label, c_tris, c_mat, seed, twin_size):
        """The culled kernel on one table against the sweep kernel and,
        at twin_size x twin_size, 1 spp, the twin (the plain walk steps
        one torch op at a time: 26-38 s at 720x720 on the OBJ on the
        card, 18 s at 256x256); returns its figures and fills kern for
        the OBJ."""
        builds = []
        for _ in range(3):
            t0 = time.perf_counter()
            tree = bv.build_bvh(c_tris)
            torch.cuda.synchronize()
            builds.append(time.perf_counter() - t0)
        t = c_tris.shape[0]
        fig = {"triangles": t, "nodes": tree.nodes.shape[0],
               "depth": tree.depth, "build_seconds": builds}
        log(f"[18] {label}: {t} triangles, tree of {tree.nodes.shape[0]} "
            f"inner nodes, depth {tree.depth}; build_bvh on the card "
            + ", ".join(f"{b:.4f}" for b in builds) + " s")
        for spp in (1, 32):
            args = (seed, cam, c_tris, c_mat, full(spp), n_full, mk.PIX_MUX)
            ms = {"sweep": [], "culled": []}
            outs = {}
            for kind in ("sweep", "culled", "culled", "sweep"):
                t_ms, out = event_ms(lambda: mk.mega_default_frame(
                    *args, tree if kind == "culled" else None))
                ms[kind].append(t_ms)
                outs.setdefault(kind, []).append(out)
            ref = outs["sweep"][0]
            for out in outs["sweep"][1:] + outs["culled"]:
                for n, a, b in zip(("rad", "path_sum", "iters"), out, ref):
                    check(torch.equal(a, b), f"culled B1 {label} {spp} spp: "
                                             f"{n} differs from the sweep's")
            visits, tests, w_steps, w_lanes = mk.walk_counts(
                *args, tree, simt=True)
            simt = w_lanes / (32 * w_steps)
            point = {"sweep_ms": ms["sweep"], "culled_ms": ms["culled"],
                     "visits": visits, "tests": tests,
                     "warp_steps": w_steps, "active_lanes": w_lanes,
                     "simt_efficiency": simt}
            extra = ""
            if spp == 1:
                t_cfg = RenderConfig(width=twin_size, height=twin_size,
                                     samples_per_pixel=1, max_ray_bounces=80)
                t_args = (seed, cam, c_tris, c_mat, t_cfg, mk.n_slots_for(
                    t_cfg.n_pixels, mk.R_TILE, mk.PIX_MUX), mk.PIX_MUX, tree)
                k_out = (outs["culled"][0] if twin_size == size
                         else mk.mega_default_frame(*t_args))
                counts = {"visits": 0, "tests": 0}
                plain_ms, p_out = host_ms(lambda: mk.mega_default_frame_plain(
                    *t_args, counts))
                for n, a, b in zip(("rad", "path_sum", "iters"), p_out,
                                   k_out):
                    check(torch.equal(a, b), f"culled B1 {label}: the twin's "
                                             f"{n} differs")
                k_counts = mk.walk_counts(*t_args)
                check((counts["visits"], counts["tests"]) == k_counts,
                      f"culled B1 {label}: the count-only build counted "
                      f"{k_counts}, the twin {counts}")
                point["plain_ms"] = plain_ms
                errs["B1 culled"] = max(errs["B1 culled"], float(
                    (p_out[0] - k_out[0]).abs().max()))
                extra = (f"; twin at {twin_size}x{twin_size} {plain_ms:.1f} "
                         f"ms, bit-equal, its counts the count-only build's")
            segments = float(ref[1].double().sum())
            bound, by = walk_frame_bound(ref, tree, visits, tests)
            brute, brute_by = frame_bound("B1", ref, t)
            m_s, m_c = statistics.mean(ms["sweep"]), statistics.mean(
                ms["culled"])
            point.update(ms=m_c, bound_ms=bound, bound_by=by,
                         share=bound / m_c, sweep_mean_ms=m_s,
                         brute_bound_ms=brute, brute_bound_by=brute_by,
                         segments=segments)
            fig[f"{spp} spp"] = point
            log(f"[18] {label} {size}x{size} {spp} spp: sweep "
                + ", ".join(f"{x:.4f}" for x in ms["sweep"]) + " ms; culled "
                + ", ".join(f"{x:.4f}" for x in ms["culled"])
                + f" ms (sweep / culled {m_s / m_c:.2f}x), bit-equal; "
                f"{segments:.0f} segments, {visits / segments:.3f} inner-node "
                f"visits and {tests / segments:.3f} triangle tests a segment,"
                f" the walk's SIMT efficiency {simt:.4f} ({w_lanes} active "
                f"lanes over {w_steps} warp steps);"
                f" counted bound {bound:.4f} ms ({by}), share "
                f"{bound / m_c:.4f}; brute-force bound {brute:.4f} ms "
                f"({brute_by}), the sweep's share {brute / m_s:.4f}" + extra)
            if label == "torus room":
                _, aux = mk.assemble(*ref, full(spp))
                iters = ref[2]
                kern[f"B1 {spp} spp"] = {
                    "ms": m_s, "bound_ms": brute, "bound_by": brute_by,
                    "share": brute / m_s,
                    "avg_path": float(aux["avg_path_length"]),
                    "max_iterations": int(iters.max()),
                    "warp_efficiency": lane_efficiency(iters, 32),
                    "block_efficiency": lane_efficiency(iters, 128)}
                kern[f"B1 culled {spp} spp"] = point
        return fig

    res["culled_b1"] = {
        "clutter": culled_b1("clutter (Cornell + 250)",
                             *mk.pack_scene(clutter_scene(dev)), 52, 128),
        "torus_room": culled_b1("torus room", tris, mat, 51, size)}
    secs["culled B1"] = time.perf_counter() - t_part

    # ---- 18e: the generated OBJ at full width -----------------------------
    t_part = time.perf_counter()
    # --mode mega culls the OBJ by default; its image is the sweep's at the
    # CLI's seed (render.py draws it from --seed as below)
    img, aux, mega_s = drive("18", ("B1 culled", "BVH build"),
                             lambda: run_cli(["--mode", "mega", "--scene",
                                              preset.name, "--spp", "32",
                                              "--seed", "1984"]))
    check(mk.KERNEL.launches == 0 and bv.BUILDS == 1,
          f"--mode mega on the OBJ: {mk.KERNEL.launches} sweep launches, "
          f"{bv.BUILDS} tree builds")
    check_image("torus room mega", img, size)
    check(float(aux["avg_path_length"]) > 2.0, "torus room: paths too short")
    cli_seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=(
        torch.Generator().manual_seed(1984))))

    def swept():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = mk.render_default_mega(cli_seed, obj, Camera.create(
            preset.camera_position), full(32), dev, cull=False)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (img_off, _), off_s = drive("18", ("B1",), swept)
    check(torch.equal(img, img_off), "--mode mega on the OBJ: the culled "
                                     "image differs from cull=False's")
    obj_mean = float(img.mean())
    write_png(str(out_dir / "torus_room-mega.png"), img.cpu())
    log(f"[18] --mode mega --scene {preset.name} 32 spp (culled by "
        f"default): {mega_s:.4f} s, mean {obj_mean:.6f}, avg path "
        f"{float(aux['avg_path_length']):.4f}; render_default_mega("
        f"cull=False) at the same seed {off_s:.4f} s: the same image bit "
        f"for bit")

    # B4a through the walk against the sweep per 518,400 camera rays and
    # their bounce rays at this T; B4b and B4c (no rows) on the camera rays
    n_cam = f_cam_o.shape[0]
    kern["B4 walk"] = {
        "camera": walk_timing("[18] torus room camera rays", f_cam_o,
                              f_cam_d, o_tris, o_mat, o_bvh),
        "bounce": walk_timing("[18] torus room bounce rays",
                              f_o[n_cam:].contiguous(),
                              f_d[n_cam:].contiguous(), o_tris, o_mat,
                              o_bvh),
        "build_seconds": builds}
    # B4a/b/c per 518,400 camera rays, stream-timed as in PR 6 (mean of
    # 10 launches, wrappers' host time included), and in a CUDA graph
    live = torch.tensor([n_cam], dtype=torch.int32, device=dev)
    for name, fn, tabs in (
            ("B4a", ip.closest_hit_mat_mxu, (o_tris, o_mat)),
            ("B4b", ip.closest_hit_packed, (o_tris,)),
            ("B4c", ip.closest_hit_packed_mxu, (o_tris,))):
        run = lambda: fn(f_cam_o, f_cam_d, *tabs, live,  # noqa: E731
                         bvh=o_bvh)
        ms, g_ms = kernel_ms(run, 10), graph_ms(run, 50)
        bound, by = bound_ms(n_cam * n_tris * MT_OPS, n_cam * (
            24 + 8 + (64 if name == "B4a" else 0)))
        kern[name] = {"ms": ms, "graph_ms": g_ms, "brute_bound_ms": bound,
                      "brute_bound_by": by, "brute_share": bound / ms}
        log(f"[18] {name} torus room, {n_cam} camera rays x {n_tris} "
            f"triangles: {ms:.4f} ms (stream, mean of 10), {g_ms:.4f} ms "
            f"(50 launches in a CUDA graph); brute-force bound "
            f"{bound:.4f} ms ({by}), share {bound / ms:.4f}")

    def recorded(module, fn):
        """fn() once more with module.closest_hit_mat_mxu under a
        CallRecorder; returns the recorder."""
        rec = CallRecorder(module.closest_hit_mat_mxu)
        module.closest_hit_mat_mxu = rec
        try:
            fn()
        finally:
            module.closest_hit_mat_mxu = rec.fn
        return rec

    w_argv = ["--mode", "wavefront", "--scene", preset.name, "--spp", "8",
              "--seed", "1985"]
    w_img, w_aux, w_sec = drive("18", ("B4a",), lambda: run_cli(w_argv))
    check(bv.BUILDS == 1, f"OBJ wavefront: {bv.BUILDS} BVH builds in one "
                          f"frame")
    w_launches = ip.KERNEL_MAT.launches
    check_image("torus room wavefront", w_img, size)
    w_gap = (float(w_img.mean()) - obj_mean) / obj_mean
    # the same frame again, its B4a calls recorded and replayed
    w_rec = recorded(wf, lambda: run_cli(w_argv))
    check(len(w_rec.calls) == w_launches, f"OBJ wavefront: "
          f"{len(w_rec.calls)} B4a calls recorded, {w_launches} launched")
    w_b4a = w_rec.device_seconds()
    del w_rec   # the copies of the frame's rays
    log(f"[18] --mode wavefront 8 spp: {w_sec:.4f} s, "
        f"{int(w_aux['wavefront_iterations'])} iterations, mean "
        f"{float(w_img.mean()):.6f} vs mega 32 spp {w_gap:+.4%}; B4a "
        f"device time (its {w_launches} launches replayed in a CUDA graph) "
        f"{w_b4a:.4f} s, {w_b4a / w_sec:.4f} of the frame")
    check(abs(w_gap) <= 0.02, f"torus room wavefront off by {w_gap:+.2%}")
    secs["OBJ mega, B4, wavefront"] = time.perf_counter() - t_part

    # ---- 18f: the fine map on the generated OBJ ---------------------------
    t_part = time.perf_counter()
    area = 0.001
    f_img, f_aux, f_sec = drive("18", ("B4a",), lambda: run_cli(
        ["--mode", "sarsa-fast", "--scene", preset.name, "--frames", "2",
         "--spp", "8", "--area-per-sample", str(area), "--pix-mux", "4",
         "--seed", "1984"]))
    check_image("torus room sarsa-fast", f_img, size)
    vols, table, frames = f_aux["vols"], f_aux["table"], f_aux["frames"]
    check(bv.BUILDS == len(frames), f"OBJ sarsa-fast: {bv.BUILDS} BVH builds "
                                    f"in {len(frames)} frames")
    check_visits("torus room sarsa-fast", frames)
    f_learn = sum(fr["seconds"] for fr in frames)
    n_cls = len(torch.unique(table.tri_class))
    slots = table.table[:, 0:8:2]
    filled = (slots >= 0).sum(dim=1)
    near = table.table[:, 9] > 0
    log(f"[18] sarsa-fast on the torus room, area {area}: V = "
        f"{vols.n_volumes}; class table {table.dims}, {n_cls} classes, host "
        f"build {f_aux['table_seconds']:.4f} s; near-surface cells "
        f"{int(near.sum())}, of them with all 4 class slots filled "
        f"{float((filled[near] == 4).float().mean()):.4f}; learning frames "
        + " ".join(f"{fr['seconds']:.4f}" for fr in frames)
        + " s; zclp " + " ".join(str(fr["zclp"]) for fr in frames))
    rl = RadianceVolumeConfig(area_per_sample=area)

    def test_render():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sw.render_frame_sarsa_wavefront(
            torch.Generator(device=dev).manual_seed(2018), obj, camera,
            vols, table, full(16), rl, pix_mux=4)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (t_img, t_vols, t_aux), t_sec = drive("18", ("B4a",), test_render)
    check(bv.BUILDS == 1, f"OBJ sarsa-fast test render: {bv.BUILDS} BVH "
                          f"builds")
    check_image("torus room sarsa-fast test render", t_img, size)
    check_visits("torus room sarsa-fast test render", [{
        "visits": int(t_vols.visits.sum()),
        "td_scatters": int(t_aux["td_scatter_count"])}],
        int(vols.visits.sum()))
    t_gap = (float(t_img.mean()) - obj_mean) / obj_mean
    write_png(str(out_dir / "torus_room-sarsa-fast.png"), t_img.cpu())
    # phase 22 distills this map and probes 16 of its lit volumes
    map_io.save_q_vals_to_file(t_vols, str(out_dir / "q_torus_room.txt"))
    write_probes(t_vols, out_dir / "probes_torus_room.txt", 22)
    log(f"[18] sarsa-fast 16-spp test render (f32 CDF): {t_sec:.4f} s, "
        f"{ip.KERNEL_MAT.launches} B4a launches, mean "
        f"{float(t_img.mean()):.6f} vs mega {t_gap:+.4%}")
    check(abs(t_gap) <= 0.02, f"torus room sarsa-fast off by {t_gap:+.2%}")

    def learning_frame():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sw.render_frame_sarsa_wavefront(5, obj, camera, vols, table, full(8),
                                        rl, pix_mux=4)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # one more learning frame from the same volumes, timed, then rerun
    # with its B4a calls recorded and replayed for their device time
    before = ip.KERNEL_MAT.launches
    l_sec = learning_frame()
    l_n = ip.KERNEL_MAT.launches - before
    f_rec = recorded(sw, learning_frame)
    f_b4a = f_rec.device_seconds()
    log(f"[18] sarsa-fast: one more 8-spp learning frame {l_sec:.4f} s, "
        f"{l_n} B4a launches; B4a device time (the frame rerun, its "
        f"{len(f_rec.calls)} launches replayed in a CUDA graph) "
        f"{f_b4a:.4f} s, {f_b4a / l_sec:.4f} of the timed frame")
    del f_rec

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    baked = bake_tri_bin_cdf(obj, t_vols, rl, o_pad, uv_bins=1,
                             sector_grid=11)
    torch.cuda.synchronize()
    bake_s = time.perf_counter() - t0
    cdf_t = baked.cdf.T.contiguous()
    errs["B3"] = max(errs["B3"], equal_frames(
        "B3 torus room, baked per-triangle table, 64x64 2spp",
        gm.mega_guided_frame(42, cam, tris, mat, cdf_t, 11, 1, small2,
                             n_small, 1),
        gm.mega_guided_frame_plain(42, cam, tris, mat, cdf_t, 11, 1, small2,
                                   n_small, 1), small2))

    def guided():
        ms, out = event_ms(lambda: gm.mega_guided_frame(
            4018, cam, tris, mat, cdf_t, 11, 1, full(32), n_full,
            mk.PIX_MUX))
        return ms, out

    b3_ms, b3_out = drive("18", ("B3",), guided)
    b3_img, b3_aux = mk.assemble(*b3_out, full(32))
    check(torch.isfinite(b3_img).all(), "baked torus room render: not finite")
    b3_bound, b3_by = frame_bound("B3", b3_out, n_tris, cdf_t.numel() * 2)
    kern["B3 32 spp"] = {"ms": b3_ms, "bound_ms": b3_bound, "bound_by": b3_by,
                         "share": b3_bound / b3_ms}
    b3_gap = (float(b3_img.mean()) - obj_mean) / obj_mean
    write_png(str(out_dir / "torus_room-baked-guided.png"), b3_img.cpu())
    log(f"[18] bake at uv_bins 1 ({tuple(baked.cdf.shape)} bf16, t_pad "
        f"{o_pad}): {bake_s:.4f} s; B3 {size}x{size} 32 spp: {b3_ms:.4f} ms "
        f"(one launch), bound {b3_bound:.4f} ms ({b3_by}), share "
        f"{b3_bound / b3_ms:.4f}; avg path "
        f"{float(b3_aux['avg_path_length']):.4f}, mean vs mega {b3_gap:+.4%}"
        f" (bf16 table, reported)")
    res["torus_room"] = {
        "triangles": n_tris, "t_pad": o_pad, "parse_native_s": native_s,
        "parse_python_s": python_s, "mega_mean": obj_mean,
        "mega_seconds": mega_s, "mega_cull_off_seconds": off_s,
        "kernels": kern,
        "wavefront_seconds": w_sec, "wavefront_vs_mega": w_gap,
        "wavefront_b4a_device_seconds": w_b4a,
        "sarsa_fast_frame_seconds": l_sec,
        "sarsa_fast_frame_b4a_device_seconds": f_b4a,
        "n_volumes": vols.n_volumes, "classes": n_cls,
        "table_seconds": f_aux["table_seconds"], "learning_frames": frames,
        "test_seconds": t_sec, "test_vs_mega": t_gap, "bake_seconds": bake_s,
        "baked_b3_vs_mega": b3_gap}
    secs["OBJ fine map"] = time.perf_counter() - t_part

    # ---- 18g: scene_bench rows ----------------------------------------------
    t_part = time.perf_counter()
    log(f"[18] scene_bench rows ({size}x{size}, 1 spp, 80 bounces, 5 "
        f"frames; --cull both: an off and an on row for the OBJ, an off row "
        f"for a one-chunk scene)")
    rows = []

    def bench_rows():
        for name, sc, morton in (
                ("cornell", presets.load_scene("cornell", dev), True),
                ("test_room", room, True),
                (preset.name, obj, False), (preset.name, obj, True)):
            for cull in ([False, True] if mk.use_cull(sc.n_triangles)
                         else [False]):
                rows.append(bench_scene(name, sc, camera, full(1), dev,
                                        frames=5, morton=morton, cull=cull))
                log("[18] " + json.dumps(rows[-1]))

    drive("18", ("B1", "B1 culled"), bench_rows)
    check([r["cull"] for r in rows] == [False, False, False, True, False,
                                        True], "scene_bench's cull rows")
    res["scene_bench"] = rows
    secs["scene_bench"] = time.perf_counter() - t_part
    res["seconds"] = secs
    res["max_abs_err"] = errs
    res["preset"] = preset
    log("[18] seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in secs.items()))
    return res


def eval_phase(dev, out_dir: Path, drive, card: str) -> dict:
    """Phase 19: the thesis MAPE protocol through tools/evaluate.py at
    720x720, 128 spp, 80 bounces on Cornell: first the port's own
    4096-spp GT against the cached one, then every row but neural_q (phase
    14 drives deep-Q) against the cached GT, with a 10 s budget.  Fails
    unless every learned row beats the default row's MAPE at 128 spp."""
    from rlrpt_tpu_torch.camera import Camera
    from rlrpt_tpu_torch.scene import cornell_box
    from rlrpt_tpu_torch.tools import evaluate as ev

    scene, cam = cornell_box(device=dev), Camera.create(CAM)
    cache = ROOT / "artifacts" / "gt_cache" / ev.gt_cache_name(
        "cornell", 720, 4096, 80)
    check(cache.is_file(), f"no cached GT at {cache}")
    gt = ev.load_gt(str(cache))
    log(f"[19] thesis MAPE protocol (tools/evaluate.py): Cornell 720x720, "
        f"80 bounces; cached GT {cache.relative_to(ROOT)}, mean "
        f"{float(gt.mean()):.6f}")

    def own_gt():
        t0 = time.perf_counter()
        img = ev.render_gt(scene, cam, size=720, gt_spp=4096, bounces=80,
                           seed=1984, device=dev)
        sync(dev)
        return img, time.perf_counter() - t0

    own, own_s = drive("19", ("B1",), own_gt)
    rel = float(own.double().mean()) / float(gt.astype(np.float64).mean()) \
        - 1.0
    own_mape = ev._mape(own, gt)
    log(f"[19] the port's own 4096-spp GT (16 B1 frames of 256 spp): "
        f"{own_s:.4f} s, mean {float(own.mean()):.6f}, {rel:+.4%} from the "
        f"cached GT's (limit 0.5%); MAPE(own, cached) {own_mape}")
    check(abs(rel) <= 0.005, f"the port's GT mean is {rel:+.3%} from the "
                             f"cached GT's")

    t0 = time.perf_counter()
    rows = drive("19", ("B1", "B2", "B3", "B4a"), lambda: ev.evaluate_scene(
        scene, cam, size=720, gt_spp=4096, spp=128, bounces=80,
        sarsa_frames=10, sarsa_spp=32, nq_frames=8, nq_spp=8,
        area_per_sample=0.001, device=dev, seed=1984, skip_nq=True,
        budget_sec=10.0, gt_cache=str(cache),
        out_prefix=str(out_dir / "eval")))
    eval_s = time.perf_counter() - t0
    ref = {r["method"]: r["mape"] for r in json.loads(
        (ROOT / "EVAL.json").read_text())["rows"] if r["scene"] == "cornell"}
    for r in rows:
        secs = ", ".join(f"{k} {r[k]}" for k in (
            "train_sec", "bake_sec", "render_sec", "total_sec") if k in r)
        log(f"[19] {r['method']:18s} {r['spp']:6d} spp  MAPE {r['mape']:.4f}"
            f"  (EVAL.json {ref.get(r['method'], 'no row')}); {secs} s on "
            f"{card}")
    default = next(r["mape"] for r in rows if r["method"] == "default")
    learned = [r for r in rows if r["method"] in (
        "sarsa", "sarsa_guided", "sarsa_mega", "sarsa_mega_budget")]
    check(len(learned) == 4,
          f"learned rows missing: {[r['method'] for r in rows]}")
    worse = [r["method"] for r in learned if not r["mape"] < default]
    log(f"[19] every learned row below the default row's MAPE {default} at "
        f"128 spp: {not worse}; {eval_s:.1f} s for the protocol")
    check(not worse, f"learned rows not below the default MAPE: {worse}")
    return {"gt_own_seconds": own_s, "gt_own_rel_mean": rel,
            "gt_own_mape": own_mape, "rows": rows, "eval_json_mape": ref,
            "seconds": eval_s}


def _json_lines(fn) -> list:
    """fn()'s stdout JSON lines (it prints nothing else we need)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return [json.loads(x) for x in buf.getvalue().splitlines()
            if x.startswith("{")]


def tool_phase(dev, out_dir: Path, drive) -> dict:
    """Phase 20: the tools on the card, each through its entry point:
    mega_sweep's variant grid at the bench point, the bench twin's line,
    sarsa_bench at 720x720, neural_q_bench at 128x128,
    nn_training_stats at 64x64, the interactive renderers at 96x96 and
    render_diff at 720x720, 2 spp, 80 bounces (B4b) against the same
    render with the plain hit on the same uniforms."""
    from rlrpt_tpu_torch import bench as bench_twin
    from rlrpt_tpu_torch.camera import Camera
    from rlrpt_tpu_torch.config import RadianceVolumeConfig, RenderConfig
    from rlrpt_tpu_torch.integrators import differentiable as df
    from rlrpt_tpu_torch.ops import intersect_pallas as ip
    from rlrpt_tpu_torch.scene import cornell_box
    from rlrpt_tpu_torch.tools import (interactive, mega_sweep,
                                       neural_q_bench, nn_training_stats,
                                       sarsa_bench)
    from rlrpt_tpu_torch.utils.stats import read_stats

    res = {}
    # mega_sweep's variant grid at the bench point (720x720, 1 spp, 80
    # bounces), and JAX's high3 spec, which has no counterpart: its error
    # row, then the sweep goes on
    specs = list(mega_sweep.DEFAULT_VARIANTS) + ["1024,32,high3,2"]
    rows = drive("20", ("B1",), lambda: _json_lines(lambda: mega_sweep.main(
        ["--variants", ";".join(specs), "--repeats", "2"])))
    for x in rows:
        log(f"[20] mega_sweep --variants --repeats 2: {json.dumps(x)}")
    check([x["variant"] for x in rows] == specs, "mega_sweep rows")
    check(all(x["rays_per_sec"] > 0 and 0.0 < x["lane_util"] <= 1.0
              and np.isfinite(x["mape_vs_f32"]) for x in rows[:-1]),
          "mega_sweep: a variant row out of range")
    check(set(rows[-1]) == {"variant", "error"} and "A11" in
          rows[-1]["error"], "mega_sweep: no error row for high3")
    res["mega_sweep"] = rows

    (line,) = drive("20", ("B1",), lambda: _json_lines(
        lambda: bench_twin.main([])))
    check(set(line) == {"metric", "value", "unit", "vs_baseline"}
          and line["value"] > 0, f"bench twin line {line}")
    log(f"[20] python -m rlrpt_tpu_torch.bench: {json.dumps(line)}")
    res["bench"] = line

    lines = drive("20", ("B4a", "B1", "B2", "B3"), lambda: _json_lines(
        lambda: sarsa_bench.main(["--frames", "3"])))
    for x in lines:
        log(f"[20] sarsa_bench 720x720 1spp: {json.dumps(x)}")
    check([x.get("which") for x in lines] == [
        "default_wavefront", "default_mega", None, "sarsa_wavefront",
        "sarsa_mega_train", "sarsa_guided_infer"], "sarsa_bench lines")
    res["sarsa_bench"] = lines

    lines = drive("20", ("B4a",), lambda: _json_lines(
        lambda: neural_q_bench.main(["--size", "128", "--frames", "1"])))
    for x in lines:
        log(f"[20] neural_q_bench 128x128 1spp: {json.dumps(x)}")
    check([x["which"] for x in lines] == [
        "neural_q_train_wavefront", "neural_q_pretrained_wavefront"],
        "neural_q_bench lines")
    res["neural_q_bench"] = lines

    stats = out_dir / "nn_training_stats.txt"
    (summary,) = drive("20", ("B4a",), lambda: _json_lines(
        lambda: nn_training_stats.main([
            "--frames", "2", "--spp", "2", "--size", "64", "--out",
            str(stats)])))
    rows = read_stats(str(stats))
    log(f"[20] nn_training_stats 64x64, 2 frames x 2 spp: {len(rows)} "
        f"lines (2 x 2 expected), first {rows[0]}, last {rows[-1]}, "
        f"{summary['train_sec']} s on {summary['device']}")
    check(len(rows) == 4 and all(r[0] > 0 and np.isfinite(r[1])
                                 for r in rows), "nn_training_stats lines")
    res["nn_training_stats"] = {"lines": len(rows),
                                "train_sec": summary["train_sec"]}

    cfg = RenderConfig(width=96, height=96, samples_per_pixel=4,
                       max_ray_bounces=20)
    rl = RadianceVolumeConfig(area_per_sample=0.01)
    res["interactive"] = {}
    for mode, kern in (("default", "B1"), ("sarsa", "B4a"),
                       ("sarsa-mega", "B2")):
        def two_frames():
            render = interactive._build_renderer(
                mode, cornell_box(device=dev), cfg, rl, dev)
            cam, out = Camera.create(CAM), []
            for frame in range(2):
                t0 = time.perf_counter()
                img, aux = render(frame, cam)
                check_image(f"interactive {mode}", img, 96)
                out.append((time.perf_counter() - t0,
                            float(aux["avg_path_length"])))
                cam = cam.rotate_left(0.05).move_forwards(0.02)
            return out

        frames = drive("20", (kern,), two_frames)
        log(f"[20] interactive._build_renderer {mode}: 2 frames at 96x96, "
            f"4 spp: " + ", ".join(f"{s:.4f} s (avg path {p:.3f})"
                                   for s, p in frames))
        res["interactive"][mode] = frames

    # render_diff: B4b on the card, then the plain hit on the same draws
    diff_cfg = RenderConfig(width=720, height=720, samples_per_pixel=2,
                            max_ray_bounces=80)
    scene = cornell_box(device=dev)

    def grads():
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, g = df.pixel_gradients(1984, scene, Camera.create(CAM),
                                     diff_cfg, lambda img: img.mean(), dev)
        sync(dev)
        return (loss, g, time.perf_counter() - t0,
                torch.cuda.max_memory_allocated())

    loss, g, diff_s, peak = drive("20", ("B4b",), grads)
    b4b = ip.KERNEL_F32.launches
    img = df.render_diff(1984, scene, Camera.create(CAM), diff_cfg, dev)

    def plain_hit(o, d, scene, tris=None, active_count=None, bvh=None):
        t, tri = ip.closest_hit_plain(o, d, tris, o.shape[0])
        tri = tri.long()
        return ip._hit_record(o, d, scene, t, tri, scene.normal[tri])

    kernel_hit, df.closest_hit_pallas = df.closest_hit_pallas, plain_hit
    try:
        loss_p, g_p, plain_s, _ = grads()
        img_p = df.render_diff(1984, scene, Camera.create(CAM), diff_cfg,
                               dev)
    finally:
        df.closest_hit_pallas = kernel_hit
    finite = all(bool(torch.isfinite(getattr(g, f)).all())
                 for f in ("diffuse_c", "emission"))
    differ = float((~torch.isclose(img, img_p, rtol=1e-4, atol=1e-6))
                   .any(-1).float().mean())
    scale = max(float(g_p.diffuse_c.abs().max()),
                float(g_p.emission.abs().max()))
    g_err = max(float((g.diffuse_c - g_p.diffuse_c).abs().max()),
                float((g.emission - g_p.emission).abs().max())) / scale
    log(f"[20] render_diff + pixel_gradients 720x720, 2 spp, 80 bounces: "
        f"{diff_s:.4f} s ({b4b} B4b launches, one BVH), plain hit "
        f"{plain_s:.4f} s; loss {float(loss):.6f} vs {float(loss_p):.6f}; "
        f"gradients finite {finite}, largest difference {g_err:.3e} of the "
        f"largest gradient (limit 1e-3); {differ:.6f} of pixels differ "
        f"(limit 0.001); peak memory {peak / 2**30:.3f} GiB "
        f"(torch.cuda.max_memory_allocated)")
    check(finite and float(g.emission[scene.n_surfaces:].sum()) > 0,
          "render_diff gradients not finite and positive")
    check(differ <= 0.001 and g_err <= 1e-3,
          f"render_diff: B4b and the plain hit apart ({differ} of pixels, "
          f"gradient {g_err})")
    # the gathers' backward at one bounce's shape: index_select's (an
    # index_add) against advanced indexing's (a sorted index_put)
    gen = torch.Generator(device=dev).manual_seed(3)
    tri = torch.randint(0, scene.n_triangles, (720 * 720,), generator=gen,
                        device=dev)
    src = scene.emission.clone().requires_grad_(True)

    def backward_ms(gather):
        def run():
            src.grad = None
            gather(src, tri).sum().backward()
        return kernel_ms(run, 10)

    sel_ms = backward_ms(lambda x, i: x.index_select(0, i))
    adv_ms = backward_ms(lambda x, i: x[i])
    log(f"[20] a gather's forward and backward, {tri.numel()} rays into "
        f"{scene.n_triangles} triangles: index_select {sel_ms:.4f} ms, "
        f"advanced indexing {adv_ms:.4f} ms (CUDA events, 10 runs)")
    res["render_diff"] = {"seconds": diff_s, "plain_seconds": plain_s,
                          "b4b_launches": b4b, "differ_share": differ,
                          "grad_rel_err": g_err, "peak_bytes": peak,
                          "gather_backward_ms": {"index_select": sel_ms,
                                                 "advanced": adv_ms}}
    return res


def timed(dev, fn):
    """(fn(), its host seconds), the device synchronised on both sides."""
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, time.perf_counter() - t0


def digest(*tensors) -> str:
    """A hash of the tensors' bytes: equal digests are equal bits."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def gloo_rank(rank: int, world: int, address: str, size: int, small: int,
              device: str):
    """One of two ranks sharing the card over gloo (phase 21): B2 and B3
    through the binned dp entry points at size x size, then a neural-Q
    wavefront dp frame at small x small.  Returns digests of the
    replicated state, the rank's launch counts and checks.  ``device``
    "cpu" rehearses it on the twins."""
    from rlrpt_tpu_torch.camera import Camera
    from rlrpt_tpu_torch.config import (DeepLearningConfig,
                                        RadianceVolumeConfig, RenderConfig)
    from rlrpt_tpu_torch.deep.neural_q import init_neural_q
    from rlrpt_tpu_torch.ops import guided_mega as gm
    from rlrpt_tpu_torch.ops import guided_mega_train as gt
    from rlrpt_tpu_torch.ops import intersect_pallas as ip
    from rlrpt_tpu_torch.parallel import dp, multihost
    from rlrpt_tpu_torch.parallel.mesh import (all_gather, make_mesh,
                                               rank_seed)
    from rlrpt_tpu_torch.scene import cornell_box

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    multihost.initialize(address, world, rank, device="cpu")   # gloo
    try:
        mesh = make_mesh(device=dev)
        kernels = {"B2": gt.KERNEL, "B3": gm.KERNEL, "B4a": ip.KERNEL_MAT}
        for k in kernels.values():
            k.launches = 0
        scene, camera = cornell_box(device=dev), Camera.create(CAM)
        rl = RadianceVolumeConfig(grid_resolution=11)
        cfg = RenderConfig(width=size, height=size, samples_per_pixel=32,
                           max_ray_bounces=80)
        q0, v0 = gt.init_bin_q(40, 4, 11, rl.initial_radiance, device=dev)
        table = gt.rebuild_bin_cdf(q0, 11, 4, 40,
                                   defensive_mix=rl.defensive_mix)
        secs = {}
        (img, q, v, aux), secs["sarsa_mega_train_dp"] = timed(
            dev, lambda: dp.sarsa_mega_train_dp(1984, scene, camera, table,
                                                q0, v0, cfg,
                                                rl.radiance_threshold,
                                                mesh))
        launched = {n: k.launches for n, k in kernels.items()}
        # this rank's own visit delta, from its frame alone (not counted)
        _, _, v_r, _ = gt.render_sarsa_mega_train(
            rank_seed(1984, rank), scene, camera, table, q0, v0,
            dataclasses.replace(cfg, samples_per_pixel=32 // world),
            rl.radiance_threshold, dev)
        cs = all_gather((v_r - v0)[None], mesh)
        visits_exact = bool(torch.equal(v, v0 + cs[0] + cs[1]))
        for n, k in kernels.items():
            k.launches = launched[n]
        table = gt.rebuild_bin_cdf(q, 11, 4, 40,
                                   defensive_mix=rl.defensive_mix)
        (g_img, _), secs["render_guided_mega_dp"] = timed(
            dev, lambda: dp.render_guided_mega_dp(1985, scene, camera, table,
                                                  cfg, mesh))
        dl = DeepLearningConfig()
        net, opt = init_neural_q(5, scene, dl, 12, device=dev)
        small_cfg = RenderConfig(width=small, height=small,
                                 samples_per_pixel=1, max_ray_bounces=80)
        (nq_img, net, opt, eps, nq_aux), secs["neural_q_wavefront_dp"] = \
            timed(dev, lambda: dp.render_frame_neural_q_wavefront_dp(
                1986, scene, camera, net, opt, dl.epsilon_start, small_cfg,
                RadianceVolumeConfig(), dl, mesh, pix_mux=8))
        outs = [img, q, v, g_img, nq_img, *net.parameters(), opt.count,
                *opt.mu, *opt.nu]
        return {
            "launches": {n: k.launches for n, k in kernels.items()},
            "on_card": all(t.device == dev for t in outs),
            "visits_exact": visits_exact, "td": int(aux["td_scatter_count"]),
            "visit_delta": float((v - v0).double().sum()),
            "state": digest(q, v, img, g_img),
            "net": digest(*net.parameters(), opt.count, *opt.mu, *opt.nu),
            "nq_image": digest(nq_img), "eps": eps,
            "finite": bool(torch.isfinite(img).all()
                           and torch.isfinite(g_img).all()
                           and torch.isfinite(nq_img).all()),
            "loss": float(nq_aux["loss"]), "seconds": secs,
            "guided_mean": float(g_img.mean())}
    finally:
        dist.destroy_process_group()


def dp_phase(dev, out_dir: Path, drive, mega_mean: float,
             fine: dict | None = None, size: int = 720,
             small: int = 256) -> dict:
    """Phase 21, the multi-device layer (``rlrpt_tpu_torch/parallel``):
    every dp and multiscene entry point in a world of one over NCCL, each
    beside the single-process call it shards (bit for bit where the world
    of one draws the same numbers), the scaling bench's rows for sizes 1
    and 2, then two ranks sharing the card over gloo.  ``fine``: phase
    11's volumes and class table, if it ran; phase 15's saved net is read
    from ``out_dir`` if it is there.  Returns the phase's figures."""
    from rlrpt_tpu_torch.camera import Camera
    from rlrpt_tpu_torch.config import (DeepLearningConfig,
                                        RadianceVolumeConfig, RenderConfig)
    from rlrpt_tpu_torch.deep import deep_wavefront as dw
    from rlrpt_tpu_torch.deep import neural_q as nq
    from rlrpt_tpu_torch.integrators.default_tracer import render_default
    from rlrpt_tpu_torch.integrators.reinforcement_tracer import \
        render_frame_sarsa
    from rlrpt_tpu_torch.integrators.sarsa_wavefront import \
        render_frame_sarsa_wavefront
    from rlrpt_tpu_torch.nn.dynet_io import load_dynet_model
    from rlrpt_tpu_torch.ops import guided_mega as gm
    from rlrpt_tpu_torch.ops import guided_mega_train as gt
    from rlrpt_tpu_torch.parallel import dp, multihost, multiscene
    from rlrpt_tpu_torch.parallel.mesh import make_mesh, rank_seed
    from rlrpt_tpu_torch.radiance.grid_bucket import build_volume_class_table
    from rlrpt_tpu_torch.radiance.volumes import build_radiance_volumes
    from rlrpt_tpu_torch.scene import cornell_box, presets
    from rlrpt_tpu_torch.tools.scaling_bench import (available_devices,
                                                      run_scaling)
    from rlrpt_tpu_torch.utils.rng import fold_in

    # the ranks meet on the loopback interface
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    scene, camera = cornell_box(device=dev), Camera.create(CAM)
    full = dict(width=size, height=size, max_ray_bounces=80)
    res, t_world = {}, {}

    def both(label, dp_fn, single_fn, expect=()):
        """The dp call through drive (its launches counted), then the
        single-process call (not counted); logs both times."""
        out, s_dp = drive("21", expect, lambda: timed(dev, dp_fn))
        ref, s_1 = timed(dev, single_fn)
        t_world[label] = {"dp": s_dp, "single": s_1}
        log(f"[21] {label}: dp {s_dp:.4f} s, single-process "
            f"{s_1:.4f} s")
        return out, ref

    if dev.type == "cuda":
        torch.cuda.set_device(0)
    t0 = time.perf_counter()
    multihost.initialize(f"127.0.0.1:{multihost.free_port()}", 1, 0,
                         device=dev)
    try:
        mesh = make_mesh(device=dev)
        check(mesh.backend == ("nccl" if dev.type == "cuda" else "gloo")
              and mesh.size == 1,
              f"world-1 group: {mesh.backend}, {mesh.size} ranks")
        log(f"[21] the multi-device layer: a world of one over "
            f"{mesh.backend.upper()} "
            f"({time.perf_counter() - t0:.2f} s to form), Cornell "
            f"{size}x{size}, 80 bounces, unless named")

        # the default tracer (the plain sweep, no kernel)
        cfg = RenderConfig(samples_per_pixel=8, ray_tile=size * size, **full)
        (img, aux), (img1, _) = both(
            "render_default_dp 8 spp",
            lambda: dp.render_default_dp(1984, scene, camera, cfg, mesh),
            lambda: render_default(1984, scene, camera, cfg, dev))
        check_image("render_default_dp", img, size)
        gap = float(img.mean()) / mega_mean - 1.0
        log(f"[21] render_default_dp mean {float(img.mean()):.6f} vs mega "
            f"{gap:+.4%} (limit 2%); single-process "
            f"{float(img1.mean()) / mega_mean - 1.0:+.4%}")
        check(abs(gap) <= 0.02, f"render_default_dp mean off by {gap:+.2%}")
        res["default_vs_mega"] = gap

        # the binned pair: 10 learning frames (B2), then B3
        rl = RadianceVolumeConfig(grid_resolution=11)
        thr = rl.radiance_threshold
        cfg = RenderConfig(samples_per_pixel=32, **full)
        q, v = gt.init_bin_q(40, 4, 11, rl.initial_radiance, device=dev)
        frames = []

        def learn():
            qq, vv = q, v
            for f in range(10):
                table = gt.rebuild_bin_cdf(qq, 11, 4, 40,
                                           defensive_mix=rl.defensive_mix)
                out, sec = timed(dev, lambda: dp.sarsa_mega_train_dp(
                    fold_in(1984, f), scene, camera, table, qq, vv, cfg,
                    thr, mesh))
                frames.append((table, qq, vv, out, sec))
                qq, vv = out[1], out[2]
            table = gt.rebuild_bin_cdf(qq, 11, 4, 40,
                                       defensive_mix=rl.defensive_mix)
            return table, dp.render_guided_mega_dp(fold_in(1984, 10), scene,
                                                   camera, table, cfg, mesh)

        (table, (g_img, _)), s_dp = drive("21", ("B2", "B3"),
                                          lambda: timed(dev, learn))
        worst, s_1 = 0.0, 0.0
        for f, (tb, q_in, v_in, (img, q_dp, v_dp, aux), _) in \
                enumerate(frames):
            (img1, q1, v1, _), sec = timed(dev, lambda: (
                gt.render_sarsa_mega_train(rank_seed(fold_in(1984, f), 0),
                                           scene, camera, tb, q_in, v_in,
                                           cfg, thr, dev)))
            s_1 += sec
            check(torch.equal(img, img1), f"sarsa_mega_train_dp frame {f}: "
                                          "image not the launcher's")
            check(torch.equal(v_dp, v1), f"frame {f}: visits differ")
            check(float((v_dp - v_in).double().sum())
                  == int(aux["td_scatter_count"]) > 0,
                  f"frame {f}: the visit invariant broke")
            rel = float(((q_dp - q1).abs() / q1.abs().clamp(min=1e-30))
                        .max())
            worst = max(worst, rel)
            # B2's atomics reorder the TD sums (chip_smoke [6] holds B2
            # to its twin at rtol 1e-4), and the merge rounds once more
            check(torch.allclose(q_dp, q1, rtol=1e-4, atol=0.0),
                  f"frame {f}: q off by {rel:.3g}")
        (g1, _), sec = timed(dev, lambda: gm.render_guided_mega(
            rank_seed(fold_in(1984, 10), 0), scene, camera, table, cfg,
            dev))
        check(torch.equal(g_img, g1), "render_guided_mega_dp: the image is "
                                      "not the launcher's")
        t_world["sarsa_mega_train_dp x10 + render_guided_mega_dp"] = {
            "dp": s_dp, "single": s_1 + sec}
        log(f"[21] sarsa_mega_train_dp x 10 at 32 spp, then "
            f"render_guided_mega_dp: dp {s_dp:.4f} s, single-process "
            f"{s_1 + sec:.4f} s; every frame's image and visits bit-equal "
            f"to the launcher's with the rank-0 seed, q within "
            f"{worst:.3g} relative (limit 1e-4), the visit invariant exact "
            f"in every frame; the guided frame bit-equal")
        res["binned_q_max_rel"] = worst

        # the fine-map SARSA wavefront (B4a), one 8-spp learning frame
        rl = RadianceVolumeConfig(area_per_sample=0.001)
        if fine:
            vols, table = fine["vols"], fine["table"]
        else:
            vols = build_radiance_volumes(scene, rl)
            table = build_volume_class_table(vols, scene)
        cfg = RenderConfig(samples_per_pixel=8, **full)
        (img, vols_dp, aux), (img1, vols1, aux1) = both(
            f"render_frame_sarsa_wavefront_dp 8 spp, V = {vols.n_volumes}",
            lambda: dp.render_frame_sarsa_wavefront_dp(
                1985, scene, camera, vols, table, cfg, rl, mesh),
            lambda: render_frame_sarsa_wavefront(
                rank_seed(1985, 0), scene, camera, vols, table, cfg, rl,
                pix_mux=4), ("B4a",))
        check(torch.equal(img, img1) and torch.equal(vols_dp.visits,
                                                     vols1.visits),
              "sarsa wavefront dp: image or visits not the single frame's")
        check(int((vols_dp.visits - vols.visits).sum())
              == int(aux["td_scatter_count"]) > 0,
              "sarsa wavefront dp: the visit invariant broke")
        # index_add_ on the card adds in any order
        check(torch.allclose(vols_dp.q, vols1.q, rtol=1e-4, atol=1e-6),
              "sarsa wavefront dp: q apart from the single frame's")
        log(f"[21] sarsa wavefront dp: image and visits bit-equal to the "
            f"single frame's, q within rtol 1e-4, "
            f"{int(aux['td_scatter_count'])} TD scatters == the visit delta")

        # the lockstep SARSA frame (B4b) at the fine-map modes' size ([12])
        rl = RadianceVolumeConfig(area_per_sample=0.01)
        vols = build_radiance_volumes(scene, rl)
        lock = small // 2
        cfg = RenderConfig(width=lock, height=lock, samples_per_pixel=4,
                           max_ray_bounces=80)
        (img, vols_dp, aux), (img1, _, _) = both(
            f"render_frame_sarsa_dp {lock}x{lock} 4 spp, V = "
            f"{vols.n_volumes}",
            lambda: dp.render_frame_sarsa_dp(1992, scene, camera, vols, cfg,
                                             rl, mesh),
            lambda: render_frame_sarsa(rank_seed(1992, 0), scene, camera,
                                       vols, cfg, rl), ("B4b",))
        check_image("lockstep sarsa dp", img, lock)
        check(int((vols_dp.visits - vols.visits).sum())
              == int(aux["td_scatter_count"]) > 0,
              "lockstep sarsa dp: the visit invariant broke")
        a, b = img.double().mean(-1), img1.double().mean(-1)
        z = float((a.mean() - b.mean()) / ((a - b).var() / a.numel())
                  .sqrt())
        check(abs(z) < 4.0, f"lockstep sarsa dp: z {z}")
        log(f"[21] lockstep sarsa dp: the visit invariant exact "
            f"({int(aux['td_scatter_count'])} TD scatters), the frame mean "
            f"vs the single-process frame's z {z:+.3f} (limit 4; other "
            f"random streams)")

        # the deep wavefronts (B4a): pretrained, then one training frame
        dl = DeepLearningConfig()
        rl = RadianceVolumeConfig()
        model = out_dir / "neural_q.model"
        net = (load_dynet_model(str(model), device=dev) if model.exists()
               else nq.init_neural_q(7, scene, dl, 12, device=dev)[0])
        cfg = RenderConfig(samples_per_pixel=4, **full)
        (img, _), (img1, _) = both(
            "render_frame_pretrained_wavefront_dp 4 spp",
            lambda: dp.render_frame_pretrained_wavefront_dp(
                1986, scene, camera, net, cfg, rl, dl, mesh),
            lambda: dw.render_frame_pretrained_wavefront(
                rank_seed(1986, 0), scene, camera, net, cfg, rl, dl,
                pix_mux=4), ("B4a",))
        check_image("pretrained dp", img, size)
        check(torch.equal(img, img1), "pretrained dp: not the single frame")
        # the training frame at half the width (phase 14 trains at full)
        half = size // 2
        cfg = RenderConfig(width=half, height=half, samples_per_pixel=1,
                           max_ray_bounces=80)
        nets = [nq.init_neural_q(8, scene, dl, 12, device=dev)
                for _ in range(2)]
        (img, net_dp, opt_dp, eps, aux), (img1, net1, opt1, eps1, _) = both(
            f"render_frame_neural_q_wavefront_dp {half}x{half} 1 spp, "
            f"pix_mux 8",
            lambda: dp.render_frame_neural_q_wavefront_dp(
                1987, scene, camera, *nets[0], dl.epsilon_start, cfg, rl,
                dl, mesh, pix_mux=8),
            lambda: dw.render_frame_neural_q_wavefront(
                rank_seed(1987, 0), scene, camera, *nets[1],
                dl.epsilon_start, cfg, rl, dl, pix_mux=8), ("B4a",))
        check_image("neural-q dp", img, half)
        check(torch.equal(img, img1) and eps == eps1
              == nq.decay_epsilon(dl.epsilon_start, 1, dl)
              and digest(*net_dp.parameters(), *opt_dp.mu)
              == digest(*net1.parameters(), *opt1.mu),
              "neural-q dp: not the single frame, net or epsilon")
        log(f"[21] both deep frames bit-equal to the single-process ones "
            f"(the training frame's net and Adam state too), loss "
            f"{float(aux['loss']):.6g}, epsilon {eps}")

        # the lockstep neural-Q training sample at half the lockstep's size
        lock = small // 2
        cfg = RenderConfig(width=lock, height=lock, samples_per_pixel=1,
                           max_ray_bounces=80)
        nets = [nq.init_neural_q(9, scene, dl, 12, device=dev)
                for _ in range(2)]
        (tp, *_, loss), (img1, *_) = both(
            f"neural_q_train_step_dp {lock}x{lock} (lockstep)",
            lambda: dp.neural_q_train_step_dp(
                1988, scene, camera, *nets[0], 0.3, cfg, rl, dl, mesh),
            lambda: nq.render_frame_neural_q(
                rank_seed(1988, 0), scene, camera, *nets[1], 0.3, cfg, rl,
                dl), ("B4a",))
        a, b = tp.double().mean(-1), img1.double().reshape(-1, 3).mean(-1)
        z = float((a.mean() - b.mean()) / ((a - b).var() / a.numel())
                  .sqrt())
        check(torch.isfinite(tp).all() and np.isfinite(float(loss))
              and abs(z) < 4.0, f"neural_q_train_step_dp: z {z}")
        log(f"[21] the lockstep sample's mean vs a single-process 1-spp "
            f"frame from the same net: z {z:+.3f} (limit 4)")

        # multiscene: the batch render and the joint training
        room = presets.get("test_room")
        scenes = [scene, room.load(device=dev)]
        cams = [camera, Camera.create(room.camera_position)]
        cfg = RenderConfig(width=small, height=small, samples_per_pixel=8,
                           max_ray_bounces=80, ray_tile=small * small)
        imgs, ref = both(
            f"render_multiscene_dp cornell + test_room {small}x{small} 8 spp",
            lambda: multiscene.render_multiscene_dp(1989, scenes, cams, cfg,
                                                    mesh),
            lambda: [render_default(1990 + k, s, c, cfg, dev)[0]
                     for k, (s, c) in enumerate(zip(scenes, cams))])
        for k in range(2):
            gap = float(imgs[k].mean()) / float(ref[k].mean()) - 1.0
            check(abs(gap) <= 0.02, f"multiscene scene {k}: {gap:+.2%}")
        cfg = RenderConfig(width=small, height=small, samples_per_pixel=1,
                           max_ray_bounces=80)
        inits = [multiscene.init_multiscene_neural_q(10, scenes, dl, 12,
                                                     device=dev)
                 for _ in range(2)]
        p0 = digest(*inits[0][0].parameters())
        (imgs, net_ms, opt_ms, eps, aux), img1 = both(
            f"train_multiscene_deep_dp cornell + test_room {small}x{small} "
            f"1 spp",
            lambda: multiscene.train_multiscene_deep_dp(
                1991, scenes, cams, *inits[0][:2], 0.05, cfg, rl, dl, mesh,
                batched=inits[0][2]),
            lambda: [dw.render_frame_neural_q_wavefront(
                rank_seed(1991, 0), multiscene.scene_at(inits[1][2], k),
                c, *inits[1][:2], 0.05, cfg, rl, dl, pix_mux=2)[0]
                for k, c in enumerate(cams)], ("B4a",))
        net1, opt1 = inits[1][:2]
        check(tuple(imgs.shape) == (2, small, small, 3)
              and torch.isfinite(imgs).all()
              and digest(*net_ms.parameters()) != p0
              and abs(eps - 0.05) < 1e-6, "train_multiscene_deep_dp")
        check(all(torch.equal(imgs[k], img1[k]) for k in range(2))
              and digest(*net_ms.parameters(), *opt_ms.mu)
              == digest(*net1.parameters(), *opt1.mu),
              "train_multiscene_deep_dp: not the single-process frames")
        log(f"[21] multiscene: each batch image's mean within 2% of the "
            f"single-process render's; the joint training (both scenes on "
            f"the one rank, one after the other) bit-equal to two "
            f"single-process training frames on the padded scenes, net and "
            f"Adam state too")

        # the scaling bench: size 1 runs, size 2 is skipped (one card)
        cfg = RenderConfig(width=256, height=256, samples_per_pixel=4,
                           max_ray_bounces=20, ray_tile=256 * 256)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rows = run_scaling(scene, camera, cfg, [1, 2], repeats=3,
                               device=dev.type, timeout=300)
        for line in buf.getvalue().splitlines():
            log(f"[21] scaling_bench: {line}")
        for r in rows:
            log(f"[21] scaling_bench row: {json.dumps(r)}")
        fit = [d for d in (1, 2) if d <= available_devices(dev.type)]
        check([r["devices"] for r in rows] == fit
              and ("# skipping size 2" in buf.getvalue()) == (fit == [1]),
              f"scaling_bench rows {rows}")
        res["scaling_rows"] = rows
    finally:
        dist.destroy_process_group()

    # two ranks sharing the card over gloo (NCCL takes one rank a card)
    log(f"[21] two ranks on the one card over gloo: sarsa_mega_train_dp "
        f"16 spp a rank and render_guided_mega_dp 32 spp at {size}x{size}, "
        f"render_frame_neural_q_wavefront_dp at {small // 2}x{small // 2}")
    (r0, r1), s_gloo = timed(dev, lambda: multihost.spawn(
        gloo_rank, 2, (size, small // 2, dev.type), timeout=300))
    for r, o in enumerate((r0, r1)):
        log(f"[21] gloo rank {r}: launches {o['launches']}, seconds "
            + ", ".join(f"{k} {v:.4f}" for k, v in o["seconds"].items())
            + f"; td {o['td']} == visit delta {o['visit_delta']:.0f}")
        check(o["on_card"] and o["finite"] and o["visits_exact"]
              and all(o["launches"][n] > 0 for n in ("B2", "B3", "B4a"))
              and o["visit_delta"] == o["td"] > 0,
              f"gloo rank {r}: {o}")
    check(r0["state"] == r1["state"] and r0["net"] == r1["net"]
          and r0["nq_image"] == r1["nq_image"] and r0["eps"] == r1["eps"],
          "gloo ranks: the replicated state differs")
    gap = r0["guided_mean"] / mega_mean - 1.0
    log(f"[21] gloo: merged q, visits and images, the net and its Adam "
        f"state bit-identical on both ranks; visits == v0 + c_0 + c_1 "
        f"exactly; guided mean after the merged frame vs mega {gap:+.4%}; "
        f"{s_gloo:.2f} s in all (spawn and set-up included)")
    res.update(world_1_seconds=t_world, gloo_seconds=[r0["seconds"],
                                                      r1["seconds"]],
               gloo_launches=[r0["launches"], r1["launches"]],
               gloo_total_seconds=s_gloo)
    return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=ROOT / "build" / "smoke",
                        help="directory for the images and results.json")
    out_dir = parser.parse_args(argv).out
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card: "
                         "torch.cuda.is_available() is false")
    from rlrpt_tpu_torch import _cuda
    from rlrpt_tpu_torch import bench as bench_twin
    from rlrpt_tpu_torch.camera import Camera
    from rlrpt_tpu_torch.config import RadianceVolumeConfig, RenderConfig
    from rlrpt_tpu_torch.integrators.wavefront import render_wavefront
    from rlrpt_tpu_torch.ops import guided_mega as gm
    from rlrpt_tpu_torch.ops import bvh as bv
    from rlrpt_tpu_torch.ops import guided_mega_train as gt
    from rlrpt_tpu_torch.ops import intersect_pallas as ip
    from rlrpt_tpu_torch.ops import megakernel as mk
    from rlrpt_tpu_torch.ops.hemisphere import sector_cos_thetas
    from rlrpt_tpu_torch.scene import cornell_box
    from rlrpt_tpu_torch.tools import render
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
    name = "?"
    for line in _cuda.BuildInfo.log.splitlines():
        if "Function properties for " in line:
            name = kernel_name(line.split("Function properties for ")[1])
        if "registers" in line or "spill" in line:
            log(f"[1]   ptxas {name}: {line.strip()}")

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
    clutter_tables = mk.pack_scene(clutter_scene(dev))
    clutter_pad = mk._t_pad(clutter_tables[0].shape[0])
    for label, skew, scene_tables, t_pad in (
            ("initial table", 0.0, (tris, mat), 40),
            ("skewed table", 3.0, (tris, mat), 40),
            ("cornell+250 tris (2 tiles), skewed table", 3.0, clutter_tables,
             clutter_pad)):
        cdf_t = skewed_table(dev, skew, t_pad).cdf.T.contiguous()
        before = gm.KERNEL.launches
        k_out = gm.mega_guided_frame(777, cam, *scene_tables, cdf_t, 11, 4,
                                     cfg, n_slots, 1)
        check(gm.KERNEL.launches == before + 1, "B3 launch not counted")
        p_out = gm.mega_guided_frame_plain(777, cam, *scene_tables, cdf_t, 11,
                                           4, cfg, n_slots, 1)
        b3_err = max(b3_err, compare(label, k_out, p_out, cfg))
    # the binary search needs non-decreasing columns: one that decreases
    # must raise before any launch
    bad = skewed_table(dev, 0.0).cdf.T.contiguous()
    bad[17, 40] = bad[17, 39] - 0.125
    before = gm.KERNEL.launches
    try:
        gm.mega_guided_frame(777, cam, tris, mat, bad, 11, 4, cfg, n_slots, 1)
        raised = False
    except ValueError as e:
        raised = "decrease" in str(e)
    check(raised and gm.KERNEL.launches == before,
          "check_cdf let a decreasing CUDA table through")
    log("[3] check_cdf raised ValueError on a CUDA table with one decreasing "
        "column; nothing launched")

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
    n_tris = tris.shape[0]
    b1_bound, b1_by = frame_bound("B1", b1_plain_out, n_tris)
    log(f"[4] B1 at 720x720 1spp 80 bounces: kernel {b1_ms:.4f} ms, "
        f"torch twin {b1_plain_ms:.1f} ms; bound {b1_bound:.4f} ms "
        f"({b1_by}; {float(b1_plain_out[1].double().sum()):.0f} segments), "
        f"{b1_bound / b1_ms:.4f} of it reached")
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
    b3_bound, b3_by = frame_bound("B3", b3_plain_out, n_tris,
                                  cdf_t.numel() * 2)
    log(f"[4] B3 at 720x720 32spp 80 bounces: kernel {b3_ms:.3f} ms, "
        f"torch twin {b3_plain_ms:.1f} ms; bound {b3_bound:.4f} ms "
        f"({b3_by}; {float(b3_plain_out[1].double().sum()):.0f} segments), "
        f"{b3_bound / b3_ms:.4f} of it reached")
    # B3's ablated kernels (render_guided_mega(ablate=...), perf
    # attribution only): bit-equal to their twins at 128x128, 4 spp and
    # at the main point, then B3's three modes timed in turns there
    log("[4] B3's ablated kernels (uniform, fetch) vs their twins, "
        "bit-equal, at 128x128 4spp and 720x720 32spp (80 bounces, the "
        "initial table)")
    small4 = RenderConfig(width=128, height=128, samples_per_pixel=4,
                          max_ray_bounces=80)
    n_small4 = mk.n_slots_for(small4.n_pixels, mk.R_TILE, mk.PIX_MUX)
    ablated = {}
    for mode, kern in (("uniform", gm.KERNEL_UNIFORM),
                       ("fetch", gm.KERNEL_FETCH)):
        err = 0.0
        for label, cfg_a, ns_a, seed in (
                ("128x128 4spp", small4, n_small4, 31),
                ("720x720 32spp", sarsa, n_slots, 6)):
            before = kern.launches
            k_out = gm.mega_guided_frame(seed, cam, tris, mat, cdf_t, 11, 4,
                                         cfg_a, ns_a, mk.PIX_MUX,
                                         ablate=mode)
            check(kern.launches == before + 1,
                  f"B3 ablate={mode} launch not counted")
            plain_ms, p_out = host_ms(lambda: gm.mega_guided_frame_plain(
                seed, cam, tris, mat, cdf_t, 11, 4, cfg_a, ns_a, mk.PIX_MUX,
                ablate=mode))
            err = max(err, compare(f"B3 ablate={mode} {label}", k_out, p_out,
                                   cfg_a))
            check(all(torch.equal(a, b) for a, b in zip(k_out, p_out)),
                  f"B3 ablate={mode} {label}: kernel and twin differ")
        bound = frame_bound(f"B3 {mode}", p_out, n_tris,
                            cdf_t.numel() * 2 if mode == "fetch" else 0)
        ablated[mode] = {"max_abs_err": err, "plain_ms": plain_ms,
                         "bound_ms": bound[0], "bound_by": bound[1]}
    turns = ablate_turns(lambda m: lambda: gm.mega_guided_frame(
        6, cam, tris, mat, cdf_t, 11, 4, sarsa, n_slots, mk.PIX_MUX,
        ablate=m), 5)
    for m, t in turns.items():
        log(f"[4] B3 ablate={m} 720x720 32spp, 5 launches a turn in turns "
            f"(none, uniform, fetch, fetch, uniform, none, twice): ms "
            + ", ".join(f"{x:.4f}" for x in t["ms"])
            + f"; {t['segments']:.0f} segments, {t['ns_per_segment']:.6f} "
            f"ns a segment")
    ns_seg = {m: t["ns_per_segment"] for m, t in turns.items()}
    sampler_share = (ns_seg["none"] - ns_seg["uniform"]) / ns_seg["none"]
    read = (ns_seg["fetch"] - ns_seg["uniform"]) / ns_seg["none"]
    frame_ms = {m: statistics.mean(t["ms"]) for m, t in turns.items()}
    frame_share = (frame_ms["none"] - frame_ms["uniform"]) / frame_ms["none"]
    frame_read = (frame_ms["fetch"] - frame_ms["uniform"]) / frame_ms["none"]
    log(f"[4] the guided sampler's share of B3 (the ablated paths are "
        f"longer, so it lies between the two): per frame "
        f"{frame_share:.4f}, per traced segment {sampler_share:.4f}; of it "
        f"the column's address and one load {frame_read:.4f} and "
        f"{read:.4f} on {card}")
    for m in ablated:
        ablated[m]["ms"] = statistics.mean(turns[m]["ms"])
        log(f"[4] B3 ablate={m}: kernel {ablated[m]['ms']:.3f} ms, torch "
            f"twin {ablated[m]['plain_ms']:.1f} ms; bound "
            f"{ablated[m]['bound_ms']:.4f} ms ({ablated[m]['bound_by']}), "
            f"{ablated[m]['bound_ms'] / ablated[m]['ms']:.4f} of it reached")

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
    b2_iters = int(b2_plain_out[2].max())
    b2_bound, b2_by = frame_bound(
        "B2", b2_plain_out, n_tris, cdf_t.numel() * 2 + 4 * 4 * q_in.numel(),
        extra_ops=b2_iters * 121 * lum.numel() * APPLY_OPS)
    log(f"[6] B2 at 720x720 32spp 80 bounces: {b2_ms:.3f} ms per learning "
        f"frame (CUDA events around the wrapper: its one cooperative "
        f"launch, the buffers' zero fills and the table check), torch twin "
        f"{b2_plain_ms:.1f} ms; {b2_iters} iterations; bound "
        f"{b2_bound:.4f} ms ({b2_by}), {b2_bound / b2_ms:.4f} of it "
        f"reached; B3 at the same point {b3_ms:.3f} ms")
    n_sync = 2000
    grid_blocks = gt.barrier_probe(n_slots, 10, dev)
    sync_us = kernel_ms(lambda: gt.barrier_probe(n_slots, n_sync, dev),
                        3) * 1e3 / n_sync
    log(f"[6] grid barrier on B2's grid ({grid_blocks} blocks of 128): "
        f"{sync_us:.4f} us each (mean of {n_sync} in one launch, 3 "
        f"launches); 2 per iteration: {2 * b2_iters * sync_us / 1e3:.4f} ms "
        f"of the frame")
    b2_kernels, sync_before, sync_after = profile_train_frame(
        lambda: gt.mega_train_frame(*args))
    log(f"[6] one 720x720 learning frame under torch.profiler: "
        f"{sum(b2_kernels.values())} device kernels ("
        + ", ".join(f"{n} x{c}" for n, c in sorted(b2_kernels.items()))
        + f"); host syncs before the cooperative launch (set-up, check_cdf): "
        f"{sync_before}; after it, inside the frame: {sync_after}")
    n_train = sum(c for n, c in b2_kernels.items() if "train_kernel" in n)
    check(n_train == 1 and not sync_after,
          f"a learning frame launched the train kernel {n_train} times and "
          f"synchronised {len(sync_after)} times after the launch")

    # ---- 7: B4a, B4b, B4c vs their twins and the sweep ------------------
    log("[7] B4a/b/c closest_hit (the BVH walk) vs the torch twin (t, idx "
        "and mat rows bit-equal; active_count at half the batch) and vs "
        "the brute-force sweep kernel at full width; timed against the "
        "sweep in turns")
    b4_err = dict.fromkeys(("B4a", "B4b", "B4c"), 0.0)
    b4_ms, b4_plain_ms, b4_bound, b4_walk = {}, {}, {}, {}
    b4_graph_ms = {}
    gen = torch.Generator(device=dev).manual_seed(11)
    clutter = clutter_scene(dev)
    for scene_name, sc in (("cornell", cornell), ("clutter", clutter)):
        s_tris, s_mat = ip.pack_scene_mxu(sc)
        s_bvh = bv.build_bvh(s_tris)
        cam_o, cam_d, o, d = hit_rays(dev, s_tris, s_mat, gen)
        half = torch.tensor([o.shape[0] // 2], dtype=torch.int32, device=dev)
        full = torch.tensor([cam_o.shape[0]], dtype=torch.int32, device=dev)
        for name, fn, kern, tables in (
                ("B4b", ip.closest_hit_packed, ip.KERNEL_F32, (s_tris,)),
                ("B4c", ip.closest_hit_packed_mxu, ip.KERNEL_MXU, (s_tris,)),
                ("B4a", ip.closest_hit_mat_mxu, ip.KERNEL_MAT,
                 (s_tris, s_mat))):
            before = kern.launches
            k_out = fn(o, d, *tables, half, bvh=s_bvh)
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
            # stream-timed as in PRs 2-6 (the kernels line's ms: the
            # wrappers' host time included), and in a CUDA graph
            run = lambda: fn(cam_o, cam_d, *tables, full,  # noqa: E731
                             bvh=s_bvh)
            ms, g_ms = kernel_ms(run, 50), graph_ms(run, 50)
            plain_ms, _ = host_ms(lambda: ip.closest_hit_plain(
                cam_o, cam_d, s_tris, cam_o.shape[0], *tables[1:]))
            if scene_name == "cornell":
                b4_ms[name], b4_plain_ms[name] = ms, plain_ms
                b4_graph_ms[name] = g_ms
            hits = float((k_out[0] < 1e38).float().mean())
            log(f"  {name} {scene_name} ({s_tris.shape[0]} triangles), "
                f"{o.shape[0]} rays, count {int(half)}: bit-equal, "
                f"{hits:.4f} hit; 518,400 camera rays: kernel {ms:.4f} ms "
                f"(stream, 50 launches), {g_ms:.4f} ms (50 in a CUDA "
                f"graph), torch twin {plain_ms:.1f} ms")
        n_cam = cam_o.shape[0]
        e_o, e_d = edge_rays(s_tris, 7)
        walk_vs_sweep(f"[7] {scene_name}", s_tris, s_mat, s_bvh, {
            "camera + bounce rays": (o, d, o.shape[0]),
            "camera + bounce rays, count at half": (o, d, o.shape[0] // 2),
            "edge, vertex and grazing rays": (e_o, e_d, e_o.shape[0])})
        b4_walk[scene_name] = {
            "camera": walk_timing(f"[7] {scene_name} camera rays", cam_o,
                                  cam_d, s_tris, s_mat, s_bvh),
            "bounce": walk_timing(f"[7] {scene_name} bounce rays",
                                  o[n_cam:].contiguous(),
                                  d[n_cam:].contiguous(), s_tris, s_mat,
                                  s_bvh)}
        if scene_name == "cornell":
            cw = b4_walk["cornell"]["camera"]
            for name in ("B4a", "B4b", "B4c"):
                # B4b and B4c write no row: 64 bytes a ray fewer
                nbytes = cw["rays"] * (24 + 8 + (64 if name == "B4a" else 0))
                ops = (cw["visits_per_ray"] * 2 * BOX_OPS
                       + cw["tests_per_ray"] * MT_OPS) * cw["rays"]
                tab = s_bvh.nodes.numel() * 4 + s_tris.shape[0] * (
                    52 + (64 if name == "B4a" else 0))
                b4_bound[name] = bound_ms(ops, nbytes + tab)
                log(f"  {name} cornell camera rays: counted bound "
                    f"{b4_bound[name][0]:.5f} ms ({b4_bound[name][1]}), "
                    f"share {b4_bound[name][0] / b4_ms[name]:.4f} of the "
                    f"stream time, "
                    f"{b4_bound[name][0] / b4_graph_ms[name]:.4f} of the "
                    f"graph time")

    # ---- the paths, each counted from zero ------------------------------
    kernels = {"B1": mk.KERNEL, "B1 culled": mk.KERNEL_CULL, "B3": gm.KERNEL,
               "B3 uniform": gm.KERNEL_UNIFORM, "B3 fetch": gm.KERNEL_FETCH,
               "B2": gt.KERNEL, "B4a": ip.KERNEL_MAT, "B4b": ip.KERNEL_F32,
               "B4c": ip.KERNEL_MXU, "BVH build": bv.KERNEL_BUILD}
    launches = dict.fromkeys(kernels, 0)

    def drive(path: str, expect, fn):
        """fn() with every count at 0; the expected kernels must launch,
        and the brute-force sweep (no path's kernel) must not, nor the
        culled B1 where it is not expected (a scene of one chunk sweeps),
        nor B3's ablated kernels (perf attribution only); every tree the
        path built must come from the build kernel.
        bv.BUILDS holds the run's BVH builds afterwards."""
        for kern in (*kernels.values(), ip.KERNEL_SWEEP):
            kern.launches = 0
        bv.BUILDS = 0
        out = fn()
        torch.cuda.synchronize()
        counts = {n: k.launches for n, k in kernels.items()}
        log(f"[{path}] launches: " + ", ".join(
            f"{n} {c}" for n, c in counts.items() if c)
            + (f"; BVH builds {bv.BUILDS}" if bv.BUILDS else ""))
        check(all(counts[n] > 0 for n in expect),
              f"{path}: a kernel of the path never launched: {counts}")
        check(ip.KERNEL_SWEEP.launches == 0,
              f"{path}: the brute-force sweep ran on a path")
        check("B1 culled" in expect or counts["B1 culled"] == 0,
              f"{path}: the culled B1 ran on a path that sweeps")
        check(all(n in expect or counts[n] == 0
                  for n in ("B3 uniform", "B3 fetch")),
              f"{path}: an ablated B3 kernel ran on a path")
        check(counts["BVH build"] == bv.BUILDS, f"{path}: {bv.BUILDS} BVH "
              f"builds, {counts['BVH build']} of them by the build kernel")
        for n in set(expect) | {"BVH build"}:
            launches[n] += counts[n]
        return out

    # 4: the bench point through the user entry point
    scene = cornell_box(device=dev)
    camera = Camera.create(CAM)

    def bench_point():
        """The bench twin's protocol (rlrpt_tpu_torch.bench)."""
        out = bench_twin.measure(dev, log=lambda t, rays, ms: log(
            f"[4] trial {t}: {rays / 1e9:.4f} G rays/s ({ms:.4f} ms/frame)"))
        img = out["image"]
        check(bool(torch.isfinite(img).all()) and float(img.mean()) > 0.0,
              "the bench frame is not finite and lit")
        return out["trials"]

    trials = drive("4", ("B1",), bench_point)
    rays_per_s = statistics.median(trials)
    log(f"[4] bench point rays/s (median of 5): {rays_per_s:.6g} "
        f"on {card}")
    # JAX forces the cull off on a one-chunk scene: cull=True on Cornell
    # launches the sweep kernel and builds no tree
    drive("4", ("B1",), lambda: mk.render_default_mega(
        5, scene, camera, bench, dev, cull=True))
    check(bv.BUILDS == 0, f"cull=True on Cornell built {bv.BUILDS} trees")
    log("[4] render_default_mega(cull=True) on Cornell: the sweep kernel, "
        "no tree")

    def ablate_path():
        """render_guided_mega(ablate=...) at the main point, each mode once
        (wrong images by design: finite and lit is all that is checked)."""
        table = skewed_table(dev, 0.0)
        for mode in ("uniform", "fetch"):
            img, aux = gm.render_guided_mega(6, scene, camera, table, sarsa,
                                             dev, ablate=mode)
            check(img.shape == (720, 720, 3)
                  and bool(torch.isfinite(img).all())
                  and float(img.mean()) > 0.0,
                  f"render_guided_mega(ablate={mode!r}): not a finite, lit "
                  "frame")
            log(f"[4] render_guided_mega(ablate={mode!r}) 720x720 32spp: "
                f"mean {float(img.mean()):.6f}, avg path "
                f"{float(aux['avg_path_length']):.4f}")

    drive("4", ("B3 uniform", "B3 fetch"), ablate_path)

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
    check(len(frames) == 10, f"learning path: {len(frames)} frames")
    check_visits("sarsa-mega", frames)
    td_total = sum(fr["td_scatters"] for fr in frames)
    visits = float(aux["visits"].double().sum())
    check(visits == td_total,
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
        f"{float(q.std()):.4f}; visits == td scatters == {td_total}, and "
        f"in every frame; "
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
    drive("9", ("B4a", "BVH build"), lambda: cli("9", "wavefront",
                                                   ["--mode", "wavefront"]))
    check(bv.BUILDS == 1, f"wavefront: {bv.BUILDS} BVH builds in one frame")

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
    check(bv.BUILDS == 1, f"wavefront f32: {bv.BUILDS} BVH builds in one "
                          f"frame")
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

    # 11-13: the fine-map expected-SARSA stack
    fine_state: dict = {}
    fine = fine_map_phases(dev, out_dir, drive, mm, keep=fine_state)
    # 14-17: the deep-Q family
    deep = deep_phases(dev, out_dir, drive, mm)
    # 18: the test room and a generated OBJ at bunny size
    scenes = scene_phases(dev, out_dir, drive)
    # 22: the deep-Q family on that OBJ
    deep_obj = obj_deep_phase(dev, out_dir, drive, scenes.pop("preset"),
                              deep["neural_q"]["window"])
    b1_err = max(b1_err, scenes["max_abs_err"]["B1"])
    b3_err = max(b3_err, scenes["max_abs_err"]["B3"])
    b2_err = max(b2_err, scenes["max_abs_err"]["B2"])
    for n in ("B4a", "B4b"):
        b4_err[n] = max(b4_err[n], scenes["max_abs_err"][n])
    # 19: the thesis MAPE protocol; 20: the tools
    evaluation = eval_phase(dev, out_dir, drive, card)
    tools = tool_phase(dev, out_dir, drive)
    # 21: the multi-device layer
    parallel = dp_phase(dev, out_dir, drive, mm, fine_state)
    seconds = phase_seconds(time.perf_counter())
    log_timing(seconds)

    cw = scenes["culled_b1"]["torus_room"]["1 spp"]
    cw32 = scenes["culled_b1"]["torus_room"]["32 spp"]
    bb = scenes["bvh_build"]
    results = {"kernels": [
        {"name": "B1 mega_default", "route": "cuda",
         "source": "rlrpt_tpu_torch/csrc/mega_default.cu",
         "replaces": "rlrpt_tpu/ops/megakernel.py:247",
         "launches": launches["B1"], "max_abs_err": b1_err,
         "ms": b1_ms, "plain_ms": b1_plain_ms, "bound_ms": b1_bound,
         "bound_by": b1_by, "library_ms": None, "share": b1_bound / b1_ms},
        {"name": "B1 mega_default_bvh (culled)", "route": "cuda",
         "source": "rlrpt_tpu_torch/csrc/mega_default.cu",
         "replaces": "rlrpt_tpu/ops/megakernel.py:411",
         "launches": launches["B1 culled"],
         "max_abs_err": scenes["max_abs_err"]["B1 culled"],
         "ms": cw["ms"], "plain_ms": cw["plain_ms"],
         "bound_ms": cw["bound_ms"], "bound_by": cw["bound_by"],
         "library_ms": None, "share": cw["share"],
         "point": "generated OBJ, 4,980 triangles, 720x720, 1 spp, 80 "
                  "bounces",
         "sweep_ms": cw["sweep_mean_ms"],
         "ms_32_spp": cw32["ms"], "sweep_ms_32_spp": cw32["sweep_mean_ms"],
         "bound_ms_32_spp": cw32["bound_ms"],
         "simt_efficiency": cw["simt_efficiency"],
         "simt_efficiency_32_spp": cw32["simt_efficiency"]},
        {"name": "BVH build", "route": "cuda",
         "source": "rlrpt_tpu_torch/csrc/bvh_build.cu",
         "replaces": "rlrpt_tpu/ops/megakernel.py:164",
         "launches": launches["BVH build"], "max_abs_err": bb["max_abs_err"],
         "ms": bb["ms"], "plain_ms": bb["plain_ms"],
         "bound_ms": bb["bound_ms"], "bound_by": bb["bound_by"],
         "library_ms": None, "share": bb["share"],
         "point": "generated OBJ, 4,980 triangles",
         "build_bvh_ms": statistics.median(bb["build_bvh_ms"]),
         "host_build_s": bb["host_build_s"],
         "culled_end_to_end_s": bb["culled_end_to_end_s"]},
        {"name": "B3 mega_guided", "route": "cuda",
         "source": "rlrpt_tpu_torch/csrc/mega_guided.cu",
         "replaces": "rlrpt_tpu/ops/guided_mega.py:137",
         "launches": launches["B3"], "max_abs_err": b3_err,
         "ms": b3_ms, "plain_ms": b3_plain_ms, "bound_ms": b3_bound,
         "bound_by": b3_by, "library_ms": None, "share": b3_bound / b3_ms},
    ] + [
        {"name": f"B3 mega_guided ablate={m}", "route": "cuda",
         "source": "rlrpt_tpu_torch/csrc/mega_guided.cu",
         "replaces": f"rlrpt_tpu/ops/guided_mega.py:{line}",
         "launches": launches[f"B3 {m}"],
         "max_abs_err": ablated[m]["max_abs_err"], "ms": ablated[m]["ms"],
         "plain_ms": ablated[m]["plain_ms"],
         "bound_ms": ablated[m]["bound_ms"],
         "bound_by": ablated[m]["bound_by"], "library_ms": None,
         "share": ablated[m]["bound_ms"] / ablated[m]["ms"],
         "ns_per_segment": ns_seg[m], "b3_ns_per_segment": ns_seg["none"]}
        for m, line in (("uniform", 344), ("fetch", 346))
    ] + [
        {"name": "B2 mega_train", "route": "cuda",
         "source": "rlrpt_tpu_torch/csrc/mega_train.cu",
         "replaces": "rlrpt_tpu/ops/guided_mega_train.py:101",
         "launches": launches["B2"], "max_abs_err": b2_err,
         "ms": b2_ms, "plain_ms": b2_plain_ms, "bound_ms": b2_bound,
         "bound_by": b2_by, "library_ms": None, "share": b2_bound / b2_ms},
    ] + [
        {"name": f"{n} {fn}", "route": "cuda",
         "source": "rlrpt_tpu_torch/csrc/closest_hit.cu",
         "replaces": f"rlrpt_tpu/ops/intersect_pallas.py:{line}",
         "launches": launches[n], "max_abs_err": b4_err[n],
         "ms": b4_ms[n], "plain_ms": b4_plain_ms[n],
         "bound_ms": b4_bound[n][0], "bound_by": b4_bound[n][1],
         "library_ms": None, "share": b4_bound[n][0] / b4_ms[n],
         "graph_ms": b4_graph_ms[n],
         **({"walk_vs_sweep_graph_ms": {
             k: [b4_walk["cornell"][k]["ms"]["walk"],
                 b4_walk["cornell"][k]["ms"]["sweep"]]
             for k in ("camera", "bounce")}} if n == "B4a" else {})}
        for n, fn, line in (("B4a", "closest_hit_mat_mxu", 203),
                            ("B4b", "closest_hit_packed", 48),
                            ("B4c", "closest_hit_packed_mxu", 116))]}
    (out_dir / "results.json").write_text(json.dumps({
        **results, "card": card, "rays_per_s": rays_per_s,
        "rays_per_s_trials": trials, "cli_seconds": secs, "mape": mape,
        "learning_frames": frames, "guided_gap_after_learning": gap,
        "b2_iterations": b2_iters, "b2_grid_blocks": grid_blocks,
        "grid_barrier_us": sync_us, "b2_frame_device_kernels": b2_kernels,
        "b4_walk": b4_walk, "b3_ablate_turns": turns,
        "b3_sampler_share": {"per_frame": frame_share,
                             "per_segment": sampler_share},
        **fine, **deep, "scenes": scenes, "deep_obj": deep_obj,
        "evaluation": evaluation,
        "tools": tools, "parallel": parallel, "phase_seconds": seconds},
        indent=1))
    print(card)
    print(json.dumps(results))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run(argv=None) -> int:
    """main(), with each phase's seconds logged up to a failure too."""
    try:
        return main(argv)
    except Exception:
        log_timing(phase_seconds(time.perf_counter()), " (to the failure)")
        raise


if __name__ == "__main__":
    raise SystemExit(run())
