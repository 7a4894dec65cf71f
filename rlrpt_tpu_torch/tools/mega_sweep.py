"""Sweep and profile probe of kernels B1, B3 and B2 on one CUDA card, and
the variant grid of ``rlrpt_tpu/tools/mega_sweep.py`` (counterpart).

    python -m rlrpt_tpu_torch.tools.mega_sweep [--reps N] [--no-profile]
    python -m rlrpt_tpu_torch.tools.mega_sweep --variants [SPECS] \
        [--repeats 8] [--width 720] [--height 720] [--bounces 80] \
        [--device cuda]

**The variant grid** (``--variants``; alone, ``DEFAULT_VARIANTS``): the
JAX tool's rows.  For each ``;``-separated spec, ``r_tile,pix_mux`` or
JAX's ``r_tile,pix_mux,precision,unroll``, ``run_variant`` times
``render_default_mega`` at the bench point (Cornell, 1 spp, 80-bounce
cap at 720x720 unless --width, --height, --bounces say otherwise) and
one JSON line is printed: ``variant``, ``rays_per_sec`` (the best of
three trials), ``lane_util`` (traced segments over iterations x slots)
and ``mape_vs_f32``, the MAPE of the variant's image against the first
variant's, beside the ``device``.  Every port variant is exact f32, so
the first one stands for JAX's first ``highest`` row; as in JAX, the
column compares only variants that draw the same samples, and is
same-seed Monte Carlo noise otherwise.  In the port those are the
variants of one pix_mux and one slot count n_slots_for(pixels, r_tile,
pix_mux): pixel p sits on slot p mod n_slots, whose iteration counter
keys the RNG (at 720x720 the pix_mux-32 variants of the default grid all
have 16,384 slots).  Precision ``highest`` is the
port's exact f32 hit; any other precision prints JAX's error row,
``{"variant": spec, "error": ...}``, naming ROADMAP A11, and the sweep
carries on.  ``unroll`` is accepted and has no counterpart in the CUDA
kernel, whose slots loop one iteration at a time.  On ``--device cpu``
the plain twin renders (the CPU tests).

**The kernel points** (no ``--variants``; the card only): at the Cornell
box, 720x720 and the 80-bounce cap, one line per point
(kernel, spp, pix_mux, r_tile): the kernel's mean time over --reps
launches (CUDA events; for B2 one learning frame from the initial Q, its
wrapper's set-up included), rays/s (avg path length x pixels x spp over that
time), the avg path length, the longest slot's iteration count, and the
lane efficiency per warp and per block (``lane_efficiency``) that the old
fixed slot-to-thread schedule would have had: the kernels now pull slots
from a queue (csrc/path_common.cuh:run_slots), so these figures measure
the frame's path-length tail, not the kernels' lanes; then B3's three
``ablate`` modes at 32 spp, in turns (``ablate_turns``: ms a turn and ns
a traced segment).  It uses only the
frame wrappers' public signatures, so the same file times another
checkout of the package put first on ``PYTHONPATH`` (run it by path), and
two trees can be compared in turns in one call; a checkout from before
``ablate`` stops at the ablate turns, after its B1, B3 and B2 points.  Then it
times ``render_default_mega`` end to end at the bench point (1 spp,
r_tile R_TILE, pix_mux PIX_MUX) and profiles 20 such frames with
torch.profiler, printing the wall time and the device time of the top
ops.  The card's name, power limit, SM clock, power draw and temperature
(nvidia-smi) are printed first and last, in both modes.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.config import RadianceVolumeConfig, RenderConfig
from rlrpt_tpu_torch.ops import guided_mega as gm
from rlrpt_tpu_torch.ops import guided_mega_train as gt
from rlrpt_tpu_torch.ops import megakernel as mk
from rlrpt_tpu_torch.ops.hemisphere import sector_cos_thetas
from rlrpt_tpu_torch.scene import cornell_box
from rlrpt_tpu_torch.utils.image import mape_score

BLOCK = 128        # csrc/path_common.cuh kBlock: slots per CUDA block
WARP = 32

# (spp, pix_mux, r_tile); r_tile 1024 / pix_mux 32 is the JAX bench.py choice
B1_POINTS = [(spp, pm, 128) for spp in (1, 32) for pm in (1, 2, 4, 8)]
B1_POINTS += [(1, 32, 1024), (32, 32, 1024)]
B3_POINTS = [(1, 1, 128), (32, 1, 128)]
B2_POINTS = [(32, 1, 128)]   # the EVAL protocol's learning frame


# The JAX grid's (r_tile, pix_mux) pairs in its order
# (rlrpt_tpu/tools/mega_sweep.py:35-44); its precision and unroll axes
# tune the TPU kernel only.
DEFAULT_VARIANTS = ("1024,32", "2048,32", "512,32", "1024,64")
SEED = 1984   # the JAX tool's PRNGKey(1984)


def parse_variant(spec: str) -> tuple[int, int]:
    """(r_tile, pix_mux) of a spec "r_tile,pix_mux" or JAX's
    "r_tile,pix_mux,precision,unroll".  Precision "highest" is the port's
    exact f32 hit; any other raises ValueError (ROADMAP A11).  ``unroll``
    is accepted: the CUDA kernel has no counterpart."""
    fields = [f.strip() for f in spec.split(",")]
    if len(fields) not in (2, 4):
        raise ValueError(f"variant {spec!r}: expected r_tile,pix_mux or "
                         "r_tile,pix_mux,precision,unroll")
    if len(fields) == 4:
        if fields[2] != "highest":
            raise ValueError(
                f"precision {fields[2]!r} has no counterpart in the port "
                "(ROADMAP A11): its hits are exact f32, JAX's 'highest'")
        int(fields[3])
    r_tile, pix_mux = int(fields[0]), int(fields[1])
    if r_tile < 1 or pix_mux < 1:
        raise ValueError(f"variant {spec!r}: r_tile and pix_mux must be "
                         ">= 1")
    return r_tile, pix_mux


def run_variant(scene, camera, cfg: RenderConfig, seed_of, r_tile: int,
                pix_mux: int, repeats: int, device):
    """(best rays/s, image, lane_util) of one variant, as JAX's
    run_variant (rlrpt_tpu/tools/mega_sweep.py:47-79): two warm-up frames
    (the image is the second's), then three trials of ``repeats`` frames,
    each timed on the host clock with one synchronize (JAX's float(acc));
    rays = the sum of avg_path_length x pixels x spp.  Frame i renders at
    the kernel seed ``seed_of(i)``: the warm-ups at i = 1000, 1001, trial
    t's frames at t * repeats + i (the indices JAX folds into its key).

    lane_util = segments / (wavefront_iterations x n_slots).  The port's
    wavefront_iterations is the longest slot's count
    (ops.megakernel.assemble); JAX's is its longest tile's, rounded up to
    its unroll, so the two agree at unroll 1.  On a CPU device the plain
    twin renders."""
    dev = torch.device(device)

    def render(i):
        return mk.render_default_mega(seed_of(i), scene, camera, cfg, dev,
                                      r_tile=r_tile, pix_mux=pix_mux)

    for i in range(2):
        img, aux = render(1000 + i)
    img0 = img.cpu()
    rays_per_apl = cfg.n_pixels * cfg.samples_per_pixel
    n_slots = mk.n_slots_for(cfg.n_pixels, r_tile, pix_mux)
    util = (float(aux["avg_path_length"]) * rays_per_apl
            / (int(aux["wavefront_iterations"]) * n_slots))
    best = 0.0
    for trial in range(3):
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        apls = []
        t0 = time.perf_counter()
        for i in range(repeats):
            img, aux = render(trial * repeats + i)
            apls.append(aux["avg_path_length"])
            acc = acc + img.sum()
        float(acc)
        dt = time.perf_counter() - t0
        rays = sum(float(a) for a in apls) * rays_per_apl
        best = max(best, rays / dt)
    return best, img0, util


def sweep_variants(specs: str, cfg: RenderConfig, repeats: int,
                   device) -> None:
    """One JSON line per spec (the module's docstring); frame i of every
    variant renders at kernel seed SEED + i."""
    dev = torch.device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    scene = cornell_box(device=dev)
    camera = Camera.create((0.0, 0.0, -3.0))
    ref = None
    for spec in specs.split(";"):
        try:
            r_tile, pix_mux = parse_variant(spec)
        except ValueError as e:
            print(json.dumps({"variant": spec, "error": str(e)[:200]}),
                  flush=True)
            continue
        rps, img, util = run_variant(scene, camera, cfg,
                                     lambda i: SEED + i, r_tile, pix_mux,
                                     repeats, dev)
        if ref is None:
            ref = img
        print(json.dumps({
            "variant": spec, "rays_per_sec": rps, "lane_util": util,
            "mape_vs_f32": float(mape_score(ref * 255.0, img * 255.0)),
            "device": name}), flush=True)


def lane_efficiency(iters: torch.Tensor, group: int) -> float:
    """Share of the lane-iterations a group of ``group`` consecutive slots
    would spend doing work under a fixed slot-to-thread schedule (one
    thread per slot, a block-synchronous loop: the schedule of the kernels
    before their work-pulling loop).  ``iters[s]`` is slot s's count of
    active iterations; a group (a warp, or a block) then runs as long as
    its longest slot: sum(iters) / (group * sum over groups of
    max(iters))."""
    it = iters.to(torch.int64).reshape(-1, group)
    return float(it.sum()) / float(group * it.max(dim=1).values.sum())


def card_state() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def kernel_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ablate_turns(frame_of, reps: int, rounds: int = 2) -> dict:
    """Kernel B3's ``ablate`` modes timed in turns: ``rounds`` times none,
    uniform, fetch, fetch, uniform, none, each turn the mean of ``reps``
    launches (kernel_ms).  ``frame_of(mode)`` returns a function that
    launches one frame of that mode and returns (rad, path_sum, iters).
    Returns {mode: {"ms": [each turn's ms], "segments": the frame's
    traced segments (the sum of path_sum), "ns_per_segment": the turns'
    mean over them}}.  The differences give the guided sampler's share of
    B3: none - uniform the whole, fetch - uniform the column's address
    and one load (fetch reads one entry, B3 about 7 probes and the hi/lo
    pair).  The ablated modes trace longer paths, so the share per frame
    undercounts it and the share per segment overcounts it where the
    extra segments cost less than the mean: report both."""
    modes = gm.ABLATE_MODES
    res = {m: {"ms": []} for m in modes}
    for _ in range(rounds):
        for m in modes + modes[::-1]:
            res[m]["ms"].append(kernel_ms(frame_of(m), reps))
    for m in modes:
        segments = float(frame_of(m)()[1].double().sum())
        res[m]["segments"] = segments
        mean = sum(res[m]["ms"]) / len(res[m]["ms"])
        res[m]["ns_per_segment"] = mean * 1e6 / segments
    return res


def sweep_point(label: str, frame, cfg: RenderConfig, reps: int) -> None:
    ms = kernel_ms(frame, reps)
    rad, path_sum, iters = frame()
    _, aux = mk.assemble(rad, path_sum, iters, cfg)
    apl = float(aux["avg_path_length"])
    rays = apl * cfg.n_pixels * cfg.samples_per_pixel
    print(f"{label}: {ms:.4f} ms, {rays / ms / 1e6:.4f} G rays/s, "
          f"apl {apl:.4f}, max it {int(aux['wavefront_iterations'])}, "
          f"warp eff {lane_efficiency(iters, WARP):.3f}, "
          f"block eff {lane_efficiency(iters, BLOCK):.3f}", flush=True)


def profile_bench(scene, camera, cfg: RenderConfig, dev, frames: int = 20):
    from torch.profiler import ProfilerActivity, profile
    for i in range(3):
        mk.render_default_mega(i, scene, camera, cfg, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(frames):
        mk.render_default_mega(100 + i, scene, camera, cfg, dev)
    torch.cuda.synchronize()
    print(f"end-to-end render_default_mega: "
          f"{(time.perf_counter() - t0) * 1e3 / frames:.4f} ms/frame")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(frames):
            mk.render_default_mega(200 + i, scene, camera, cfg, dev)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6
    print(f"profiled wall {wall:.1f} us for {frames} frames")
    rows = sorted(prof.key_averages(), key=lambda e: e.device_time_total,
                  reverse=True)
    for e in rows[:14]:
        print(f"  {e.key[:70]:70s} device_us {e.device_time_total:.1f} "
              f"count {e.count}")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=20,
                        help="timed launches per kernel point (default 20)")
    parser.add_argument("--no-profile", action="store_true",
                        help="skip the end-to-end timing and the profile")
    parser.add_argument("--variants", nargs="?", default=None,
                        const=";".join(DEFAULT_VARIANTS),
                        help="run the variant grid instead of the kernel "
                             "points: ';'-separated r_tile,pix_mux"
                             "[,precision,unroll] specs (alone: "
                             "DEFAULT_VARIANTS)")
    parser.add_argument("--repeats", type=int, default=8,
                        help="frames per timed trial of a variant")
    parser.add_argument("--width", type=int, default=720,
                        help="the variant grid's frame width")
    parser.add_argument("--height", type=int, default=720,
                        help="the variant grid's frame height")
    parser.add_argument("--bounces", type=int, default=80,
                        help="the variant grid's bounce cap")
    parser.add_argument("--device", default="cuda",
                        help="the variant grid's device (cpu: the plain "
                             "twin); the kernel points need cuda")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    on_card = torch.device(args.device).type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("mega_sweep --device cuda needs a CUDA card")
    if args.variants is not None:
        if on_card:
            print(card_state(), flush=True)
        sweep_variants(args.variants,
                       RenderConfig(width=args.width, height=args.height,
                                    samples_per_pixel=1,
                                    max_ray_bounces=args.bounces),
                       args.repeats, args.device)
        if on_card:
            print(card_state(), flush=True)
        return 0
    if not on_card:
        raise SystemExit("the kernel points need --device cuda")
    dev = torch.device(args.device)

    def cfg_for(spp):
        return RenderConfig(width=720, height=720, samples_per_pixel=spp,
                            max_ray_bounces=80)

    print(card_state(), flush=True)
    camera = Camera.create((0.0, 0.0, -3.0))
    cam = mk.camera_vector(camera)
    scene = cornell_box(device=dev)
    tris, mat = mk.pack_scene(scene)
    t_pad = mk._t_pad(scene.n_triangles)   # the initial 11x11 / uv 4 table
    q, _ = gt.init_bin_q(t_pad, 4, 11, 100.0 / 121, device=dev)
    cdf_t = gt.rebuild_bin_cdf(q, 11, 4, t_pad).cdf.T.contiguous()

    for spp, pm, rt in B1_POINTS:
        cfg, ns = cfg_for(spp), mk.n_slots_for(720 * 720, rt, pm)
        sweep_point(f"B1 spp {spp} pix_mux {pm} r_tile {rt} slots {ns}",
                    lambda: mk.mega_default_frame(5, cam, tris, mat, cfg, ns,
                                                  pm), cfg, args.reps)
    for spp, pm, rt in B3_POINTS:
        cfg, ns = cfg_for(spp), mk.n_slots_for(720 * 720, rt, pm)
        sweep_point(f"B3 spp {spp} pix_mux {pm} r_tile {rt} slots {ns}",
                    lambda: gm.mega_guided_frame(6, cam, tris, mat, cdf_t, 11,
                                                 4, cfg, ns, pm),
                    cfg, args.reps)
    lum = gt.bin_luminance(scene, t_pad, 4)[0].contiguous()
    sec_cos = sector_cos_thetas(11, dev).contiguous()
    thr = RadianceVolumeConfig(grid_resolution=11).radiance_threshold
    visits = torch.zeros_like(q)
    for spp, pm, rt in B2_POINTS:
        cfg, ns = cfg_for(spp), mk.n_slots_for(720 * 720, rt, pm)
        sweep_point(f"B2 spp {spp} pix_mux {pm} r_tile {rt} slots {ns}",
                    lambda: gt.mega_train_frame(
                        7, cam, tris, mat, cdf_t, lum, sec_cos, q, visits, 11,
                        4, thr, cfg, ns, pm)[:3], cfg, args.reps)
    cfg, ns = cfg_for(32), mk.n_slots_for(720 * 720, 128, 1)
    turns = ablate_turns(lambda m: lambda: gm.mega_guided_frame(
        6, cam, tris, mat, cdf_t, 11, 4, cfg, ns, 1, ablate=m),
        max(1, args.reps // 4))
    for m, t in turns.items():
        print(f"B3 ablate={m} spp 32 pix_mux 1 r_tile 128 slots {ns} "
              f"(in turns): ms " + ", ".join(f"{x:.4f}" for x in t["ms"])
              + f"; {t['segments']:.0f} segments, "
              f"{t['ns_per_segment']:.6f} ns a segment", flush=True)
    print(card_state(), flush=True)
    if not args.no_profile:
        profile_bench(scene, camera, cfg_for(1), dev)
        print(card_state(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
