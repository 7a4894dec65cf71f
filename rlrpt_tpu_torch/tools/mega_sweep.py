"""Sweep and profile probe of kernels B1, B3 and B2 on one CUDA card
(counterpart of ``rlrpt_tpu/tools/mega_sweep.py``, whose precision and
unroll axes tune the TPU kernel only).

    python -m rlrpt_tpu_torch.tools.mega_sweep [--reps N] [--no-profile]

At the Cornell box, 720x720, 80-bounce cap, prints one line per point
(kernel, spp, pix_mux, r_tile): the kernel's mean time over --reps
launches (CUDA events; for B2 one learning frame from the initial Q, its
wrapper's set-up included), rays/s (avg path length x pixels x spp over that
time), the avg path length, the longest slot's iteration count, and the
lane efficiency per warp and per block (``lane_efficiency``) that the old
fixed slot-to-thread schedule would have had: the kernels now pull slots
from a queue (csrc/path_common.cuh:run_slots), so these figures measure
the frame's path-length tail, not the kernels' lanes.  It uses only the
frame wrappers' public signatures, so the same file times another
checkout of the package put first on ``PYTHONPATH`` (run it by path), and
two trees can be compared in turns in one call.  Then it
times ``render_default_mega`` end to end at the bench point (1 spp,
r_tile R_TILE, pix_mux PIX_MUX) and profiles 20 such frames with
torch.profiler, printing the wall time and the device time of the top
ops.  The card's name, power limit, SM clock, power draw and temperature
(nvidia-smi) are printed first and last.
"""

from __future__ import annotations

import argparse
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

BLOCK = 128        # csrc/path_common.cuh kBlock: slots per CUDA block
WARP = 32

# The least time the card could take for a kernel's work (bound_ms): the
# larger of its f32 operations over the H100 SXM's 67 TFLOP/s (no tensor
# cores; an FMA counts as two) and its bytes (each input read once, each
# output written once) over 3.35 TB/s.  Counted from the sources, per
# segment traced (a closest hit and the bounce after it):
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
MT_OPS = 50   # f32 operations of one ray-triangle test: 46 adds and
#             # multiplies, 4 compares (csrc/path_common.cuh:hit_tris; the
#             # division of a hit aside)
SEGMENT_OPS = {   # f32 operations of a step besides the hit test
    "B1": 75,     # uniforms, hemisphere frame and direction, throughput,
    #             # next origin (advance + UniformSampler)
    "B3": 125,    # the same with CdfSampler: bin column, ~7 probes, pdf,
    #             # concentric map
    "B2": 131,    # B3's plus the TD target and the pending brdf
}
APPLY_OPS = 10    # f32 operations per (sector, column) cell per iteration
BOX_OPS = 26      # f32 operations of one slab test in the BVH walk: 6
#                 # subtracts, 6 multiplies, 10 min/max, the far scale, 3
#                 # compares (csrc/path_common.cuh:box_near and its callers);
#                 # a visited inner node tests its two children's boxes
# (spp, pix_mux, r_tile); r_tile 1024 / pix_mux 32 is the JAX bench.py choice
B1_POINTS = [(spp, pm, 128) for spp in (1, 32) for pm in (1, 2, 4, 8)]
B1_POINTS += [(1, 32, 1024), (32, 32, 1024)]
B3_POINTS = [(1, 1, 128), (32, 1, 128)]
B2_POINTS = [(32, 1, 128)]   # the EVAL protocol's learning frame


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


def bound_ms(ops: float, nbytes: float) -> tuple[float, str]:
    """(least time in ms, what sets it) for ops f32 operations and nbytes
    of device memory traffic."""
    t_ops, t_bytes = ops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def frame_bound(kernel: str, out, n_tris: int, table_bytes: int = 0,
                extra_ops: float = 0.0) -> tuple[float, str]:
    """bound_ms of a megakernel frame from its own outputs: segments =
    the sum of path_sum (every step of every path); bytes = the tables
    read and rad, path_sum, iters written."""
    rad, path_sum, iters = out[:3]
    segments = float(path_sum.double().sum())
    ops = segments * (MT_OPS * n_tris + SEGMENT_OPS[kernel]) + extra_ops
    nbytes = (n_tris * (48 + 64) + table_bytes + rad.numel() * 4
              + path_sum.numel() * 4 + iters.numel() * 4)
    return bound_ms(ops, nbytes)


def walk_frame_bound(out, bvh, visits: int, tests: int) -> tuple[float,
                                                                   str]:
    """bound_ms of a culled B1 frame (the walk in the slot loop), counted
    as B4's: its walks' inner-node visits (two box tests each) and
    triangle tests (megakernel.walk_counts), plus each segment's own step;
    bytes = the tree, the permuted table, its order and the material rows
    read once, and rad, path_sum, iters written."""
    rad, path_sum, iters = out[:3]
    segments = float(path_sum.double().sum())
    ops = (visits * 2 * BOX_OPS + tests * MT_OPS
           + segments * SEGMENT_OPS["B1"])
    nbytes = (bvh.nodes.numel() * 4 + bvh.n_tris * (48 + 4 + 64)
              + rad.numel() * 4 + path_sum.numel() * 4 + iters.numel() * 4)
    return bound_ms(ops, nbytes)


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


def graph_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches captured in one CUDA
    graph and replayed, after one warm-up: no host time falls between the
    launches, so a kernel shorter than its wrapper's host time is timed by
    the device, where kernel_ms would time the host.  fn must be
    capturable: device tensors only, no host sync."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=20,
                        help="timed launches per point (default 20)")
    parser.add_argument("--no-profile", action="store_true",
                        help="skip the end-to-end timing and the profile")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mega_sweep needs a CUDA card")
    dev = torch.device("cuda")
    print(card_state(), flush=True)
    camera = Camera.create((0.0, 0.0, -3.0))
    cam = mk.camera_vector(camera)
    scene = cornell_box(device=dev)
    tris, mat = mk.pack_scene(scene)
    t_pad = mk._t_pad(scene.n_triangles)   # the initial 11x11 / uv 4 table
    q, _ = gt.init_bin_q(t_pad, 4, 11, 100.0 / 121, device=dev)
    cdf_t = gt.rebuild_bin_cdf(q, 11, 4, t_pad).cdf.T.contiguous()

    def cfg_for(spp):
        return RenderConfig(width=720, height=720, samples_per_pixel=spp,
                            max_ray_bounces=80)

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
    print(card_state(), flush=True)
    if not args.no_profile:
        profile_bench(scene, camera, cfg_for(1), dev)
        print(card_state(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
