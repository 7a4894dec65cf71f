"""Sweep and profile probe of kernels B1 and B3 on one CUDA card
(counterpart of ``rlrpt_tpu/tools/mega_sweep.py``, whose precision and
unroll axes tune the TPU kernel only).

    python -m rlrpt_tpu_torch.tools.mega_sweep [--reps N] [--no-profile]

At the Cornell box, 720x720, 80-bounce cap, prints one line per point
(kernel, spp, pix_mux, r_tile): the kernel's mean time over --reps
launches (CUDA events), rays/s (avg path length x pixels x spp over that
time), the avg path length, the longest slot's iteration count, and the
lane efficiency per warp and per block (``lane_efficiency``).  Then it
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
from rlrpt_tpu_torch.config import RenderConfig
from rlrpt_tpu_torch.ops import guided_mega as gm
from rlrpt_tpu_torch.ops import megakernel as mk
from rlrpt_tpu_torch.ops.guided_mega_train import init_bin_q, rebuild_bin_cdf
from rlrpt_tpu_torch.scene import cornell_box

BLOCK = 128        # csrc/path_common.cuh kBlock: slots per CUDA block
WARP = 32
# (spp, pix_mux, r_tile); r_tile 1024 / pix_mux 32 is the JAX bench.py choice
B1_POINTS = [(spp, pm, 128) for spp in (1, 32) for pm in (1, 2, 4, 8)]
B1_POINTS += [(1, 32, 1024), (32, 32, 1024)]
B3_POINTS = [(1, 1, 128), (32, 1, 128)]


def lane_efficiency(iters: torch.Tensor, group: int) -> float:
    """Share of the lane-iterations a group of ``group`` consecutive slots
    spends that do work.  ``iters[s]`` is the iteration at which slot s
    went idle, i.e. its count of active iterations; a group (a warp, or a
    block, whose loop is block-synchronous) runs as long as its longest
    slot: sum(iters) / (group * sum over groups of max(iters))."""
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
    q, _ = init_bin_q(t_pad, 4, 11, 100.0 / 121, device=dev)
    cdf_t = rebuild_bin_cdf(q, 11, 4, t_pad).cdf.T.contiguous()

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
    print(card_state(), flush=True)
    if not args.no_profile:
        profile_bench(scene, camera, cfg_for(1), dev)
        print(card_state(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
