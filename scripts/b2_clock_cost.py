"""Kernel B2's timed build (its in-kernel phase clock) against the plain
build on the card, at the benchmark's learning frame (the Cornell box at
720x720, 32 spp, 80 bounces, 11x11 sectors x 4x4 uv bins, the table
rebuilt after three learning frames): the device time of each build over
``--frames`` frames each, in turns (plain, timed, timed, plain, ...), from
torch.profiler's kernel records, and the phase shares the clock read over
the timed frames: over every block, and over the blocks that apply, which
the benchmark's b2_*_pct read (profiling.b2_shares: the apply's items go
to the first blocks' warps; the rest wait for them at the second grid
barrier).  ``--ptxas`` prints only what nvcc's ``-Xptxas -v`` said
of every build of train_kernel (registers, stack, spills); it needs
nothing of the timed build, so it reads any version of the package:

    python scripts/b2_clock_cost.py --frames 20
    PYTHONPATH=<tree> python scripts/b2_clock_cost.py --ptxas
"""

import argparse
import os
import statistics
import subprocess
import tempfile

import torch


def ptxas_lines() -> list:
    """nvcc's report of each train_kernel entry of csrc/mega_train.cu,
    compiled alone with the library's flags: its name line and the lines
    after it up to the next entry."""
    from rlrpt_tpu_torch import _cuda
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-c", "-o",
             os.path.join(tmp, "mega_train.o"),
             str(_cuda.CSRC / "mega_train.cu")],
            capture_output=True, text=True, check=True)
    out, keep = [], False
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry function" in line:
            keep = "train_kernel" in line
        if keep and line.strip():
            out.append(line.strip())
    return out


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--frames", type=int, default=20)
    p.add_argument("--ptxas", action="store_true")
    args = p.parse_args()
    if args.ptxas:
        print("\n".join(ptxas_lines()))
        return
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rlrpt_tpu_torch.camera import Camera
    from rlrpt_tpu_torch.config import RadianceVolumeConfig, RenderConfig
    from rlrpt_tpu_torch.ops import guided_mega_train as gt
    from rlrpt_tpu_torch.ops import hemisphere as hs
    from rlrpt_tpu_torch.ops import megakernel as mk
    from rlrpt_tpu_torch.scene import cornell_box
    from rlrpt_tpu_torch.utils import profiling
    dev = torch.device("cuda")
    rl = RadianceVolumeConfig(grid_resolution=11)
    cfg = RenderConfig(width=720, height=720, samples_per_pixel=32,
                       max_ray_bounces=80)
    scene, cam = cornell_box(device=dev), Camera.create([0.0, 0.0, -3.0])
    q, v = gt.init_bin_q(40, 4, 11, rl.initial_radiance, device=dev)
    table = gt.rebuild_bin_cdf(q, 11, 4, 40)
    for f in range(3):
        _, q, v, _ = gt.render_sarsa_mega_train(
            f, scene, cam, table, q, v, cfg, rl.radiance_threshold, dev)
        table = gt.rebuild_bin_cdf(q, 11, 4, 40)
    tris, mat = mk.pack_scene(scene)
    n_slots = mk.n_slots_for(cfg.n_pixels, 128, 1)
    frame = (7, mk.camera_vector(cam), tris, mat, table.cdf.T.contiguous(),
             gt.bin_luminance(scene, 40, 4)[0],
             hs.sector_cos_thetas(11, dev).contiguous(), q, v, 11, 4,
             rl.radiance_threshold, cfg, n_slots, 1)
    rows = gt.train_blocks(n_slots, dev)
    clock = torch.zeros((rows, len(profiling.CLOCK_COLS)), dtype=torch.int64,
                        device=dev)
    order = [("plain", "timed", "timed", "plain")[i % 4]
             for i in range(2 * args.frames)]
    for build in ("plain", "timed"):   # warm both
        gt.mega_train_frame(*frame, clock=clock if build == "timed" else None)
    torch.cuda.synchronize()
    clock.zero_()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        for build in order:
            gt.mega_train_frame(*frame,
                                clock=clock if build == "timed" else None)
            torch.cuda.synchronize()
    ms = sorted((e.time_range.start, e.time_range.elapsed_us() / 1e3)
                for e in prof.events()
                if e.device_type == DeviceType.CUDA
                and "train_kernel" in e.name)
    if len(ms) != len(order):
        raise RuntimeError(f"{len(ms)} train_kernel records for "
                           f"{len(order)} frames")
    times = {b: [t for (_, t), o in zip(ms, order) if o == b]
             for b in ("plain", "timed")}
    med = {b: statistics.median(t) for b, t in times.items()}
    print(f"{torch.cuda.get_device_name(0)}; {rows} blocks")
    for b, t in times.items():
        print(f"{b}: median {med[b]:.4f} ms over {len(t)} frames, "
              f"min {min(t):.4f}, max {max(t):.4f}")
    print(f"timed / plain: {med['timed'] / med['plain']:.5f}")
    col = {n: i for i, n in enumerate(profiling.CLOCK_COLS)}
    sums = clock.sum(dim=0).tolist()
    every = {n: 100 * sums[i] / sums[col["total"]]
             for i, n in enumerate(profiling.CLOCK_COLS[:5])}
    apply = clock[:, col["apply"]]
    applying = int((2 * apply >= apply.max()).sum())
    for label, shares in (
            ("every block's", every),
            (f"the {applying} applying blocks'", profiling.b2_shares(clock))):
        print(f"phase shares of {label} cycles (%): " + ", ".join(
            f"{n} {v:.3f}" for n, v in shares.items()))
    top = int(apply.argmax())
    longest = float(clock[top, col["apply"]] / clock[top, col["total"]])
    print(f"the longest apply (block {top}) a timed frame: "
          f"{longest * med['timed']:.4f} ms")
    iters = int(clock[:, col["iterations"]].sum())
    print(f"iterations a frame: {iters / rows / len(times['timed'])}")


if __name__ == "__main__":
    main()
