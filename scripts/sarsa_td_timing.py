"""The fine-map step's lookup and TD kernels (ops/sarsa_td.py) on one CUDA
card, at the fine-map cell's four phase widths (129,600, 32,400, 8,100 and
2,025 lanes; 24,526 volumes, 12x12 sectors, f32 rows):

    python scripts/sarsa_td_timing.py

For each kernel: its device time a launch (torch.profiler over 100 steps),
the bytes its inputs at that width need (each read once, each write once)
over 3.35 TB/s as its bound, the share, and its wrapper's host time a call
(100 calls made with no wait between them).  A step runs the four in
the frame's order on the card cases' inputs (tests/test_torch_sarsa_td.py)
with no lanes crowded onto a few entries, so the scatter's atomics meet
about as seldom as in a frame.  Then the former torch code of the two
stages on the same inputs: its device time, kernels and host time a step.
Prints the card's name and power limit first, then a JSON row per width.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import test_torch_sarsa_td as T  # noqa: E402
from rlrpt_tpu_torch.ops import sarsa_td as td_ops  # noqa: E402
from rlrpt_tpu_torch.ops.hemisphere import sector_cos_thetas  # noqa: E402
from rlrpt_tpu_torch.radiance import grid_bucket as gb  # noqa: E402
from rlrpt_tpu_torch.radiance import volumes as rv  # noqa: E402
from rlrpt_tpu_torch.scene import cornell_box  # noqa: E402
from rlrpt_tpu_torch.config import RadianceVolumeConfig  # noqa: E402

N = 100
KERNEL_NAMES = {"lookup": "lookup_kernel", "targets": "targets_kernel",
                "scatter": "scatter_kernel", "apply": "apply_kernel"}


def device_us(prof, key=None):
    """Device microseconds and kernel count of the profile's events whose
    name holds ``key`` (all with None)."""
    total = count = 0
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = getattr(e, "cuda_time_total", 0)
        if t and (key is None or key in e.key):
            total += t
            count += e.count
    return total, count


def counts(c, pending, s):
    """The step's pending lanes, the volumes they touch and the entries."""
    entries = (c.cur_vol * s + c.cur_sector)[pending]
    return (int(pending.sum()), int(torch.unique(c.cur_vol[pending]).numel()),
            int(torch.unique(entries).numel()))


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    scene = cornell_box(device=dev)
    vols0 = rv.build_radiance_volumes(scene, RadianceVolumeConfig())
    tb = gb.build_volume_class_table(vols0, scene)
    s, v = 144, vols0.n_volumes
    for wp in (129600, 32400, 8100, 2025):
        vols, cdfplus, c, missed, light, lum, nv = T._case(
            wp, 12, v, hot=0.0, seed=wp, device=dev)
        g = torch.Generator().manual_seed(wp)
        qpos = (vols0.position.cpu()[torch.randint(0, v, (wp,), generator=g)]
                + 0.01 * torch.randn((wp, 3), generator=g)).to(dev)
        cls = tb.tri_class[torch.randint(0, scene.n_surfaces, (wp,),
                                         generator=g).to(dev)]
        tri = torch.zeros((wp,), dtype=torch.int64, device=dev)
        cos = sector_cos_thetas(12, dev)
        td = td_ops.td_frame(vols, cdfplus.clone(), cos, T.THR, T.ENV)
        calls = {
            "lookup": lambda: td_ops.find_closest_volume_table(
                tb, qpos, tri, cls=cls),
            "targets": lambda: td_ops.td_targets(td, c, missed, light, lum,
                                                 nv),
        }
        target, pending = calls["targets"]()
        calls["scatter"] = lambda: td_ops.sarsa_contributions(
            c.cur_vol, c.cur_sector, target, pending, v, s, td.scratch)
        calls["apply"] = lambda: td_ops.apply_refresh(td)

        def step():
            for name in ("lookup", "targets", "scatter", "apply"):
                calls[name]()
        for _ in range(5):
            step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(N):
                step()
            torch.cuda.synchronize()
        n_pend, dirty_rows, touched = counts(c, pending, s)
        # bytes each kernel's inputs need, read once, written once
        need = {
            # the hit point, class and answer; the table row's 48 bytes
            "lookup": wp * (12 + 4 + 8 + 48),
            # the lane's state and hit fields, the row's column S; outputs
            "targets": wp * (1 + 8 + 4 + 1 + 1 + 4 + 8 + 4 + 4 + 1),
            # the lane's entry and target; each touched entry's two sums
            # written, each pending lane's volume flag
            "scatter": wp * (8 + 8 + 4 + 1) + touched * 8 + n_pend * 4,
            # the flags; the dirty rows' counts and Q; the touched entries'
            # sums and visits read, Q, visits and both sums written; the
            # rows' luminance and column S
            "apply": v * 4 + dirty_rows * s * 8 + touched * (8 + 16)
            + dirty_rows * 8,
        }
        row = {"lanes": wp, "pending": n_pend, "dirty_rows": dirty_rows,
               "touched": touched}
        for name, key in KERNEL_NAMES.items():
            t, k = device_us(prof, key)
            us = t / max(k, 1)
            bound = need[name] / 3.35e12 * 1e6
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(N):
                calls[name]()
            host = (time.perf_counter() - t0) / N * 1e6
            torch.cuda.synchronize()
            row[name] = {"device_us": round(us, 2), "launches": k,
                         "bound_us": round(bound, 3),
                         "share": round(bound / us, 4) if us else None,
                         "host_us": round(host, 1)}
        # the former torch code of the two stages on the same inputs
        def former():
            gb.find_closest_volume_table(tb, qpos, tri, cls=cls)
            T._former_td(vols, cdfplus, c, missed, light, lum, nv)
        for _ in range(3):
            former()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            former()
        host = (time.perf_counter() - t0) / 20 * 1e6
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            former()
            torch.cuda.synchronize()
        t, k = device_us(prof)
        row["former"] = {"device_us": round(t, 1), "kernels": k,
                         "host_us": round(host, 1)}
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
