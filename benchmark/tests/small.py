"""Tiny sizes of the cells for the CPU tests, and a helper that runs a
cell once on the CPU."""

import time
from pathlib import Path

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]

SMALL = {
    "config": {"width": 16, "height": 12, "max_ray_bounces": 6, "gt": None},
    "traffic": {"warmup_frames": 1, "warmup_jobs": 1, "frames": 3, "spp": 4,
                "guided_spp": 4},
}
CELLS = ("cornell_sarsa_mega_32spp", "cornell_mega_1spp")


def spec():
    return harness.load_json(ROOT / "BENCHMARK.json")


def run_cell(name, seconds=0.3, trace=False, **kw):
    s = spec()
    return harness.execute(ROOT, s, harness.find_cell(s, name), 2 ** 33 + 7,
                           seconds, trace, "cpu", time.perf_counter(),
                           overrides=SMALL, **kw)
