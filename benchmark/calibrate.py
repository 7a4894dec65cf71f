"""Readings for the limits of ``correct``: for each seed, one run of a
cell with a short window, its comparisons with the reference, and the
same comparisons with the control (the reference in bfloat16 in the
program's place, on the same inputs), in one process.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 \
        [--seconds 2]

One JSON line a seed: ``checks`` (the program's readings beside the
limits now set) and ``control``.  The lower reading of a number is the
largest the program gives over a dozen seeds or more, the upper the
smallest the control gives (PERF.md, section 2).
"""

import time

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark import harness
    if not torch.cuda.is_available():
        print("calibrate.py needs a CUDA card", file=sys.stderr)
        return 3
    spec = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.find_cell(spec, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = harness.execute(ROOT, spec, cell, seed, args.seconds, False,
                            "cuda", time.perf_counter(), control=True)
        print(json.dumps({"workload": cell["name"], "seed": seed,
                          "correct": r["correct"],
                          "attempted": r["attempted"],
                          "checks": {k: v["value"]
                                     for k, v in r["checks"].items()},
                          "control": r["control"],
                          "phases": r["phases"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
