"""Run one cell of BENCHMARK.json once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds a CUDA card.  The last line of
standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
then ``checks``); the numbers compared with the reference, each beside
its limit, are also the last lines of standard error.  Without a card, or
with fewer than the cell asks for, it prints no result and exits with 3.
"""

import time

T0 = time.perf_counter()   # set-up is timed from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


if __name__ == "__main__":
    args = parse()
    # every cache the run may fill stays inside the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    sys.path.insert(0, str(ROOT))
    from benchmark import harness
    sys.exit(harness.main(args, T0, ROOT))
