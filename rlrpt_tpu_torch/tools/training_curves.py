"""Training-curve plots (counterpart of
``rlrpt_tpu/tools/training_curves.py``; ref:
Graphing/training_curve_generator.py).

Reads a stats file of `avg_path_length loss zero_contribution_paths` lines
(the format utils.stats.StatsLogger writes, the reference's
nn_training_stats.txt / sarsa_training_stats.txt) and saves the three
curves as PNGs next to it.  matplotlib is imported only when drawing.

    python -m rlrpt_tpu_torch.tools.training_curves stats.txt
"""

from __future__ import annotations

import os
import sys

import numpy as np

from rlrpt_tpu_torch.utils.stats import read_stats


def plot_stats(path: str) -> list[str]:
    rows = read_stats(path)
    if not rows:
        return []
    arr = np.asarray(rows, np.float64)
    base = os.path.splitext(path)[0]

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out = []
    for col, label, suffix in ((0, "Average Path Length", "path_length"),
                               (1, "Training Loss", "loss"),
                               (2, "Zero contribution light paths", "zclp")):
        plt.figure()
        plt.plot(np.arange(len(arr)), arr[:, col])
        plt.xlabel("Epochs")
        plt.ylabel(label)
        name = f"{base}_{suffix}.png"
        plt.savefig(name, bbox_inches="tight")
        plt.close()
        out.append(name)
    return out


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 1:
        print("No filename name to read the stats from. Terminating.")
        return 1
    for name in plot_stats(argv[0]):
        print(name)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
