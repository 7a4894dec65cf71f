"""Per-pixel error histogram (counterpart of
``rlrpt_tpu/tools/sqd_plot.py``; ref: Graphing/sqd_plot.py).

Computes the MAPE between two images and saves a log-y histogram of the
per-pixel mean-RGB absolute error, named `<prediction>_mape_<score>.png`
(ref: sqd_plot.py:31-53).  matplotlib is imported only when drawing.

    python -m rlrpt_tpu_torch.tools.sqd_plot ground_truth.png prediction.png
"""

from __future__ import annotations

import math
import sys

import numpy as np

from rlrpt_tpu_torch.utils.image import mape_score, read_image

MAX_DIFF = 255
BINS = math.floor(MAX_DIFF / 10)


def compute_sqd_image(ground_truth: str, prediction: str) -> str:
    score = mape_score(read_image(ground_truth), read_image(prediction))
    name = prediction[:-4] + "_mape_" + str(score) + ".png"

    gt = np.asarray(read_image(ground_truth), np.int64)
    p = np.asarray(read_image(prediction), np.int64)
    diff = np.abs(gt - p).sum(axis=-1) / 3.0

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    plt.figure()
    plt.hist(np.sort(diff.reshape(-1)), bins=BINS, log=True, alpha=0.5,
             histtype="bar", color="green", ec="black", rwidth=0.7)
    plt.ylabel("Frequency")
    plt.xlabel("Average RGB Pixel Error Value")
    plt.savefig(name, bbox_inches="tight")
    plt.close()
    return name


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print("Two file paths to images must be given. Terminating.")
        return 1
    print(compute_sqd_image(argv[0], argv[1]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
