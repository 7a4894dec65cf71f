"""MAPE image metric CLI (counterpart of ``rlrpt_tpu/tools/mape.py``,
ref: Graphing/mape.py).

    python -m rlrpt_tpu_torch.tools.mape ground_truth.png prediction.png
"""

from __future__ import annotations

import sys

from rlrpt_tpu_torch.utils.image import mape_score, read_image


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print("Two file paths to images must be given. Terminating.")
        return 1
    gt, p = read_image(argv[0]), read_image(argv[1])
    if gt.shape != p.shape:
        print(f"image sizes differ: {gt.shape} vs {p.shape}. Terminating.")
        return 1
    print(mape_score(gt, p))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
