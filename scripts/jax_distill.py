"""The JAX package's offline distillation of a Q table, on the CPU: the
reference's own figures, beside which the port's are read.

    JAX_PLATFORMS=cpu python scripts/jax_distill.py Q_TABLE VERTICES \
        [--epochs 2] [--seed 0]

Runs ``rlrpt_tpu.deep.distill.distill`` (the 3T -> 200 -> 300 -> 200 -> S
net, batch 128, Adam at 1e-3, an 80/20 split) on radiance_map_data.txt
and vertices.txt, prints each epoch's summed train loss and test MSE, and
then the share of the table's rows whose distilled Q is 0 in every sector
(the output ReLU's; q-probe writes such a row as zeros) and the rows'
mean sum of squared targets (what the test MSE of an all-zero net is).
A Q table may be gzipped.  Imports JAX; it is no part of rlrpt_tpu_torch.
"""

from __future__ import annotations

import argparse
import gzip
import shutil
import sys
import tempfile
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from rlrpt_tpu.config import TrainerConfig  # noqa: E402
from rlrpt_tpu.deep.distill import distill, load_training_data  # noqa: E402
from rlrpt_tpu.nn.dq_network import dq_apply_relative  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("q_table")
    parser.add_argument("vertices")
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        table = args.q_table
        if table.endswith(".gz"):
            table = str(Path(tmp) / "radiance_map_data.txt")
            with gzip.open(args.q_table, "rb") as src, \
                    open(table, "wb") as dst:
                shutil.copyfileobj(src, dst)
        verts, pos, q = load_training_data(table, args.vertices)
        print(f"{len(pos)} rows, {q.shape[1]} sectors, input {len(verts)} "
              f"wide; mean sum of squared targets "
              f"{float((q.astype(np.float64) ** 2).sum(-1).mean()):.6g}")
        t0 = time.perf_counter()
        params, history = distill(table, args.vertices,
                                  TrainerConfig(epochs=args.epochs),
                                  seed=args.seed, verbose=True)
    out = np.asarray(dq_apply_relative(params, jnp.asarray(verts),
                                       jnp.asarray(pos)))
    print(f"{time.perf_counter() - t0:.1f} s; rows whose distilled Q is 0 "
          f"in every sector: {float((out.sum(-1) == 0).mean()):.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
