"""Checkpoint and resume of the whole training state (counterpart of
``rlrpt_tpu/utils/checkpoint.py``).

The reference saves the DQN per frame as DyNet text and the Q table as
text (``nn/dynet_io.py``, ``radiance/map_io.py``), and loses Adam's
moments and epsilon.  This is one compressed ``.npz`` of the network,
its Adam state, epsilon, the frame counter and, optionally, the radiance
volumes, so a run resumes exactly.

The file's keys and leaf order are the JAX package's: ``epsilon`` (f32),
``frame`` (i64), ``params/<i>`` for w0, b0, w1, b1, ... (w as (out, in)),
``opt/<i>`` for optax's Adam state (count, then the first moments, then
the second, each in the parameters' order) and ``vols/*``.  The JAX
writer also stores each tree's structure as ``<prefix>/treedef``, which
its loader never reads (it takes the structure from its example), so a
checkpoint written by either package loads in the other.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from rlrpt_tpu_torch.nn.adam import AdamState
from rlrpt_tpu_torch.nn.dq_network import DQNetwork
from rlrpt_tpu_torch.radiance.volumes import RadianceVolumes

_VOL_FIELDS = ("position", "normal", "frame", "surface_lum", "q", "visits",
               "cdf")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_training_state(path: str, net: DQNetwork, opt_state: AdamState,
                        epsilon: float, frame: int,
                        vols: RadianceVolumes | None = None) -> None:
    """Write a single-file ``.npz`` checkpoint (atomically: a temporary
    file, then a rename)."""
    out: dict = {"epsilon": np.float32(epsilon), "frame": np.int64(frame)}
    for i, p in enumerate(net.parameters()):
        out[f"params/{i}"] = _np(p)
    leaves = [opt_state.count.to(torch.int32), *opt_state.mu, *opt_state.nu]
    for i, leaf in enumerate(leaves):
        out[f"opt/{i}"] = _np(leaf)
    if vols is not None:
        for name in _VOL_FIELDS:
            out[f"vols/{name}"] = _np(getattr(vols, name))
        out["vols/grid_resolution"] = np.int64(vols.grid_resolution)
    tmp = f"{path}.tmp.npz"
    np.savez_compressed(tmp, **out)
    os.replace(tmp, path)


def load_training_state(path: str, device="cuda"):
    """Read a checkpoint; returns (net, opt_state, epsilon, frame, vols)
    on ``device``.  The network's shapes come from the file; ``vols`` is
    None when the checkpoint holds no tabular state."""
    with np.load(path) as z:
        def leaves(prefix: str) -> list:
            out, i = [], 0
            while f"{prefix}/{i}" in z:
                out.append(z[f"{prefix}/{i}"])
                i += 1
            return out

        params, opt = leaves("params"), leaves("opt")
        n = len(params)
        if n % 2 or len(opt) != 2 * n + 1:
            raise ValueError(f"{path}: {n} parameter and {len(opt)} optimizer "
                             "leaves do not describe a DQNetwork and its Adam "
                             "state")
        net = DQNetwork.from_layers(list(zip(params[0::2], params[1::2])),
                                    device=device)
        f32 = lambda a: torch.as_tensor(  # noqa: E731
            np.asarray(a, np.float32), device=device)
        opt_state = AdamState(
            count=torch.as_tensor(np.asarray(opt[0], np.int32),
                                  device=device),
            mu=tuple(f32(a) for a in opt[1:n + 1]),
            nu=tuple(f32(a) for a in opt[n + 1:]))
        vols = None
        if "vols/q" in z:
            fields = {name: torch.as_tensor(z[f"vols/{name}"], device=device)
                      for name in _VOL_FIELDS}
            vols = RadianceVolumes(
                **fields, grid_resolution=int(z["vols/grid_resolution"]))
        return net, opt_state, float(z["epsilon"]), int(z["frame"]), vols
