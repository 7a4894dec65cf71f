"""Q-value probes (counterpart of ``rlrpt_tpu/deep/q_probe.py``; ref:
deep_learning/q_value_extractor.cu).

Reads probe `x y z nx ny nz` lines (to_select.txt), forwards the network
at each position, normalises each Q row by its sum (:42-48) and writes
`x y z nx ny nz q1..qS` rows as %.6g (selected_deep.txt), the thesis's
distribution plots' data.
"""

from __future__ import annotations

import numpy as np
import torch

from rlrpt_tpu_torch.nn.dq_network import DQNetwork
from rlrpt_tpu_torch.radiance.map_io import read_probe_points
from rlrpt_tpu_torch.scene.scene import Scene


@torch.no_grad()
def probe_q_values(net: DQNetwork, scene: Scene,
                   positions: np.ndarray) -> np.ndarray:
    """Normalised Q rows for probe positions (N, 3) -> (N, S); an all-zero
    row stays zero."""
    dev = next(net.parameters()).device
    q = net.forward_relative(
        scene.vertices_flat.to(dev),
        torch.as_tensor(np.asarray(positions, np.float32), device=dev))
    q = q.cpu().numpy()
    total = q.sum(axis=-1, keepdims=True)
    return q / np.where(total == 0.0, 1.0, total)


def save_selected_q_values_nn(net: DQNetwork, scene: Scene, probe_path: str,
                              out_path: str) -> None:
    """to_select.txt -> selected_deep.txt (ref: q_value_extractor.cu:
    75-123)."""
    locs, norms = read_probe_points(probe_path)
    q = probe_q_values(net, scene, locs)
    with open(out_path, "w") as f:
        for i in range(len(locs)):
            row = list(locs[i]) + list(norms[i]) + list(q[i])
            f.write(" ".join(f"{float(x):.6g}" for x in row) + "\n")
