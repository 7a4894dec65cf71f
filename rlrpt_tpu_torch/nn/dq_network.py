"""The deep-Q irradiance network (counterpart of
``rlrpt_tpu/nn/dq_network.py``; ref: NN_Builders/dq_network.cu:8-50).

An MLP input -> 200 -> 300 -> 200 -> n_actions with ReLU on every layer,
the output layer included (dq_network.cu:14-17).  The input is the 3-D
position (TRAIN_ON_POSITION) or the relative-vertex encoding of the
scene's 9T vertex floats (neural_q_pathtracer.cu:49).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from rlrpt_tpu_torch.nn.fc_layer import RELU, FCLayer


class DQNetwork(nn.Module):
    def __init__(self, input_dim: int, n_actions: int,
                 hidden_sizes: Sequence[int] = (200, 300, 200),
                 generator: torch.Generator | None = None):
        super().__init__()
        sizes = [input_dim, *hidden_sizes, n_actions]
        self.layers = nn.ModuleList(
            FCLayer(i, o, RELU, generator=generator)
            for i, o in zip(sizes[:-1], sizes[1:]))

    @classmethod
    def from_layers(cls, layers, device="cuda") -> "DQNetwork":
        """A network holding the given (w (out, in), b (out,)) arrays."""
        ws = [torch.as_tensor(w, dtype=torch.float32) for w, _ in layers]
        net = cls(ws[0].shape[1], ws[-1].shape[0],
                  [w.shape[0] for w in ws[:-1]])
        with torch.no_grad():
            for layer, w, (_, b) in zip(net.layers, ws, layers):
                if layer.weight.shape != w.shape:
                    raise ValueError(f"layer shapes do not chain: "
                                     f"{[tuple(w.shape) for w in ws]}")
                layer.weight.copy_(w)
                layer.bias.copy_(torch.as_tensor(b, dtype=torch.float32)
                                 .reshape(-1))
        return net.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (..., input_dim) -> Q-values (..., n_actions) (ref:
        dq_network.cu:36-49; dropout is 0 on every layer there)."""
        for layer in self.layers:
            x = layer(x)
        return x

    def forward_relative(self, verts_flat: torch.Tensor,
                         positions: torch.Tensor) -> torch.Tensor:
        """Q-values for the relative-vertex encoding without building it.

        The reference feeds ``verts_flat - tile(p)`` per ray (a (rays, 3T)
        buffer, nn_rendering_helpers.cu:281-298).  The first layer is
        affine in it, so W @ (verts - tile(p)) + b == (W @ verts + b) -
        W3 @ p with W3[:, k] = sum_t W[:, 3t + k]; parameters and
        gradients are those of the 3T-input layer.

        verts_flat (3T,), positions (R, 3) -> (R, n_actions).
        """
        first = self.layers[0]
        w = first.weight
        base = w @ verts_flat + first.bias
        w3 = w.reshape(w.shape[0], -1, 3).sum(dim=1)
        h = torch.relu(base[None, :] - positions @ w3.T)
        for layer in self.layers[1:]:
            h = layer(h)
        return h
