"""Fully-connected layer (counterpart of ``rlrpt_tpu/nn/fc_layer.py``; the
reference's DyNet FCLayer, NN_Builders/fc_layer.cu).

Affine ``x @ W.T + b`` with W stored (out, in) as DyNet and the JAX
package store it, then one of five activations.  Weights are Glorot-
uniform in +-sqrt(6 / (in + out)) and biases zero, DyNet's default
(fc_layer.cu:29-35), not ``nn.Linear``'s init.  Dropout keeps each unit
with probability 1 - p in training and scales by (1 - p) at *eval*, as
the reference does (fc_layer.cu:40-72).  The products run on cuBLAS in
float32 (TF32 off, PyTorch's default).
"""

from __future__ import annotations

import math

import torch
from torch import nn

LINEAR, RELU, SIGMOID, TANH, SOFTMAX = range(5)

_ACTIVATIONS = {
    LINEAR: lambda x: x,
    RELU: torch.relu,
    SIGMOID: torch.sigmoid,
    TANH: torch.tanh,
    SOFTMAX: lambda x: torch.softmax(x, dim=-1),
}


class FCLayer(nn.Module):
    """One layer; ``weight`` (out, in), ``bias`` (out,)."""

    def __init__(self, input_dim: int, output_dim: int,
                 activation: int = RELU, dropout: float = 0.0,
                 generator: torch.Generator | None = None):
        super().__init__()
        if activation not in _ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        self.activation = activation
        self.dropout = dropout
        self.weight = nn.Parameter(torch.empty(output_dim, input_dim))
        self.bias = nn.Parameter(torch.empty(output_dim))
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None):
        """Glorot-uniform weight, zero bias (DyNet's ParameterInitGlorot)."""
        out_dim, in_dim = self.weight.shape
        limit = math.sqrt(6.0 / (in_dim + out_dim))
        with torch.no_grad():
            self.weight.uniform_(-limit, limit, generator=generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """x (..., in) -> (..., out).  ``generator`` draws the dropout mask
        in training mode."""
        y = _ACTIVATIONS[self.activation](x @ self.weight.T + self.bias)
        if self.dropout > 0.0:
            if self.training:
                keep = torch.rand(y.shape, generator=generator,
                                  device=y.device) < 1.0 - self.dropout
                y = y * keep.to(y.dtype)
            else:
                y = y * (1.0 - self.dropout)
        return y
