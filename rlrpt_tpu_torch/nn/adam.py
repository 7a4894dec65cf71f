"""Adam as ``optax.adam`` computes it, with a step that the device can
cancel.

The JAX trainers take an Adam step per minibatch and then, when the
minibatch held no live ray, select the old parameters and optimizer state,
step count included (rlrpt_tpu/deep/neural_q.py:271-281): a zero-gradient
step would still move the parameters through the decayed momentum.  Here
the selection is ``torch.where`` on a device bool, so the trainers never
wait for the host to ask whether a minibatch was empty.  (``torch.optim.
Adam`` keeps its step count and moments in a per-parameter dict and
updates them unconditionally; undoing a step would need a snapshot of all
of them and the same selects.)

The update, per parameter p with gradient g at step t = count + 1:

    mu = (1 - b1) g + b1 mu;   nu = (1 - b2) g^2 + b2 nu
    p = p - lr (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)

Parameters and state are updated in place.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class AdamState(NamedTuple):
    count: torch.Tensor   # () int32, steps taken
    mu: tuple             # first moments, one per parameter
    nu: tuple             # second moments


def adam_init(params) -> AdamState:
    params = list(params)
    dev = params[0].device
    return AdamState(count=torch.zeros((), dtype=torch.int32, device=dev),
                     mu=tuple(torch.zeros_like(p) for p in params),
                     nu=tuple(torch.zeros_like(p) for p in params))


@torch.no_grad()
def adam_update(params, grads, state: AdamState, lr: float,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                live: torch.Tensor | None = None) -> AdamState:
    """One Adam step on ``params`` (in place) from ``grads``; returns
    ``state``, also updated in place.  ``live``: a () bool tensor; where it
    is False, parameters and state keep their values bit for bit."""
    count = state.count + 1
    t = count.to(torch.float32)
    # a Python base, so nothing is copied to the device (a blocking copy
    # would synchronise the stream)
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)
    for p, g, mu, nu in zip(params, grads, state.mu, state.nu):
        mu_new = (1.0 - b1) * g + b1 * mu
        nu_new = (1.0 - b2) * (g * g) + b2 * nu
        p_new = p - lr * ((mu_new / bc1) / (torch.sqrt(nu_new / bc2) + eps))
        if live is not None:
            mu_new = torch.where(live, mu_new, mu)
            nu_new = torch.where(live, nu_new, nu)
            p_new = torch.where(live, p_new, p)
        mu.copy_(mu_new)
        nu.copy_(nu_new)
        p.copy_(p_new)
    state.count.copy_(count if live is None
                      else torch.where(live, count, state.count))
    return state
