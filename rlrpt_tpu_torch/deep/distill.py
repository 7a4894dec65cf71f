"""Offline distillation of a SARSA Q table into the DQN (counterpart of
``rlrpt_tpu/deep/distill.py``; ref: NN_Q_Value_Trainer/Source/main.cu).

Loads the dumped Q table (radiance_map_data.txt) and the scene's vertices
(vertices.txt), shuffles and splits 80/20 (:126-157), trains the
3T -> 200 -> 300 -> 200 -> S network at batch 128 with the summed squared
distance loss and Adam (:184-239, settings.cuh:4-5), and reports the test
MSE every epoch (:244-277).  The encoding is never built
(``DQNetwork.forward_relative``).
"""

from __future__ import annotations

import numpy as np
import torch

from rlrpt_tpu_torch.config import TrainerConfig
from rlrpt_tpu_torch.nn.adam import AdamState, adam_init, adam_update
from rlrpt_tpu_torch.nn.dq_network import DQNetwork
from rlrpt_tpu_torch.radiance.map_io import load_radiance_map_data
from rlrpt_tpu_torch.scene.scene import load_vertices_from_file


def load_training_data(q_table_path: str, vertices_path: str):
    """-> (verts_flat (3T,), positions (N, 3), targets (N, S)), numpy."""
    pos, q, _ = load_radiance_map_data(q_table_path)
    return load_vertices_from_file(vertices_path), pos, q


def split_train_test(perm, positions, targets, train_fraction: float = 0.8):
    """Split rows by a permutation of their indices: the first
    train_fraction of it trains (ref: main.cu:126-157)."""
    perm = np.asarray(perm)
    n_train = int(len(perm) * train_fraction)
    tr, te = perm[:n_train], perm[n_train:]
    return (positions[tr], targets[tr]), (positions[te], targets[te])


def train_epoch(net: DQNetwork, opt_state: AdamState,
                verts_flat: torch.Tensor, positions: torch.Tensor,
                targets: torch.Tensor, batch_size: int, lr: float = 0.001,
                perm: torch.Tensor | None = None) -> torch.Tensor:
    """One epoch of sequential minibatch Adam steps over the rows in the
    order ``perm`` (else torch.randperm's); the loss of a batch is its
    summed squared distance (ref: main.cu:234).  Updates ``net`` and
    ``opt_state`` in place; returns the summed loss."""
    n = positions.shape[0]
    b = min(batch_size, n)
    if perm is None:
        perm = torch.randperm(n)
    perm = perm.to(positions.device)
    params = list(net.parameters())
    loss_sum = torch.zeros((), dtype=torch.float32, device=positions.device)
    for s in range(0, n, b):
        idx = perm[s:s + b]
        pred = net.forward_relative(verts_flat, positions[idx])
        loss = torch.sum((pred - targets[idx]) ** 2)
        grads = torch.autograd.grad(loss, params)
        adam_update(params, grads, opt_state, lr)
        loss_sum = loss_sum + loss.detach()
    return loss_sum


@torch.no_grad()
def eval_mse(net: DQNetwork, verts_flat: torch.Tensor,
             positions: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean over rows of the summed squared error (ref: main.cu:244-277)."""
    pred = net.forward_relative(verts_flat, positions)
    return torch.mean(torch.sum((pred - targets) ** 2, dim=-1))


def distill(q_table_path: str, vertices_path: str,
            cfg: TrainerConfig = TrainerConfig(), seed: int = 0,
            hidden_sizes=(200, 300, 200), verbose: bool = False,
            device="cuda"):
    """The offline training run on ``device`` (the card unless the caller
    asks for the CPU); returns (net, history of (epoch, train loss, test
    MSE)).  The split, the initial weights and every epoch's order come
    from a CPU torch.Generator seeded with ``seed``."""
    verts, pos, q = load_training_data(q_table_path, vertices_path)
    gen = torch.Generator().manual_seed(int(seed))
    (tr_pos, tr_q), (te_pos, te_q) = split_train_test(
        torch.randperm(len(pos), generator=gen).numpy(), pos, q,
        cfg.train_fraction)
    net = DQNetwork(len(verts), q.shape[1], hidden_sizes,
                    generator=gen).to(device)
    opt_state = adam_init(net.parameters())
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    verts_t = t(verts)
    tr_pos, tr_q, te_pos, te_q = t(tr_pos), t(tr_q), t(te_pos), t(te_q)
    history = []
    for epoch in range(cfg.epochs):
        loss = train_epoch(net, opt_state, verts_t, tr_pos, tr_q,
                           cfg.batch_size, cfg.learning_rate,
                           perm=torch.randperm(len(tr_pos), generator=gen))
        err = eval_mse(net, verts_t, te_pos, te_q)
        history.append((epoch, float(loss), float(err)))
        if verbose:
            print(f"epoch {epoch}: train_loss={history[-1][1]:.4f} "
                  f"test_mse={history[-1][2]:.6f}")
    return net, history
