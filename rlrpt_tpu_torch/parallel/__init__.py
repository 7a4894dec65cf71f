"""Scale-out over processes: ``torch.distributed`` groups and the
data-parallel sharded renderers (counterpart of ``rlrpt_tpu/parallel``).

Rays shard over the ranks of a group, the scene, the net and the Q tables
replicate, and the cross-rank reductions (Q-table contributions, DQN
gradients, early-exit flags) are all-reduces: NCCL on the card, gloo on
the CPU.  One process per rank, where the JAX package runs one program
over a device mesh.
"""

# Lazy exports (PEP 562): the integrators import parallel.mesh, and dp
# imports the integrators, so importing dp here would make a cycle.
_EXPORTS = {
    "make_mesh": "rlrpt_tpu_torch.parallel.mesh",
    "ray_specs": "rlrpt_tpu_torch.parallel.mesh",
    "render_default_dp": "rlrpt_tpu_torch.parallel.dp",
    "render_frame_sarsa_dp": "rlrpt_tpu_torch.parallel.dp",
    "render_frame_sarsa_wavefront_dp": "rlrpt_tpu_torch.parallel.dp",
    "neural_q_train_step_dp": "rlrpt_tpu_torch.parallel.dp",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
