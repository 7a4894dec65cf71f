"""rlrpt_tpu_torch — the PyTorch + CUDA (Hopper) port of rlrpt_tpu.

Module paths mirror the JAX package (``rlrpt_tpu``), which stays the
reference: ``rlrpt_tpu_torch.ops.megakernel`` is the counterpart of
``rlrpt_tpu.ops.megakernel`` and so on.  This package imports torch and
numpy only.  Its hand-written CUDA kernels live in ``csrc/`` and are built
by ``rlrpt_tpu_torch._cuda`` at their first CUDA launch, never at import.
"""
