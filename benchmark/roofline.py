"""The yardstick of the kernels' rooflines: the card's peaks and the work
of a frame counted from its inputs and outputs alone.

The operation counts are those of the engine's step (a frozen copy of the
counts in rlrpt_tpu_torch/tools/mega_sweep.py): exact f32 Moller-Trumbore
is 50 operations a ray-triangle test (46 adds and multiplies, 4 compares),
and a segment's own step besides the test 75 operations with the uniform
bounce (B1), 125 with the guided one (B3) and 131 with the TD target
(B2).  A frame's segments are the sum of the path lengths it returns.

* A sweep (Cornell, one 256-triangle chunk) tests every triangle on every
  segment: segments x (50 n_tris + step).  B2's apply of Q, whose count
  depends on the schedule, is left out.
* Bytes: the scene's triangle and material rows read once (48 + 64 bytes a
  triangle), the tables read (and Q and visits written), and the frame's
  outputs written once (rad 12 bytes, path_sum and iters 4 each a slot).

A share is the bound (the larger of operations over the f32 peak and bytes
over the memory bandwidth) over the measured device time.
"""

from __future__ import annotations

PEAK_F32 = 67e12        # NVIDIA H100 SXM, f32 outside the tensor cores
PEAK_BYTES = 3.35e12    # HBM3
MT_OPS = 50
SEGMENT_OPS = {"B1": 75, "B3": 125, "B2": 131}
TRI_BYTES = 48 + 64
SLOT_BYTES = 12 + 4 + 4


def bound_s(ops: float, nbytes: float) -> float:
    """Least seconds for ``ops`` f32 operations and ``nbytes`` of traffic."""
    return max(ops / PEAK_F32, nbytes / PEAK_BYTES)


def sweep_bound_s(kernel: str, segments: float, n_tris: int, n_slots: int,
                  table_bytes: int = 0) -> float:
    """A frame of a sweep kernel (B1, B2, B3) over ``n_tris`` triangles."""
    ops = segments * (MT_OPS * n_tris + SEGMENT_OPS[kernel])
    nbytes = n_tris * TRI_BYTES + table_bytes + n_slots * SLOT_BYTES
    return bound_s(ops, nbytes)


def binned_table_bytes(n_sectors_pad: int, n_cols: int,
                       learns: bool) -> int:
    """Bytes of the binned tables a guided frame reads: the bf16 CDF, and
    for a learning frame Q and visits (f32) read and written."""
    return n_sectors_pad * n_cols * (2 + (16 if learns else 0))
