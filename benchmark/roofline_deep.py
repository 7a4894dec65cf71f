"""The yardstick of the deep-Q path: the MLP's floating-point operations
and kernel B4a's bytes, counted from the program's row and ray counters
at the configuration's published widths.

* The network 342 -> 200 -> 300 -> 200 -> 144 (dq_network.cu:14-17): a
  forwarded row is 2 x (sum of in x out) = 434,400 operations, its first
  layer counted as published, 342 wide, whatever the program computes (it
  folds the encoding into a 3-wide product); a trained row is 3x that
  (the forward, and the backward's two products a layer).  Biases and
  activations are left out.
* B4a's closest hit: each live ray reads its origin and direction (24
  bytes) and writes its distance, triangle and 16-float material row (72
  bytes), 96 bytes a ray (PERF.md section 6 counts B4a so), and every
  launch reads the scene's triangle and material rows once (48 + 64
  bytes a triangle).

A share of the peak is the operations over the f32 peak (67 TFLOP/s,
benchmark/roofline.py) in the seconds given.
"""

from __future__ import annotations

from benchmark.roofline import PEAK_BYTES, PEAK_F32, TRI_BYTES

WIDTHS = (342, 200, 300, 200, 144)
RAY_BYTES = 12 + 12 + 4 + 4 + 64


def forward_flops(widths=WIDTHS) -> int:
    """Operations of one row's forward pass (a multiply and an add per
    weight)."""
    return 2 * sum(a * b for a, b in zip(widths[:-1], widths[1:]))


def mlp_flops(forwarded: int, trained: int, widths=WIDTHS) -> int:
    """The MLP's operations for ``forwarded`` rows and ``trained`` rows."""
    return forward_flops(widths) * (forwarded + 3 * trained)


def mfu_pct(forwarded: int, trained: int, seconds: float,
            widths=WIDTHS) -> float:
    return 100.0 * mlp_flops(forwarded, trained, widths) / (
        seconds * PEAK_F32)


def b4a_bound_s(rays: int, launches: int, n_tris: int) -> float:
    """Least seconds for ``launches`` B4a calls tracing ``rays`` live
    rays over ``n_tris`` triangles: bytes over the memory bandwidth."""
    return (rays * RAY_BYTES + launches * n_tris * TRI_BYTES) / PEAK_BYTES
