"""Int seeds of independent random streams.

The JAX package derives every stream from a key with
``jax.random.fold_in(key, n)``; the port's streams take int seeds (a
megakernel's seed, or the seed of a ``torch.Generator``), derived here.
"""

from __future__ import annotations

_M32 = 0xFFFFFFFF


def fold_in(seed: int, n: int) -> int:
    """The int seed of stream ``n`` of a run seeded with ``seed``: the
    port's counterpart of ``jax.random.fold_in(key, n)``.  A murmur3
    finaliser of (seed, n), in [0, 2**31 - 1)."""
    x = (seed * 0x9E3779B1 + (n + 1) * 0x85EBCA77) & _M32
    for shift, mul in ((16, 0x7FEB352D), (15, 0x846CA68B)):
        x ^= x >> shift
        x = (x * mul) & _M32
    x ^= x >> 16
    return x % (2 ** 31 - 1)
