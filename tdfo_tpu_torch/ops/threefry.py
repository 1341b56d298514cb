"""A bitwise copy of the ``jax.random`` pieces that stochastic rounding uses:
threefry2x32 with ``PRNGKey``, ``fold_in``, ``split``, ``bits`` (uint32),
``randint`` (int32) and ``uniform`` (f32).

Port of ``jax/_src/prng.py`` (``threefry_seed``, ``_threefry2x32_lowering``,
``threefry_fold_in``, ``_threefry_split_foldlike``,
``_threefry_random_bits_partitionable``) and ``jax/_src/random.py``
(``_randint``, ``_uniform``), in the ``jax_threefry_partitionable = True`` layout that
jax 0.9 defaults to: ``split`` and ``bits`` hash the 64-bit iota of the
output shape as (hi, lo) count pairs, and ``bits`` returns ``bits1 ^
bits2``.

Stochastic-rounding parity between the port and the JAX package is
BITWISE, not statistical: the same (step, array name) gives the same key
here as there, and the same key gives the same random bits, so a bf16
write rounds to the same value in both packages (``ops/quant.py``).

A key is a pair of Python ints ``(k1, k2)``, each in ``[0, 2**32)``.  Keys
are derived on the host from the trainer's host-side step counter, so
deriving one never waits on the card.  :func:`bits` runs on the device it
is asked for, in int64 arithmetic masked to 32 bits (torch's uint32 support
is partial); every value it handles stays in ``[0, 2**32)``.
"""

from __future__ import annotations

import math

import torch

__all__ = ["Key", "PRNGKey", "fold_in", "split", "bits", "randint",
           "threefry2x32", "uniform"]

Key = tuple[int, int]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k1: int, k2: int, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the count pairs ``(x1, x2)``
    under key ``(k1, k2)``: Python ints or int64 tensors holding uint32
    values.  Returns the two output words in the same form."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & _M32
    b = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _M32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + i + 1) & _M32
    return a, b


def PRNGKey(seed: int) -> Key:  # noqa: N802 (jax's name)
    """``jax.random.PRNGKey(seed)`` for an int32 seed: ``(seed >> 32,
    seed & 0xFFFFFFFF)``, where the shift of an int32 gives 0."""
    if not -2**31 <= int(seed) < 2**31:
        raise ValueError(f"PRNGKey seed must be an int32, got {seed}")
    return (0, int(seed) & _M32)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``: the hash of the count pair
    ``(0, uint32(data))``."""
    return threefry2x32(key[0], key[1], 0, int(data) & _M32)


def _counts(n: int, device):
    c = torch.arange(n, dtype=torch.int64, device=device)
    return c >> 32, c & _M32


def split(key: Key, num: int = 2) -> list[Key]:
    """``jax.random.split(key, num)`` (partitionable): key ``i`` is the hash
    of the 64-bit count ``i``."""
    out = []
    for i in range(num):
        out.append(threefry2x32(key[0], key[1], i >> 32, i & _M32))
    return out


def bits(key: Key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` (partitionable) as an int64
    tensor of values in ``[0, 2**32)`` on ``device``: element ``n`` (row
    major) is ``bits1 ^ bits2`` of the hash of the 64-bit count ``n``."""
    shape = tuple(int(s) for s in shape)
    hi, lo = _counts(math.prod(shape), device)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return (b1 ^ b2).reshape(shape)


def randint(key: Key, shape=(), minval: int = 0, maxval: int = 2**31 - 1,
            device="cpu") -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, jnp.int32)`` for
    ``-2**31 <= minval < maxval <= 2**31 - 1``: two 32-bit draws from the
    two halves of ``split(key)``, combined modulo the span as jax combines
    them (uint32 products wrap).  Returns an int32 tensor."""
    if not -2**31 <= minval < maxval <= 2**31 - 1:
        raise ValueError(f"randint range [{minval}, {maxval}) is not an "
                         "int32 range")
    k1, k2 = split(key)
    higher, lower = bits(k1, shape, device), bits(k2, shape, device)
    span = (maxval - minval) & _M32
    multiplier = (2**16) % span
    multiplier = ((multiplier * multiplier) & _M32) % span
    offset = ((((higher % span) * multiplier) & _M32) + lower % span) & _M32
    offset = offset % span
    out = (minval + offset) & _M32
    return torch.where(out >= 2**31, out - 2**32, out).to(torch.int32)


def uniform(key: Key, shape=(), minval: float = 0.0, maxval: float = 1.0,
            device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape, jnp.float32, minval, maxval)``: the
    top 23 bits of each 32-bit draw become the mantissa of a float in
    ``[1, 2)``, minus 1, then scaled and clamped below at ``minval``, as jax
    does.  The scale-and-shift rounds once, as the fused multiply-add XLA
    compiles it into (the f32 product is exact in f64).  Returns an f32
    tensor."""
    b = bits(key, shape, device)
    fb = (b >> 9) | 0x3F800000  # below 2**31: fits an int32 as it is
    floats = fb.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=floats.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=floats.device)
    span = (hi - lo).to(torch.float64)
    out = (floats.to(torch.float64) * span + lo.to(torch.float64)).to(torch.float32)
    return torch.maximum(lo, out)
