"""Counter-based threefry2x32 draws, bit for bit those of ``jax.random``.

The JAX package draws sampled tokens with ``jax.random.PRNGKey(seed)``,
``fold_in(key, data)`` and ``gumbel(key, shape, float32)`` on the
threefry2x32 generator with ``jax_threefry_partitionable`` on (JAX's
default), so a token is a pure function of (seed, sequence, position).
This module computes the same functions on torch tensors, on the
tensors' device:

* a key is an int64 tensor ``[..., 2]`` holding two 32-bit words; a
  batch of keys (one a row) folds and draws in one call;
* ``fold_in(key, d)`` hashes the count pair ``(0, d)`` under ``key``
  (``_threefry_fold_in`` / ``threefry_seed`` of JAX's ``prng.py``);
* ``random_bits(key, shape)`` hashes the flat index of every element,
  split into a high and a low word, and returns ``bits1 ^ bits2``
  (``_threefry_random_bits_partitionable``);
* ``uniform`` keeps 23 of those bits as the mantissa of a float in
  [1, 2) and subtracts 1 (``_uniform``); ``gumbel`` is
  ``-log(-log(uniform(tiny, 1)))`` (``_gumbel``, mode "low").

The words are held in int64 and masked to 32 bits after every add and
shift: torch's ``uint32`` lacks shifts on some backends.  Bits, keys and
uniforms equal JAX's exactly; the two logs of ``gumbel`` may differ from
XLA's by an ulp.  Constants are made on the device by fills, never
copied from the host, so a draw does not wait for the stream.
"""
from __future__ import annotations

from typing import Sequence

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
F32_TINY = torch.finfo(torch.float32).tiny


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The threefry 2x32 hash (20 rounds) of the count pairs ``(x1, x2)``
    under the key ``(k1, k2)``; all int64 tensors (or ints) holding
    32-bit words, broadcast together.  Returns the pair of output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK
    return x1, x2


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as JAX computes it by default (64-bit
    types off): the seed becomes a 32-bit integer first, so the key is
    (0, seed mod 2^32); an int64 tensor [2]."""
    s = int(seed)
    if not -2**63 <= s < 2**63:
        raise OverflowError(f"seed {seed} does not fit in 64 bits")
    key = torch.zeros(2, dtype=torch.int64, device=device)
    key[1] = s & MASK
    return key


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: key [..., 2] and data (an int or an integer
    tensor, its values below 2^32) broadcast together; returns keys
    [..., 2] of the broadcast shape."""
    if isinstance(data, int):
        data = torch.full((), data, dtype=torch.int64, device=key.device)
    data = data.to(torch.int64) & MASK
    y1, y2 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits an element: int64 [*key batch, *shape] in
    [0, 2^32).  Element i of the flattened shape hashes the count pair
    (i >> 32, i & 0xFFFFFFFF)."""
    shape = tuple(int(n) for n in shape)
    n = 1
    for d in shape:
        n *= d
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    batch = key.shape[:-1]
    k1 = key[..., 0].reshape(*batch, *([1] * len(shape)))
    k2 = key[..., 1].reshape(*batch, *([1] * len(shape)))
    y1, y2 = threefry2x32(k1, k2, (idx >> 32).reshape(shape),
                          (idx & MASK).reshape(shape))
    return y1 ^ y2


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the
    top 23 bits as a mantissa in [1, 2), minus 1, scaled, and held at
    ``minval`` or above.  f32 [*key batch, *shape]."""
    bits = random_bits(key, shape)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(
        torch.float32) - 1.0
    lo = torch.full((), minval, dtype=torch.float32, device=key.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` (mode "low"):
    ``-log(-log(u))``, u uniform on [tiny, 1).  f32 [*key batch, *shape]."""
    return -torch.log(-torch.log(uniform(key, shape, F32_TINY, 1.0)))
