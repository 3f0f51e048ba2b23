"""Threefry-2x32 random numbers in plain torch integer ops, bit for bit
those of ``jax.random`` (the reference keys its sampler with them).

Keys are pairs of uint32 words.  torch has few uint32 ops on CUDA, so a
word is held in an int64 tensor and masked with ``& 0xFFFFFFFF`` after
every add and rotate; all ops run on whichever device holds the tensors.
What is reproduced, as jax 0.9.0 computes it with
``jax_threefry_partitionable`` on (its default):

  ``prng_key(seed)``     ``jax.random.PRNGKey(seed)``: (seed >> 32, seed)
  ``fold_in(key, d)``    threefry2x32(key, (0, d))
  ``random_bits(key, n)``  counter i of a (n,) draw is the 64-bit (0, i);
                         the word is the XOR of the hash's two outputs
  ``uniform(...)``       ``bits >> 9 | 0x3F800000`` read as float32, minus
                         1, scaled to [minval, maxval) and clamped below
  ``gumbel(key, n)``     ``-log(-log(u))``, u uniform on [tiny, 1)

Everything is batched over a leading dim: a key is a (k1, k2) pair of
(B,) tensors and a draw is (B, n).  ``log`` may round differently from
XLA's by an ulp or so, so Gumbel values (not the bits) can differ from the
reference's in the last place.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

M32 = 0xFFFFFFFF
TINY = float(np.finfo(np.float32).tiny)
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = Tuple[torch.Tensor, torch.Tensor]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k1, k2, x1, x2) -> Key:
    """The Threefry-2x32 hash (20 rounds) of counters (x1, x2) under key
    (k1, k2); int64 tensors holding uint32 words, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & M32
    x2 = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x1, x2


def prng_key(seed: int, batch: int, device) -> Key:
    """``PRNGKey(seed)`` repeated over a batch of ``batch`` keys; ``seed``
    is a non-negative integer below 2**63."""
    if not 0 <= seed < 2 ** 63:
        raise ValueError(f"seed must be in [0, 2**63), got {seed}")
    hi = torch.full((batch,), (seed >> 32) & M32, dtype=torch.int64,
                    device=device)
    return hi, torch.full_like(hi, seed & M32)


def fold_in(key: Key, data: torch.Tensor) -> Key:
    """``jax.random.fold_in`` per batch row; ``data`` (B,) integers taken
    as uint32."""
    data = data.to(torch.int64) & M32
    return threefry2x32(key[0], key[1], torch.zeros_like(data), data)


def random_bits(key: Key, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` per batch row: (B, n) int64
    holding uint32 words."""
    i = torch.arange(n, dtype=torch.int64, device=key[0].device)[None, :]
    b1, b2 = threefry2x32(key[0][:, None], key[1][:, None],
                          torch.zeros_like(i), i)
    return b1 ^ b2


def uniform(key: Key, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)`` per
    batch row: (B, n) float32."""
    bits = (random_bits(key, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    # f32 bounds filled on the device (a host-made tensor would wait for it)
    lo = torch.full((), minval, dtype=torch.float32, device=floats.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=floats.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key: Key, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` (its default "low" mode)
    per batch row: (B, n) float32."""
    return -torch.log(-torch.log(uniform(key, n, minval=TINY)))


def gumbel_rows(seed: int, rids: torch.Tensor, poss: torch.Tensor,
                n: int) -> torch.Tensor:
    """The sampler's noise: row b is the Gumbel draw of key
    ``fold_in(fold_in(PRNGKey(seed), rids[b] & 0x7FFFFFFF),
    poss[b] & 0x7FFFFFFF)``.  Returns (B, n) float32."""
    key = prng_key(seed, rids.shape[0], rids.device)
    key = fold_in(key, rids.to(torch.int64) & 0x7FFFFFFF)
    key = fold_in(key, poss.to(torch.int64) & 0x7FFFFFFF)
    return gumbel(key, n)
