"""Threefry-2x32 counter-based random numbers, the stream of the JAX
package's `jax.random` calls (its PRNG is threefry2x32 with the
partitionable bit layout), so GOSS draws the same uniforms in both
packages and selects the same rows.

    prng_key(s)       = [0, s]                       (jax.random.PRNGKey)
    fold_in(key, d)   = threefry2x32(key, [0, d])    (jax.random.fold_in)
    bits[i]           = x0 ^ x1 of threefry2x32(key, [i >> 32, i & M])
    uniform[i]        = f32((bits >> 9) | 0x3f800000) - 1

`threefry2x32` works on Python ints, numpy int64 / uint64 arrays and
torch int64 tensors alike: every word is a non-negative value below 2^32
held in a 64-bit integer and masked after each add and shift, so no
unsigned 32-bit dtype is needed (torch has little uint32 support).  The
keys are Python ints computed on the host; `uniform` computes on the
tensor's device, so nothing goes up but the two key words and nothing is
read back.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011; jax's
    `threefry_2x32`) of the counter words (x0, x1) under key (k0, k1).
    Each argument is a Python int or an integer array / tensor of values
    in [0, 2^32), 64 bits wide; returns the two output words alike."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def prng_key(seed: int) -> Tuple[int, int]:
    """jax.random.PRNGKey(seed) for a seed in [0, 2^32)."""
    return (int(seed) >> 32) & M32, int(seed) & M32


def fold_in(key: Tuple[int, int], data: int) -> Tuple[int, int]:
    """jax.random.fold_in(key, data)."""
    return threefry2x32(key[0], key[1], (int(data) >> 32) & M32,
                        int(data) & M32)


def _to_unit(bits):
    """The uniform in [0, 1) of 32 random bits (jax.random.uniform's
    mantissa fill): 1.0's exponent over the top 23 bits, minus 1."""
    return (bits >> 9) | 0x3F800000


def uniform(key: Tuple[int, int], n: int, device=None) -> torch.Tensor:
    """jax.random.uniform(key, (n,)) as an f32 tensor on `device`, bit for
    bit."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key[0], key[1], i >> 32, i & M32)
    return _to_unit(b0 ^ b1).to(torch.int32).view(torch.float32) - 1.0


def uniform_numpy(key: Tuple[int, int], n: int) -> np.ndarray:
    """`uniform` on the host, in numpy (the reference the card's draw is
    held to)."""
    i = np.arange(n, dtype=np.int64)
    b0, b1 = threefry2x32(key[0], key[1], i >> 32, i & M32)
    return _to_unit(b0 ^ b1).astype(np.int32).view(np.float32) \
        - np.float32(1.0)
