"""Threefry-2x32 (20 rounds), as ``jax.random`` defines it in its
partitionable mode: element ``j`` of a draw hashes the counter pair
``(j >> 32, j & 0xffffffff)`` under the key, ``split(key, n)`` keeps both
hash words of counters ``0 .. n-1`` as the new keys, and a uniform takes
the two words' XOR, whose top 23 bits become the mantissa of a float in
[1, 2), minus 1.

A frozen copy for the benchmark's reference, so that it draws the same
stochastic-rounding noise from the same key as the program under test
without importing it. Words are uint32 values carried in int64 tensors.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA
ONE_F32_BITS = 0x3F800000


def hash2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash of counter words (x1, x2) under key words
    (k1, k2): five groups of four rounds, a key injection after each."""
    ks = (k1, k2, k1 ^ k2 ^ PARITY)
    x1 = (x1 + k1) & MASK32
    x2 = (x2 + k2) & MASK32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = (((x2 << r) & MASK32) | (x2 >> (32 - r))) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x1, x2


def split(key: torch.Tensor, num: int) -> torch.Tensor:
    """key int64 [2] -> [num, 2]."""
    idx = torch.arange(num, dtype=torch.int64, device=key.device)
    b1, b2 = hash2x32(key[0], key[1], idx >> 32, idx & MASK32)
    return torch.stack([b1, b2], dim=-1)


def uniform(key: torch.Tensor, n: int) -> torch.Tensor:
    """f32 [n] on [0, 1): element j of ``jax.random.uniform(key, (n,))``."""
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = hash2x32(key[0], key[1], idx >> 32, idx & MASK32)
    bits = ((b1 ^ b2) >> 9) | ONE_F32_BITS
    return bits.to(torch.int32).view(torch.float32) - 1.0
