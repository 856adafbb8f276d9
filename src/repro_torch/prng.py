"""Threefry-2x32 in PyTorch, bit-compatible with ``jax.random`` in its
*partitionable* mode (the mode ``repro.core`` switches on for the whole
JAX package).

Why the port carries its own generator: stochastic rounding on the wire
draws one uniform per parameter per client per round. Drawing the SAME
bits as the JAX reference for the same key is what lets the packed wire
words be compared bitwise end to end.

Representation: a key is an ``int64`` tensor ``[..., 2]`` holding the two
uint32 words (``jax.random.PRNGKey`` raw layout). All arithmetic runs on
``int64`` tensors masked to 32 bits, so the same code runs on the CPU and
on the card (torch's uint32 op coverage is too thin to rely on).

Partitionable mode: element ``j`` of a draw of shape ``s`` hashes the
counter pair ``(j >> 32, j & 0xffffffff)`` of its row-major flat index —
bits depend on (key, index) alone. ``split(key, n)`` keeps both hash
words as the new key; ``random_bits`` XORs them.

``split``, ``uniform`` and ``random_bits`` hand CUDA keys to their
kernels (T1, T2 and T3, ``kernels/threefry.py``: one launch a call) and
CPU keys to ``split_plain``, ``uniform_plain`` and ``random_bits_plain``,
the int64 tensor versions here. ``fold_in``, ``permutation`` and
``choice`` are built from those, as ``jax.random`` builds them (jax 0.9).
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["PRNGKey", "split", "split_plain", "fold_in", "threefry2x32",
           "random_bits", "random_bits_plain", "uniform", "uniform_plain",
           "uniform_at", "permutation", "choice"]

MASK32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_ONE_F32_BITS = 0x3F800000


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: ``[0, seed]``
    (negative seeds wrap to their uint32 pattern, as in JAX)."""
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} does not fit in int32")
    return torch.tensor([0, seed & MASK32], dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & MASK32) | (x >> (32 - d))


def threefry2x32(k1, k2, x1, x2) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of counter words (x1, x2) under
    key words (k1, k2). All operands are broadcastable ``int64`` tensors
    with values in [0, 2^32); returns the two output words likewise."""
    k3 = k1 ^ k2 ^ _PARITY
    ks = (k1, k2, k3)
    x1 = (x1 + k1) & MASK32
    x2 = (x2 + k2) & MASK32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x1, x2


def _counters(shape, device) -> tuple[torch.Tensor, torch.Tensor]:
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return idx >> 32, idx & MASK32


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (partitionable): key ``[..., 2]`` ->
    ``[..., num, 2]``. Leading key dims batch independent splits. On the
    card one T1 launch; on the CPU :func:`split_plain`."""
    from .kernels import threefry
    return threefry.split(key.contiguous(), num)


def split_plain(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """:func:`split` as int64 tensor operations (T1's plain version)."""
    hi, lo = _counters((num,), key.device)
    k1 = key[..., 0, None]
    k2 = key[..., 1, None]
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for ``0 <= data < 2^32``: in the
    partitionable mode it hashes the counter ``(0, data)`` under the key
    and keeps both words, which is ``split(key, data + 1)[data]``."""
    if not 0 <= data <= MASK32:
        raise ValueError(f"data {data} is not a uint32")
    return split(key, data + 1)[..., data, :]


def _bits_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> f32 in [0, 1): the top 23 bits become the mantissa
    of a float in [1, 2), minus 1 — ``jax._src.random._uniform``."""
    fb = (bits >> 9) | _ONE_F32_BITS
    return fb.to(torch.int32).view(torch.float32) - 1.0


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32-bit ``jax.random.bits``: key ``[..., 2]`` -> ``[..., *shape]``
    int64 values in [0, 2^32). On the card one T3 launch; on the CPU
    :func:`random_bits_plain`."""
    from .kernels import threefry
    return threefry.bits(key.contiguous(), shape)


def random_bits_plain(key: torch.Tensor, shape) -> torch.Tensor:
    """:func:`random_bits` as int64 tensor operations (T3's plain
    version)."""
    shape = tuple(shape)
    hi, lo = _counters(shape, key.device)
    pad = (None,) * len(shape)
    k1 = key[(..., 0) + pad]
    k2 = key[(..., 1) + pad]
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` on [0, 1): key
    ``[..., 2]`` -> f32 ``[..., *shape]``. On the card one T2 launch; on
    the CPU :func:`uniform_plain`."""
    from .kernels import threefry
    return threefry.uniform(key.contiguous(), shape)


def uniform_plain(key: torch.Tensor, shape) -> torch.Tensor:
    """:func:`uniform` as int64 tensor operations (T2's plain version)."""
    return _bits_to_unit_float(random_bits_plain(key, shape))


def uniform_at(k1: torch.Tensor, k2: torch.Tensor,
               index: torch.Tensor) -> torch.Tensor:
    """Element ``index`` of ``uniform(key, s)`` for any shape ``s`` whose
    flat size exceeds ``index``: ``k1``/``k2``/``index`` are broadcastable
    int64 tensors. This is how a whole planar buffer's noise is drawn in
    one pass with a different key and flat index at every position."""
    b1, b2 = threefry2x32(k1, k2, index >> 32, index & MASK32)
    return _bits_to_unit_float(b1 ^ b2)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` (``_shuffle``): ``ceil(3 ln n /
    ln(2^32 - 1))`` rounds, each splitting the key and stably sorting by
    32-bit ``random_bits`` of the subkey. Returns int64 ``[n]`` on the
    key's device; one T1 and one T3 launch a round on the card."""
    x = torch.arange(n, device=key.device)
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(random_bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x


def choice(key: torch.Tensor, n: int, p: torch.Tensor) -> torch.Tensor:
    """``jax.random.choice(key, n, p=p)`` (one draw, with replacement):
    ``searchsorted(cumsum(p), cumsum(p)[-1] * (1 - uniform(key, ())))``.
    ``p`` f32 ``[n]`` on the key's device; returns a 0-dim int64 tensor
    there, with no sync."""
    if p.shape != (n,):
        raise ValueError(f"p must have shape ({n},), got {tuple(p.shape)}")
    p_cuml = torch.cumsum(p, 0)
    r = p_cuml[-1] * (1 - uniform(key, ()))
    return torch.searchsorted(p_cuml, r.reshape(1))[0]
