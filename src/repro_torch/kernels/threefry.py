"""T1, T2 and T3: the key chain's threefry draws as one launch each.

``split`` is ``jax.random.split``, ``uniform`` is ``jax.random.uniform``
(float32) and ``bits`` is ``jax.random.bits`` (32-bit), all in the
partitionable mode, bitwise. The JAX package leaves them to XLA (no
Pallas kernel); their plain versions are ``prng.split_plain``,
``prng.uniform_plain`` and ``prng.random_bits_plain``, threefry written as
int64 tensor operations, ~180 a draw, which on the card made ~700 tiny
kernels a round. On CUDA tensors they run ``csrc/threefry.cu``: T1
(``threefry_split``) one thread an output key, T2 (``threefry_uniform``)
and T3 (``threefry_bits``, T2's body without the float) one thread a
draw. ``prng.split``, ``prng.uniform`` and ``prng.random_bits`` call these
wrappers, so every caller of the key chain takes the kernels on the card.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import prng
from . import native

_ARGS = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
               ctypes.c_void_p, ctypes.c_void_p]


def _rows(key: torch.Tensor) -> torch.Tensor:
    """A CUDA key ``[..., 2]`` checked and viewed as ``[R, 2]``."""
    native.require(key, "key", torch.int64)
    if key.dim() == 0 or key.shape[-1] != 2:
        raise ValueError(f"key must be [..., 2], got {tuple(key.shape)}")
    return key.reshape(-1, 2)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (partitionable): int64 key ``[..., 2]`` ->
    ``[..., num, 2]``. CPU keys take ``prng.split_plain``; a CUDA key
    (contiguous) launches T1 once."""
    if key.device.type == "cpu":
        return prng.split_plain(key, num)
    if num < 0:
        raise ValueError(f"num must be >= 0, got {num}")
    rows = _rows(key)
    out = torch.empty(tuple(key.shape[:-1]) + (num, 2), dtype=torch.int64,
                      device=key.device)
    if out.numel() == 0:
        return out
    fn = native.function("threefry", "threefry_split", _ARGS)
    with torch.cuda.device(key.device):
        rc = fn(rows.data_ptr(), rows.shape[0], num, out.data_ptr(),
                native.stream_of(key))
    native.check_launch(rc, "threefry_split")
    return out


def _draw(key: torch.Tensor, shape, dtype: torch.dtype, symbol: str
          ) -> torch.Tensor:
    """One T2 or T3 launch: ``[..., *shape]`` draws of ``dtype`` for a
    CUDA key (contiguous, at most 65 535 keys)."""
    shape = tuple(shape)
    rows = _rows(key)
    n = math.prod(shape)
    out = torch.empty(tuple(key.shape[:-1]) + shape, dtype=dtype,
                      device=key.device)
    if out.numel() == 0:
        return out
    fn = native.function("threefry", symbol, _ARGS)
    with torch.cuda.device(key.device):
        rc = fn(rows.data_ptr(), rows.shape[0], n, out.data_ptr(),
                native.stream_of(key))
    native.check_launch(rc, symbol)
    return out


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` on [0, 1): int64 key
    ``[..., 2]`` -> f32 ``[..., *shape]``. CPU keys take
    ``prng.uniform_plain``; a CUDA key (contiguous, at most 65 535 keys)
    launches T2 once."""
    if key.device.type == "cpu":
        return prng.uniform_plain(key, shape)
    return _draw(key, shape, torch.float32, "threefry_uniform")


def bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32-bit ``jax.random.bits(key, shape)``: int64 key ``[..., 2]`` ->
    int64 ``[..., *shape]`` with values in [0, 2^32), the layout of
    ``prng.random_bits_plain``, which CPU keys take; a CUDA key
    (contiguous, at most 65 535 keys) launches T3 once."""
    if key.device.type == "cpu":
        return prng.random_bits_plain(key, shape)
    return _draw(key, shape, torch.int64, "threefry_bits")
