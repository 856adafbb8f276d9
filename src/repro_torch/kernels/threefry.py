"""T1, T2, T3 and T4: the key chain's threefry draws as one launch each.

``split`` is ``jax.random.split``, ``uniform`` is ``jax.random.uniform``
(float32), ``bits`` is ``jax.random.bits`` (32-bit) and ``normal`` is
``jax.random.normal`` (float32), all in the partitionable mode. The JAX
package leaves them to XLA (no Pallas kernel); their plain versions are
``prng.split_plain``, ``prng.uniform_plain``, ``prng.random_bits_plain``
and ``prng.normal_plain``, threefry written as int64 tensor operations,
~180 a draw, which on the card made ~700 tiny kernels a round. On CUDA
tensors they run ``csrc/threefry.cu``: T1 (``threefry_split``, and
``fold_in`` for one counter or a counter a row) one thread an output
key, T2
(``threefry_uniform``), T3 (``threefry_bits``, T2's body without the
float) and T4 (``threefry_normal``, T2's body, then erf_inv's
polynomial) one thread a draw, each bitwise with its plain version on
the card. ``prng.split``, ``prng.uniform``,
``prng.random_bits`` and ``prng.normal`` call these wrappers, so every
caller of the key chain takes the kernels on the card. A ``meta`` key
draws empty ``meta`` tensors of the outputs' shapes (how
``sharding.shapes_and_axes`` evaluates an init). Every call that makes
an output reports its byte record (``native.report``: the key, a data
tensor, the output) on the card, on the CPU and on ``meta``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import prng
from . import native

_ARGS = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
               ctypes.c_void_p, ctypes.c_void_p]


def _host(kernel: str, key: torch.Tensor, out_shape, dtype, plain,
          *operands) -> torch.Tensor:
    """A CPU or meta key's call: ``plain()`` (an empty ``meta`` tensor of
    ``out_shape`` on meta), reported as one launch of ``kernel`` when it
    has an output, as the card's call is."""
    out = (torch.empty(tuple(out_shape), dtype=dtype, device=key.device)
           if key.device.type == "meta" else plain())
    if out.numel():
        native.report(kernel, (key, *operands), (out,))
    return out


def _rows(key: torch.Tensor) -> torch.Tensor:
    """A CUDA key ``[..., 2]`` checked and viewed as ``[R, 2]``."""
    native.require(key, "key", torch.int64)
    if key.dim() == 0 or key.shape[-1] != 2:
        raise ValueError(f"key must be [..., 2], got {tuple(key.shape)}")
    return key.reshape(-1, 2)


@native.kernel_entry
def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (partitionable): int64 key ``[..., 2]`` ->
    ``[..., num, 2]``. CPU keys take ``prng.split_plain``; a CUDA key
    (contiguous) launches T1 once."""
    if key.device.type in ("cpu", "meta"):
        return _host("threefry_split", key, (*key.shape[:-1], num, 2),
                     torch.int64, lambda: prng.split_plain(key, num))
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
    native.report("threefry_split", (key,), (out,))
    return out


@native.kernel_entry
def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a uint32 ``data``: int64 key
    ``[..., 2]`` -> ``[..., 2]``. CPU keys take ``prng.fold_in_plain``; a
    CUDA key (contiguous) launches T1 once, for that one counter. A
    ``data`` tensor (int64 ``[n]`` on the key's device) folds a counter a
    row into one key ``[2]`` or into ``n`` keys ``[n, 2]``: one launch of
    T1's ``threefry_fold_in_each``, out ``[n, 2]``."""
    if key.device.type in ("cpu", "meta"):
        each = isinstance(data, torch.Tensor)
        lead = data.shape if each and key.dim() == 1 else key.shape[:-1]
        return _host("threefry_split", key, (*lead, 2), torch.int64,
                     lambda: prng.fold_in_plain(key, data),
                     *((data,) if each else ()))
    if isinstance(data, torch.Tensor):
        return _fold_in_each(key, data)
    rows = _rows(key)
    out = torch.empty(key.shape, dtype=torch.int64, device=key.device)
    fn = native.function("threefry", "threefry_fold_in", _ARGS)
    with torch.cuda.device(key.device):
        rc = fn(rows.data_ptr(), rows.shape[0], data, out.data_ptr(),
                native.stream_of(key))
    native.check_launch(rc, "threefry_split")
    native.report("threefry_split", (key,), (out,))
    return out


def _fold_in_each(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    rows = _rows(key)
    native.require(data, "data", torch.int64, device=key.device)
    if data.dim() != 1 or rows.shape[0] not in (1, data.shape[0]) or (
            key.dim() != 1 and key.dim() != 2):
        raise ValueError(f"fold_in over data [n] needs a key [2] or [n, 2], "
                         f"got key {tuple(key.shape)}, data "
                         f"{tuple(data.shape)}")
    n = data.shape[0]
    out = torch.empty((n, 2), dtype=torch.int64, device=key.device)
    if n == 0:
        return out
    fn = native.function("threefry", "threefry_fold_in_each",
                         [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                          ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p])
    with torch.cuda.device(key.device):
        rc = fn(rows.data_ptr(), rows.shape[0], data.data_ptr(), n,
                out.data_ptr(), native.stream_of(key))
    native.check_launch(rc, "threefry_split")
    native.report("threefry_split", (key, data), (out,))
    return out


def _draw(key: torch.Tensor, shape, dtype: torch.dtype, symbol: str
          ) -> torch.Tensor:
    """One T2, T3 or T4 launch: ``[..., *shape]`` draws of ``dtype`` for a
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
    native.report(symbol, (key,), (out,))
    return out


def _draw_host(symbol: str, key: torch.Tensor, shape, dtype, plain
               ) -> torch.Tensor:
    return _host(symbol, key, (*key.shape[:-1], *shape), dtype,
                 lambda: plain(key, shape))


@native.kernel_entry
def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` on [0, 1): int64 key
    ``[..., 2]`` -> f32 ``[..., *shape]``. CPU keys take
    ``prng.uniform_plain``; a CUDA key (contiguous, at most 65 535 keys)
    launches T2 once."""
    if key.device.type in ("cpu", "meta"):
        return _draw_host("threefry_uniform", key, shape, torch.float32,
                          prng.uniform_plain)
    return _draw(key, shape, torch.float32, "threefry_uniform")


@native.kernel_entry
def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: int64 key ``[..., 2]``
    -> f32 ``[..., *shape]``. CPU keys take ``prng.normal_plain``; a CUDA
    key (contiguous, at most 65 535 keys) launches T4 once."""
    if key.device.type in ("cpu", "meta"):
        return _draw_host("threefry_normal", key, shape, torch.float32,
                          prng.normal_plain)
    return _draw(key, shape, torch.float32, "threefry_normal")


@native.kernel_entry
def bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32-bit ``jax.random.bits(key, shape)``: int64 key ``[..., 2]`` ->
    int64 ``[..., *shape]`` with values in [0, 2^32), the layout of
    ``prng.random_bits_plain``, which CPU keys take; a CUDA key
    (contiguous, at most 65 535 keys) launches T3 once."""
    if key.device.type in ("cpu", "meta"):
        return _draw_host("threefry_bits", key, shape, torch.int64,
                          prng.random_bits_plain)
    return _draw(key, shape, torch.int64, "threefry_bits")
