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

``split``, ``fold_in``, ``uniform``, ``random_bits`` and ``normal`` hand
CUDA keys to their kernels (T1 for the first two, T2, T3 and T4,
``kernels/threefry.py``: one launch a call) and CPU keys to
``split_plain``, ``fold_in_plain``, ``uniform_plain``,
``random_bits_plain`` and ``normal_plain``, the tensor versions here.
``randint``, ``permutation`` and ``choice`` are built from those, as
``jax.random`` builds them (jax 0.9).
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["PRNGKey", "split", "split_plain", "fold_in", "fold_in_plain",
           "threefry2x32",
           "random_bits", "random_bits_plain", "uniform", "uniform_plain",
           "uniform_at", "normal", "normal_plain", "randint",
           "permutation", "choice"]

MASK32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_ONE_F32_BITS = 0x3F800000
# normal: the uniform's lower end, nextafter(-1, 0) in f32, and the f32
# coefficients of chlo.erf_inv's polynomial (Giles), highest power first:
# for w = -log1p(-u * u) < 5 in w - 2.5, else in sqrt(w) - 3.
_NORMAL_LO = float(np.nextafter(np.float32(-1), np.float32(0)))
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                  -0.00367342844, 0.00573950773, -0.0076224613,
                  0.00943887047, 1.00167406, 2.83297682)
_SQRT2_F32 = float(np.float32(np.sqrt(2)))


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: ``[0, seed]``
    (negative seeds wrap to their uint32 pattern, as in JAX)."""
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} does not fit in int32")
    return torch.tensor([0, seed & MASK32], dtype=torch.int64, device=device)


def threefry2x32(k1, k2, x1, x2) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of counter words (x1, x2) under
    key words (k1, k2). All operands are broadcastable ``int64`` tensors
    with values in [0, 2^32); returns the two output words likewise, at
    the operands' broadcast shape. The rounds update two buffers in
    place: on the CPU the hash is bound by memory traffic."""
    k3 = k1 ^ k2 ^ _PARITY
    ks = (k1, k2, k3)
    x1, x2 = torch.broadcast_tensors(torch.add(x1, k1), torch.add(x2, k2))
    x1 = x1.contiguous().bitwise_and_(MASK32)
    x2 = x2.contiguous().bitwise_and_(MASK32)
    rot = torch.empty_like(x2)
    for i in range(5):
        for r in _ROT[i % 2]:
            x1.add_(x2).bitwise_and_(MASK32)
            # x2 = rotl32(x2, r) ^ x1
            torch.bitwise_left_shift(x2, r, out=rot).bitwise_and_(MASK32)
            x2.bitwise_right_shift_(32 - r).bitwise_or_(rot).bitwise_xor_(x1)
        x1.add_(ks[(i + 1) % 3]).bitwise_and_(MASK32)
        x2.add_(ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(MASK32)
    return x1, x2


def _counters(shape, device) -> tuple[torch.Tensor, torch.Tensor]:
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return idx >> 32, idx & MASK32


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (partitionable): key ``[..., 2]`` ->
    ``[..., num, 2]``. Leading key dims batch independent splits. On the
    card one T1 launch; on the CPU :func:`split_plain` (a ``meta`` key:
    an empty ``meta`` tensor of the shape, no kernel and no plain
    version; so for every draw below)."""
    from .kernels import threefry
    return threefry.split(key.contiguous(), num)


def split_plain(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """:func:`split` as int64 tensor operations (T1's plain version)."""
    hi, lo = _counters((num,), key.device)
    k1 = key[..., 0, None]
    k2 = key[..., 1, None]
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for ``0 <= data < 2^32``: in the
    partitionable mode it hashes the counter ``(0, data)`` under the key
    and keeps both words, which is ``split(key, data + 1)[data]``. On the
    card one T1 launch for that counter; on the CPU
    :func:`fold_in_plain`.

    ``data`` may be an int64 tensor ``[n]`` on the key's device (values
    taken modulo 2^32, as jax's uint32 conversion does): one key ``[2]``
    or ``n`` keys ``[n, 2]`` -> ``[n, 2]``, the ``vmap`` of ``fold_in``
    over the data (and the keys) in one T1 launch."""
    from .kernels import threefry
    if isinstance(data, torch.Tensor):
        return threefry.fold_in(key.contiguous(), data.contiguous())
    if not 0 <= data <= MASK32:
        raise ValueError(f"data {data} is not a uint32")
    return threefry.fold_in(key.contiguous(), data)


def fold_in_plain(key: torch.Tensor, data) -> torch.Tensor:
    """:func:`fold_in` as int64 tensor operations (``data`` an int, or an
    int64 tensor ``[n]`` against a key ``[2]`` or ``[n, 2]``)."""
    k1, k2 = key[..., 0], key[..., 1]
    if isinstance(data, torch.Tensor):
        d = (data & MASK32).to(key.device)
        k1, k2 = torch.broadcast_tensors(k1, k2, d)[:2]
        b1, b2 = threefry2x32(k1, k2, torch.zeros_like(d), d)
    else:
        b1, b2 = threefry2x32(k1, k2, torch.zeros_like(k1),
                              torch.full_like(k1, data))
    return torch.stack([b1, b2], dim=-1)


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


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: key ``[..., 2]`` -> f32
    ``[..., *shape]``. On the card one T4 launch; on the CPU
    :func:`normal_plain`."""
    from .kernels import threefry
    return threefry.normal(key.contiguous(), shape)


def normal_plain(key: torch.Tensor, shape) -> torch.Tensor:
    """:func:`normal` as tensor operations (T4's plain version), as jax
    0.9's ``_normal_real`` computes it: ``u = uniform(key, shape, lo, 1)``
    with ``lo = nextafter(-1, 0)`` (``max(lo, f * 2 + lo)``: the range
    ``1 - lo`` rounds to 2 in f32, so the product is exact and no FMA can
    change it), then ``chlo.erf_inv``'s f32 polynomial over ``w =
    -log1p(-u * u)``, one rounding a multiply or add, times
    ``sqrt(2)``. ``u`` never reaches -1 or 1, where erf_inv is infinite.
    The uniform is bitwise with JAX's; erf_inv is not, since XLA's
    ``log1p`` and its fused multiply-adds round otherwise than torch's
    (a few ulp, held in ``tests/test_torch_event_clock.py``)."""
    f = _bits_to_unit_float(random_bits_plain(key, shape))
    lo = torch.full_like(f, _NORMAL_LO)
    u = torch.maximum(lo, f * 2.0 + lo)
    w = -torch.log1p(u * -u)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    p = None
    for a, b in zip(_ERFINV_W_LT_5, _ERFINV_W_GE_5):
        c = torch.where(small, a, b)
        p = c if p is None else c + p * w
    return (p * u) * _SQRT2_F32


def randint(key: torch.Tensor, shape, minval, maxval) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, int32)`` as jax
    0.9's ``_randint`` computes it: key ``[..., 2]`` -> int32 ``[...,
    *shape]`` in ``[minval, maxval)``.

    ``minval`` and ``maxval`` (ints, or int tensors broadcastable to
    ``shape``) are clipped to the int32 range; ``split(key)`` gives two
    keys whose 32-bit draws are the high and low words; ``span = maxval -
    minval`` as a uint32 (1 where ``maxval <= minval``, one more where
    ``maxval`` was out of range), ``multiplier = (2^16 % span)^2 %
    span``, and the offset ``((hi % span) * multiplier + lo % span) %
    span``. The uint32 products wrap modulo 2^32, so each is masked to
    32 bits here, where the words are carried in int64; a span that
    wraps to 0 leaves ``x % 0 = x``, XLA's unsigned remainder. On the
    card one T1 and two T3 launches."""
    shape = tuple(shape)
    dev = key.device
    lo32, hi32 = -2 ** 31, 2 ** 31 - 1
    minv = torch.as_tensor(minval, dtype=torch.int64, device=dev)
    maxv = torch.as_tensor(maxval, dtype=torch.int64, device=dev)
    out_of_range = maxv > hi32
    minv = minv.clamp(lo32, hi32)
    maxv = maxv.clamp(lo32, hi32)
    k = split(key)
    higher = random_bits(k[..., 0, :], shape)
    lower = random_bits(k[..., 1, :], shape)
    span = (maxv - minv) & MASK32
    span = torch.where(maxv <= minv, torch.ones_like(span), span)
    span = torch.where(out_of_range & (maxv > minv), (span + 1) & MASK32,
                       span)

    def rem(a, b):          # XLA's unsigned remainder: a % 0 = a
        return torch.where(b == 0, a, a % torch.where(b == 0, 1, b))

    mult = rem(torch.full_like(span, 2 ** 16), span)
    mult = rem((mult * mult) & MASK32, span)
    off = ((rem(higher, span) * mult) & MASK32) + rem(lower, span)
    off = rem(off & MASK32, span)
    # minval + int32(offset), wrapping as int32 does.
    val = (minv + off + 2 ** 31) % 2 ** 32 - 2 ** 31
    return val.to(torch.int32)


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
