"""Gossip mixing x^{t+1}(i) = sum_l w_{i,l} z^t(l)  (paper eqs. 5 and 7) —
the single-device part of the JAX package's ``core/mixing.py``.

Client copies are stacked: every leaf of a parameter dict carries a
leading client axis of size m. Two backends:

  * ``dense`` — ``x' = W @ z`` as a tensordot over the client axis, and
    its quantized recursion; the reference, for any W.

  * the PLAN realization (``impl="ring"`` for a ring, ``"sparse"`` for
    any other bounded-degree graph) — the JAX package's sparse executor
    on a one-device client mesh, whose mesh-free spec is
    ``execute_plan_reference``. Quantized, one round is: flatten to the
    planar wire buffer, encode every client in one B1 launch, then one
    B2 launch that gathers each plan step's words and scales through the
    plan's ``src`` table (the index gather that stands in for the
    ``ppermute``) and decodes and applies them, own stream first.

Semantics, as in the JAX package:
  unquantized (Alg. 1, eq. 5):  x' = W @ z
  quantized, ``eq7``:           x' = x + W @ Q(z - x)
  quantized, ``lemma5``:        x' = W @ (x + Q(z - x))
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from .. import prng
from ..device import resolve_device
from .gossip_plan import GossipPlan
from .quantize import QuantConfig, dequantize_int, quantize_int
from .topology import MixingSpec
from .wire_layout import WireLayout

Params = dict[str, torch.Tensor]

__all__ = ["MixerConfig", "make_mixer", "make_plan_mixer", "mix_dense",
           "consensus_distance"]

_IMPLS = ("auto", "dense", "ring", "sparse")


@dataclasses.dataclass(frozen=True)
class MixerConfig:
    """Gossip mixer selection.

    impl:  "auto" | "dense" | "ring" | "sparse". "dense" is the
           tensordot reference; "ring"/"sparse" run the compiled
           GossipPlan (the plan realization); "auto" picks the plan
           realization for every static graph but a complete one, as the
           JAX package does on a one-device client mesh.
    quant: None disables Algorithm 2.
    """

    impl: str = "auto"
    quant: QuantConfig | None = None

    def __post_init__(self):
        if self.impl not in _IMPLS:
            raise ValueError(
                f"unknown mixer impl {self.impl!r}; allowed impls: "
                + " | ".join(repr(i) for i in _IMPLS))

    def resolved_impl(self, spec: MixingSpec) -> str:
        if self.impl != "auto":
            return self.impl
        if spec.kind == "ring":
            return "ring"
        if int(spec.graph.degrees().max()) < spec.m - 1:
            return "sparse"
        return "dense"


def mix_dense(W: np.ndarray, stacked: Params) -> Params:
    """Eq. 5 reference: x' = W @ z per leaf, f32 over the client axis."""
    out = {}
    for name, z in stacked.items():
        Wt = torch.as_tensor(np.asarray(W), dtype=torch.float32,
                             device=z.device)
        out[name] = torch.tensordot(Wt, z.to(torch.float32),
                                    dims=([1], [0])).to(z.dtype)
    return out


def _quant_leaf_keys(key: torch.Tensor, n_leaves: int, m: int
                     ) -> torch.Tensor:
    """How a mixing key becomes per-leaf, per-client quantizer keys —
    shared by the dense reference and the plan realization so both draw
    identical stochastic-rounding bits: [n_leaves, m, 2]."""
    return prng.split(key, n_leaves * m).reshape(n_leaves, m, 2)


def _mix_dense_quantized(W: np.ndarray, x: Params, z: Params,
                         quant: QuantConfig, key: torch.Tensor | None
                         ) -> Params:
    """Eq. 7 / Lemma 5 with dense W, quantizing per client and leaf."""
    names = sorted(x)
    m = x[names[0]].shape[0]
    dev = x[names[0]].device
    Wt = torch.as_tensor(np.asarray(W), dtype=torch.float32, device=dev)
    keys = None
    if quant.stochastic and quant.enabled:
        keys = _quant_leaf_keys(key, len(names), m).to(dev)
    out = {}
    for li, name in enumerate(names):
        xl, zl = x[name], z[name]
        delta = (zl - xl).to(torch.float32)            # [m, ...]
        if quant.enabled:
            code, s = quantize_int(delta.reshape(m, -1), quant,
                                   None if keys is None else keys[li])
            q = dequantize_int(code, s).reshape(delta.shape)
        else:
            q = delta
        if quant.delta_mode == "lemma5":
            mixed = torch.tensordot(Wt, xl.to(torch.float32) + q,
                                    dims=([1], [0]))
            out[name] = mixed.to(xl.dtype)
        else:
            mixed = torch.tensordot(Wt, q, dims=([1], [0]))
            out[name] = (xl.to(torch.float32) + mixed).to(xl.dtype)
    return out


def _weighted_replica_base(X: torch.Tensor, weights: torch.Tensor,
                           src: torch.Tensor) -> torch.Tensor:
    """The ``lemma5`` base ``sum_k w[c, k] * X[src[k, c]]`` in k order
    (own replica first): X [m, per, W], weights [m, K], src [K, m]."""
    base = weights[:, 0, None, None] * X[src[0].long()]
    for j in range(1, src.shape[0]):
        base = base + weights[:, j, None, None] * X[src[j].long()]
    return base


def make_plan_mixer(plan: GossipPlan, quant: QuantConfig | None = None,
                    device=None) -> Callable:
    """Static plan (baked weights) -> mixer(x, z, key=None, t=None) -> x'.

    The single-device realization of the JAX package's sparse executor:
    the streams a client combines are its own followed by one per live
    plan step, and every step's ``ppermute`` becomes an index gather on
    the device (inside B2 for the quantized wire).
    """
    dev = resolve_device(device)
    w_self, w_steps = plan.static_weights()
    live = [k for k in range(plan.n_steps) if plan.wire_pairs(k)]
    src = np.stack([np.arange(plan.m)] + [plan.src[k] for k in live])
    weights = np.stack([w_self] + [w_steps[k] for k in live], axis=1)
    src_t = torch.as_tensor(src.astype(np.int32), device=dev)      # [K, m]
    w_t = torch.as_tensor(weights.astype(np.float32), device=dev)  # [m, K]
    layouts: dict = {}

    def mix_fp32(z: Params) -> Params:
        out = {}
        for name, zl in z.items():
            zf = zl.to(torch.float32)
            bshape = (-1,) + (1,) * (zf.dim() - 1)
            acc = w_t[:, 0].reshape(bshape) * zf
            for j in range(1, src_t.shape[0]):
                acc = acc + w_t[:, j].reshape(bshape) * zf[src_t[j].long()]
            out[name] = acc.to(zl.dtype)
        return out

    def mixer(x: Params, z: Params, key=None, t=None) -> Params:
        del t
        if quant is None or not quant.enabled:
            return mix_fp32(z)
        sig = tuple((n, tuple(x[n].shape), x[n].dtype) for n in sorted(x))
        layout = layouts.get(sig)
        if layout is None:
            layout = layouts[sig] = WireLayout.for_tree(x, quant.bits,
                                                        stacked=True)
        X = layout.to_planar_stacked(x)                        # [m, per, W]
        # Leaf-dtype subtraction before the f32 cast, as in the reference.
        delta = layout.to_planar_stacked({n: z[n] - x[n] for n in x})
        scales = layout.leaf_scales(delta, quant)              # [m, nl]
        noise = None
        if quant.stochastic:
            keys = _quant_leaf_keys(key, layout.n_leaves, plan.m)
            noise = layout.noise_stacked(keys.to(dev))
        words = layout.encode(delta, scales, quant, noise=noise)
        if quant.delta_mode == "lemma5":
            base = _weighted_replica_base(X, w_t, src_t)
        else:
            base = X
        out = layout.decode_apply(base, words, scales, w_t, src_t, quant)
        return layout.from_planar_stacked(out)

    return mixer


def make_mixer(spec: MixingSpec, cfg: MixerConfig, device=None) -> Callable:
    """Return mixer(x_stacked, z_stacked, key=None, t=None) -> x_next for
    a static spec. The one device is a one-shard client mesh: ``"auto"``
    on a ring resolves to ``"ring"``, the plan realization; ``"dense"``
    stays available as the second oracle."""
    if not isinstance(spec, MixingSpec):
        raise NotImplementedError(
            "time-varying schedules are not ported yet (ROADMAP A12)")
    impl = cfg.resolved_impl(spec)
    quant = cfg.quant
    if impl in ("ring", "sparse"):
        if impl == "ring" and spec.kind != "ring":
            raise ValueError(f"ring mixer needs a ring MixingSpec, got "
                             f"kind={spec.kind!r}")
        return make_plan_mixer(spec.gossip_plan(), quant, device=device)
    resolve_device(device)
    if quant is None or not quant.enabled:
        def mixer(x, z, key=None, t=None):
            del x, key, t
            return mix_dense(spec.W, z)
        return mixer

    def mixer(x, z, key=None, t=None):
        del t
        return _mix_dense_quantized(spec.W, x, z, quant, key)
    return mixer


def consensus_distance(stacked: Params) -> torch.Tensor:
    """(1/m) sum_i ||x(i) - xbar||^2 — Lemma 4's left-hand side, summed
    over leaves in sorted-key order."""
    total = None
    for name in sorted(stacked):
        z = stacked[name]
        zb = z.mean(dim=0, keepdim=True)
        d = ((z.to(torch.float32) - zb) ** 2).sum() / z.shape[0]
        total = d if total is None else total + d
    return total
