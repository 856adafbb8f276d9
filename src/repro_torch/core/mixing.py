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
    planar wire buffer, encode every client in one B1 launch (which draws
    the stochastic-rounding noise itself from the per-leaf keys), then one
    B2 launch that gathers each plan step's words and scales through the
    plan's ``src`` table (the index gather that stands in for the
    ``ppermute``) and decodes and applies them, own stream first.

``make_fused_tail`` is the fused round's tail over the same two backends
(B4 encodes, drawing its noise from the keys as B1 does; B5 decodes and
applies the deferred last step).

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
from .local_sgd import loss_and_grad
from .quantize import QuantConfig, dequantize_int, quantize_int
from .topology import MixingSpec
from .wire_layout import WireLayout

Params = dict[str, torch.Tensor]

__all__ = ["MixerConfig", "make_mixer", "make_plan_mixer", "make_fused_tail",
           "mix_dense", "consensus_distance"]

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


def mix_dense(W, stacked: Params) -> Params:
    """Eq. 5 reference: x' = W @ z per leaf, f32 over the client axis.

    ``W`` is numpy, as in the JAX package, or an f32 tensor already on
    the leaves' device (what the mixers and DSGD pass: built once, so a
    round copies nothing from the host)."""
    out = {}
    for name, z in stacked.items():
        Wt = _device_w(W, z.device)
        out[name] = torch.tensordot(Wt, z.to(torch.float32),
                                    dims=([1], [0])).to(z.dtype)
    return out


def _device_w(W, dev: torch.device) -> torch.Tensor:
    """``W`` as an f32 tensor on ``dev``: converted from numpy, or a
    tensor already there (no copy)."""
    if isinstance(W, torch.Tensor):
        if W.dtype != torch.float32 or W.device != dev:
            raise ValueError(f"W must be f32 on {dev}, got {W.dtype} on "
                             f"{W.device}")
        return W
    return torch.as_tensor(np.asarray(W), dtype=torch.float32, device=dev)


def _key_on(key: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """The mixing key, which must already lie on the parameters' device:
    a host key would cost a pageable copy every round and cannot be
    captured in a CUDA graph."""
    if key is None or key.device != dev:
        raise ValueError(f"the quantizer key must be on {dev}, got "
                         f"{None if key is None else key.device}")
    return key


def _quant_leaf_keys(key: torch.Tensor, n_leaves: int, m: int
                     ) -> torch.Tensor:
    """How a mixing key becomes per-leaf, per-client quantizer keys —
    shared by the dense reference and the plan realization so both draw
    identical stochastic-rounding bits: [n_leaves, m, 2]."""
    return prng.split(key, n_leaves * m).reshape(n_leaves, m, 2)


def _mix_dense_quantized(W, x: Params, z: Params, quant: QuantConfig,
                         key: torch.Tensor | None) -> Params:
    """Eq. 7 / Lemma 5 with dense W (numpy, or f32 on the leaves'
    device), quantizing per client and leaf."""
    names = sorted(x)
    m = x[names[0]].shape[0]
    dev = x[names[0]].device
    Wt = _device_w(W, dev)
    keys = None
    if quant.stochastic and quant.enabled:
        keys = _quant_leaf_keys(_key_on(key, dev), len(names), m)
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


def _plan_tables(plan: GossipPlan, dev: torch.device
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The streams a client combines — its own, then one per live plan
    step — as ``src`` int32 [K, m] (row 0 the identity) and the static
    weights f32 [m, K]."""
    w_self, w_steps = plan.static_weights()
    live = [k for k in range(plan.n_steps) if plan.wire_pairs(k)]
    src = np.stack([np.arange(plan.m)] + [plan.src[k] for k in live])
    weights = np.stack([w_self] + [w_steps[k] for k in live], axis=1)
    return (torch.as_tensor(src.astype(np.int32), device=dev),
            torch.as_tensor(weights.astype(np.float32), device=dev))


def make_plan_mixer(plan: GossipPlan, quant: QuantConfig | None = None,
                    device=None) -> Callable:
    """Static plan (baked weights) -> mixer(x, z, key=None, t=None) -> x'.

    The single-device realization of the JAX package's sparse executor:
    the streams a client combines are its own followed by one per live
    plan step, and every step's ``ppermute`` becomes an index gather on
    the device (inside B2 for the quantized wire).
    """
    dev = resolve_device(device)
    src_t, w_t = _plan_tables(plan, dev)
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
        keys = None
        if quant.stochastic:     # B1 draws the noise from the keys
            keys = _quant_leaf_keys(_key_on(key, X.device),
                                    layout.n_leaves, plan.m)
        words = layout.encode(delta, scales, quant, keys=keys)
        if quant.delta_mode == "lemma5":
            base = _weighted_replica_base(X, w_t, src_t)
        else:
            base = X
        out = layout.decode_apply(base, words, scales, w_t, src_t, quant)
        return layout.from_planar_stacked(out)

    return mixer


def make_fused_tail(loss_fn: Callable, m: int, *, eta: float, theta: float,
                    quant: QuantConfig | None = None,
                    plan: GossipPlan | None = None,
                    W=None, device=None) -> Callable:
    """Fused-round tail for a static spec on one device: the round's last
    two local steps, the wire encode and the combined decode-apply — the
    single-device counterpart of the JAX package's ``make_fused_tail``.

    The returned ``tail(x, y, v, g, batch_last, keys_last, key_q)``
    consumes :func:`~repro_torch.core.local_sgd.local_train_deferred`'s
    output (``y``/``v``/``g`` the un-applied penultimate step, stacked
    over clients) and returns ``(x_next, y_pub, loss_last)``:

      1. SEND — ``v' = theta*v - eta*g; y' = y + v'`` and ``pack(Q(y' -
         x))`` in one pass (B4); the published z is ``y'``.
      2. The round's LAST gradient ``g_K = grad(y')``.
      3. RECEIVE — ``x' = [base + sum_k w_k*deq(stream_k)] + (theta*v' -
         eta*g_K)`` in one pass (B5), each plan step's stream gathered
         through ``src``.

    An algorithm variant: neighbours see y_{K-1}, not y_K; at ``eta ==
    0`` it equals the unfused round bitwise. ``plan=None`` is the dense
    reference (tree-level, any ``W``); a static :class:`GossipPlan` runs
    the plan body (plain torch on the fp32 wire, B4 and B5 on the
    quantized wire). ``loss_last`` [m] holds the last step's losses.
    """
    dev = resolve_device(device)
    eta_f, theta_f = float(np.float32(eta)), float(np.float32(theta))
    quant_on = quant is not None and quant.enabled

    def penultimate(y: Params, v: Params, g: Params):
        v1 = {n: theta_f * v[n].to(torch.float32)
              - eta_f * g[n].to(torch.float32) for n in y}
        y1 = {n: (y[n].to(torch.float32) + v1[n]).to(y[n].dtype) for n in y}
        return y1, v1

    def deferred(mixed: Params, v1: Params, gK: Params) -> Params:
        return {n: (mixed[n].to(torch.float32) + theta_f * v1[n]
                    - eta_f * gK[n].to(torch.float32)).to(mixed[n].dtype)
                for n in mixed}

    if plan is None:
        if W is None:
            raise ValueError("the dense fused tail needs W")
        W = _device_w(W, dev)

        def dense_tail(x, y, v, g, batch_last, keys_last, key_q):
            y1, v1 = penultimate(y, v, g)
            loss_last, gK = loss_and_grad(loss_fn, y1, batch_last, keys_last)
            mixed = (_mix_dense_quantized(W, x, y1, quant, key_q)
                     if quant_on else mix_dense(W, y1))
            return deferred(mixed, v1, gK), y1, loss_last

        return dense_tail

    if plan.m != m:
        raise ValueError(f"plan has m={plan.m}, expected {m}")
    src_t, w_t = _plan_tables(plan, dev)
    et = (eta_f, theta_f)
    layouts: dict = {}

    def layout_for(x: Params) -> WireLayout:
        sig = tuple((n, tuple(x[n].shape), x[n].dtype) for n in sorted(x))
        if sig not in layouts:
            layouts[sig] = WireLayout.for_tree(
                x, quant.bits if quant_on else 32, stacked=True)
        return layouts[sig]

    def fp32_tail(x, y, v, g, batch_last, keys_last, key_q):
        del key_q
        layout = layout_for(x)
        y1, v1 = penultimate(y, v, g)
        z = layout.flatten_f32(y1)               # [m, n]
        loss_last, gK = loss_and_grad(loss_fn, y1, batch_last, keys_last)
        acc = w_t[:, 0, None] * z
        for j in range(1, src_t.shape[0]):
            acc = acc + w_t[:, j, None] * z[src_t[j].long()]
        return deferred(layout.unflatten(acc), v1, gK), y1, loss_last

    def quant_tail(x, y, v, g, batch_last, keys_last, key_q):
        layout = layout_for(x)
        X = layout.to_planar_stacked(x)                  # [m, per, W]
        y2d = layout.to_planar_stacked(y)
        v2d = layout.to_planar_stacked(v)
        g2d = layout.to_planar_stacked(g)
        # Scales of the RESULTING delta, in B4's expression order.
        delta = (y2d + (theta_f * v2d - eta_f * g2d)) - X
        scales = layout.leaf_scales(delta, quant)        # [m, n_leaves]
        keys = None
        if quant.stochastic:     # B4 draws the noise from the keys
            keys = _quant_leaf_keys(_key_on(key_q, X.device),
                                    layout.n_leaves, m)
        y_out, v_out, words = layout.encode_momentum(
            y2d, v2d, g2d, X, scales, et, quant, keys=keys)
        y_pub = layout.from_planar_stacked(y_out)
        loss_last, gK = loss_and_grad(loss_fn, y_pub, batch_last, keys_last)
        gK2d = layout.to_planar_stacked(gK)
        base = (_weighted_replica_base(X, w_t, src_t)
                if quant.delta_mode == "lemma5" else X)
        out = layout.decode_apply_momentum(base, words, scales, w_t, src_t,
                                           v_out, gK2d, et, quant)
        return layout.from_planar_stacked(out), y_pub, loss_last

    return quant_tail if quant_on else fp32_tail


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
    Wt = _device_w(spec.W, resolve_device(device))   # once, not per round
    if quant is None or not quant.enabled:
        def mixer(x, z, key=None, t=None):
            del x, key, t
            return mix_dense(Wt, z)
        return mixer

    def mixer(x, z, key=None, t=None):
        del t
        return _mix_dense_quantized(Wt, x, z, quant, key)
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
