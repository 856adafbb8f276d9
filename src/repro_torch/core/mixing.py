"""Gossip mixing x^{t+1}(i) = sum_l w_{i,l} z^t(l)  (paper eqs. 5 and 7) —
the single-device part of the JAX package's ``core/mixing.py``, for a
static ``MixingSpec`` and a time-varying ``TopologySchedule``.

Client copies are stacked: every leaf of a parameter dict carries a
leading client axis of size m. Two backends:

  * ``dense`` — ``x' = W @ z`` as a tensordot over the client axis, and
    its quantized recursion; the reference, for any W.

  * the PLAN realization (``impl="ring"`` / ``"torus"`` for those specs,
    ``"sparse"`` for any other bounded-degree graph and every schedule)
    — the JAX package's sparse executor
    on a one-device client mesh, whose mesh-free spec is
    ``execute_plan_reference``. Quantized, one round is: flatten to the
    planar wire buffer, encode every client in one B1 launch (which draws
    the stochastic-rounding noise itself from the per-leaf keys), then one
    B2 launch that gathers each plan step's words and scales through the
    plan's ``src`` table (the index gather that stands in for the
    ``ppermute``) and decodes and applies them, own stream first.

A schedule's round samples ``(W_t, active)`` on the device
(``TopologySchedule.round_event``); the plan realization then gathers
B2's ``[m, K]`` weights table from ``W_t`` (one gather over the support
plan's streams, masked edges kept at weight 0 so the combination order is
the reference's), and inactive clients' ``z`` is gated back to ``x``
(``make_event_mixer``). A cycle stacks its members' plans, padded to one
K with identity streams of weight 0, and picks its member by the round
index, a host int or a device tensor, so one CUDA graph holds every
member.

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
from .topology import MixingSpec, TopologySchedule, _at, _on
from .wire_layout import WireLayout

Params = dict[str, torch.Tensor]

__all__ = ["MixerConfig", "make_mixer", "make_scheduled_mixer",
           "make_plan_mixer", "make_event_mixer", "make_fused_tail",
           "mix_dense", "consensus_distance"]

_IMPLS = ("auto", "dense", "ring", "torus", "sparse")


@dataclasses.dataclass(frozen=True)
class MixerConfig:
    """Gossip mixer selection.

    impl:  "auto" | "dense" | "ring" | "torus" | "sparse". "dense" is
           the tensordot reference; "ring"/"torus"/"sparse" run the
           compiled GossipPlan (the plan realization); "auto" picks the
           plan realization for every schedule and every static graph
           but a complete one, as the JAX package does on a one-device
           client mesh.
    quant: None disables Algorithm 2.
    """

    impl: str = "auto"
    quant: QuantConfig | None = None

    def __post_init__(self):
        if self.impl not in _IMPLS:
            raise ValueError(
                f"unknown mixer impl {self.impl!r}; allowed impls: "
                + " | ".join(repr(i) for i in _IMPLS))

    def resolved_impl(self, spec: MixingSpec | TopologySchedule) -> str:
        if self.impl != "auto":
            return self.impl
        if isinstance(spec, TopologySchedule):
            return "sparse"
        if spec.kind in ("ring", "torus"):
            return spec.kind
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


class _PlanTables:
    """A plan's streams on one device: ``src`` int32 [K, m] — row 0 the
    identity (a client's own stream), then one row per live plan step —
    and, for a static plan, its weights f32 [m, K]. :meth:`weights`
    gathers a round's table from a sampled ``W_t`` on the device: column
    0 ``W[c, c]``, column k ``W[c, src[k, c]]``, idle slots 0, the
    reference's ``gather_weights`` over the same live steps."""

    def __init__(self, plan: GossipPlan, dev: torch.device):
        live = [k for k in range(plan.n_steps) if plan.wire_pairs(k)]
        ident = np.arange(plan.m)
        src = np.stack([ident] + [plan.src[k] for k in live])
        idle = np.ascontiguousarray(src.T == ident[:, None])
        idle[:, 0] = False
        self.src = torch.as_tensor(src.astype(np.int32), device=dev)
        # Row-major, as B2 reads the table the gather writes.
        self._idx = torch.as_tensor(np.ascontiguousarray(src.T, np.int64),
                                    device=dev)
        self._idle = torch.as_tensor(idle, device=dev)
        self.static = None
        if plan.is_static:
            w_self, w_steps = plan.static_weights()
            w = np.stack([w_self] + [w_steps[k] for k in live], axis=1)
            self.static = torch.as_tensor(w.astype(np.float32), device=dev)

    def weights(self, W: torch.Tensor) -> torch.Tensor:
        return torch.where(self._idle, 0.0, W.gather(1, self._idx))


def _plan_tables(plan: GossipPlan, dev: torch.device
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """A static plan's ``src`` int32 [K, m] and weights f32 [m, K]."""
    tables = _PlanTables(plan, dev)
    if tables.static is None:
        raise ValueError(f"plan {plan.name!r} has no static weights")
    return tables.src, tables.static


def _make_plan_exec(m: int, quant: QuantConfig | None) -> Callable:
    """The plan realization's body: ``ex(x, z, w, src, key) -> x'`` for a
    weights table w [m, K] and streams src [K, m] on the parameters'
    device. Quantized: flatten to the planar wire buffer, encode every
    client in one B1 launch (drawing the stochastic-rounding noise from
    the per-leaf keys), then one B2 launch that gathers each stream's
    words and scales through ``src`` and decodes and applies them in
    stream order."""
    layouts: dict = {}

    def mix_fp32(z: Params, w: torch.Tensor, src: torch.Tensor) -> Params:
        out = {}
        for name, zl in z.items():
            zf = zl.to(torch.float32)
            bshape = (-1,) + (1,) * (zf.dim() - 1)
            acc = w[:, 0].reshape(bshape) * zf
            for j in range(1, src.shape[0]):
                acc = acc + w[:, j].reshape(bshape) * zf[src[j].long()]
            out[name] = acc.to(zl.dtype)
        return out

    def ex(x: Params, z: Params, w: torch.Tensor, src: torch.Tensor,
           key) -> Params:
        if quant is None or not quant.enabled:
            return mix_fp32(z, w, src)
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
                                    layout.n_leaves, m)
        words = layout.encode(delta, scales, quant, keys=keys)
        base = (_weighted_replica_base(X, w, src)
                if quant.delta_mode == "lemma5" else X)
        out = layout.decode_apply(base, words, scales, w, src, quant)
        return layout.from_planar_stacked(out)

    return ex


def make_plan_mixer(plan: GossipPlan, quant: QuantConfig | None = None,
                    device=None) -> Callable:
    """Static plan (baked weights) -> mixer(x, z, key=None, t=None) -> x'.

    The single-device realization of the JAX package's sparse executor:
    the streams a client combines are its own followed by one per live
    plan step, and every step's ``ppermute`` becomes an index gather on
    the device (inside B2 for the quantized wire).
    """
    tables = _PlanTables(plan, resolve_device(device))
    if tables.static is None:
        raise ValueError(f"plan {plan.name!r} has no static weights")
    ex = _make_plan_exec(plan.m, quant)

    def mixer(x: Params, z: Params, key=None, t=None) -> Params:
        del t
        return ex(x, z, tables.static, tables.src, key)

    return mixer


def _gate_z(active: torch.Tensor, z: Params, x: Params) -> Params:
    """Inactive clients send nothing: their ``z`` falls back to ``x``."""
    return {n: torch.where(active.reshape((-1,) + (1,) * (z[n].dim() - 1))
                           > 0, z[n], x[n]) for n in z}


def make_event_mixer(m: int, quant: QuantConfig | None = None,
                     plan: GossipPlan | None = None, gate: bool = True,
                     device=None) -> Callable:
    """Build mix_event(x, z, W, active, key=None) -> x' for a mixing
    event sampled outside the mixer: ``W`` [m, m] f32 and ``active`` [m]
    f32, both on the device (another device is refused, never copied).
    This is how a stateful walk and the compute-skip round hand the
    round's event over.

    ``plan=None`` runs the dense reference (any W); a plan (its support
    covering W's off-diagonal) runs the plan realization with the round's
    weights gathered from ``W``. ``gate=False`` skips the inactive-client
    z gate (events that never sideline a client)."""
    dev = resolve_device(device)
    if plan is not None:
        if plan.m != m:
            raise ValueError(f"plan has m={plan.m}, expected {m}")
        tables = _PlanTables(plan, dev)
        ex = _make_plan_exec(m, quant)

        def mix_event(x, z, W, active, key=None):
            z_eff = _gate_z(_on(active, dev, "active"), z, x) if gate else z
            return ex(x, z_eff, tables.weights(_device_w(W, dev)),
                      tables.src, key)

        return mix_event

    def mix_event(x, z, W, active, key=None):
        z_eff = _gate_z(_on(active, dev, "active"), z, x) if gate else z
        W = _device_w(W, dev)
        if quant is None or not quant.enabled:
            return mix_dense(W, z_eff)
        return _mix_dense_quantized(W, x, z_eff, quant, key)

    return mix_event


def _gate_tail(active: torch.Tensor, x: Params, y: Params, v: Params,
               g: Params) -> tuple[Params, Params, Params]:
    """Inactive clients publish ``y = x`` and apply ``v = g = 0``; v and g
    are multiplied by ``active`` (the reference's signed zeros)."""
    y = _gate_z(active, y, x)
    return y, _scale_by(v, active), _scale_by(g, active)


def _scale_by(tree: Params, active: torch.Tensor) -> Params:
    return {n: (t * active.reshape((-1,) + (1,) * (t.dim() - 1)))
            .to(t.dtype) for n, t in tree.items()}


def make_fused_tail(loss_fn: Callable, m: int, *, eta: float, theta: float,
                    quant: QuantConfig | None = None,
                    plan: GossipPlan | None = None,
                    W=None, device=None, gate: bool = False) -> Callable:
    """Fused-round tail on one device: the round's last two local steps,
    the wire encode and the combined decode-apply — the single-device
    counterpart of the JAX package's ``make_fused_tail``.

    The returned ``tail(x, y, v, g, batch_last, keys_last, key_q,
    active=None, W=None)`` consumes
    :func:`~repro_torch.core.local_sgd.local_train_deferred`'s output
    (``y``/``v``/``g`` the un-applied penultimate step, stacked over
    clients) and returns ``(x_next, y_pub, loss_last)``:

      1. SEND — ``v' = theta*v - eta*g; y' = y + v'`` and ``pack(Q(y' -
         x))`` in one pass (B4); the published z is ``y'``.
      2. The round's LAST gradient ``g_K = grad(y')``.
      3. RECEIVE — ``x' = [base + sum_k w_k*deq(stream_k)] + (theta*v' -
         eta*g_K)`` in one pass (B5), each plan step's stream gathered
         through ``src``.

    An algorithm variant: neighbours see y_{K-1}, not y_K; at ``eta ==
    0`` it equals the unfused round bitwise. ``plan=None`` is the dense
    reference (tree-level, any ``W``); a :class:`GossipPlan` runs the
    plan body (plain torch on the fp32 wire, B4 and B5 on the quantized
    wire). ``loss_last`` [m] holds the last step's losses.

    A round's own ``W`` (a schedule's ``W_t``, f32 on the device)
    replaces the ``W`` given here; on a structure-only plan it is needed,
    and its weights are gathered each round. With ``gate=True`` inactive
    clients (``active`` [m] f32) gate to ``y = x, v = g = 0`` before the
    encode, so they publish ``Q(0)``, apply a zero deferred update and
    are held exactly.
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

    def gated(active):
        if not gate:
            return None
        if active is None:
            raise ValueError("a gated tail needs the round's active mask")
        return _on(active, dev, "active")

    if plan is None:
        W0 = None if W is None else _device_w(W, dev)

        def dense_tail(x, y, v, g, batch_last, keys_last, key_q,
                       active=None, W=None):
            Wr = W0 if W is None else _device_w(W, dev)
            if Wr is None:
                raise ValueError("the dense fused tail needs W")
            act = gated(active)
            if act is not None:
                y, v, g = _gate_tail(act, x, y, v, g)
            y1, v1 = penultimate(y, v, g)
            loss_last, gK = loss_and_grad(loss_fn, y1, batch_last, keys_last)
            if act is not None:
                gK = _scale_by(gK, act)
            mixed = (_mix_dense_quantized(Wr, x, y1, quant, key_q)
                     if quant_on else mix_dense(Wr, y1))
            return deferred(mixed, v1, gK), y1, loss_last

        return dense_tail

    if plan.m != m:
        raise ValueError(f"plan has m={plan.m}, expected {m}")
    tables = _PlanTables(plan, dev)
    src_t = tables.src
    et = (eta_f, theta_f)
    layouts: dict = {}

    def weights_of(W):
        if W is not None:
            return tables.weights(_device_w(W, dev))
        if tables.static is None:
            raise ValueError(f"plan {plan.name!r} has no static weights: "
                             "pass the round's W")
        return tables.static

    def layout_for(x: Params) -> WireLayout:
        sig = tuple((n, tuple(x[n].shape), x[n].dtype) for n in sorted(x))
        if sig not in layouts:
            layouts[sig] = WireLayout.for_tree(
                x, quant.bits if quant_on else 32, stacked=True)
        return layouts[sig]

    def fp32_tail(x, y, v, g, batch_last, keys_last, key_q, active=None,
                  W=None):
        del key_q
        w_t = weights_of(W)
        act = gated(active)
        if act is not None:
            y, v, g = _gate_tail(act, x, y, v, g)
        layout = layout_for(x)
        y1, v1 = penultimate(y, v, g)
        z = layout.flatten_f32(y1)               # [m, n]
        loss_last, gK = loss_and_grad(loss_fn, y1, batch_last, keys_last)
        if act is not None:
            gK = _scale_by(gK, act)
        acc = w_t[:, 0, None] * z
        for j in range(1, src_t.shape[0]):
            acc = acc + w_t[:, j, None] * z[src_t[j].long()]
        return deferred(layout.unflatten(acc), v1, gK), y1, loss_last

    def quant_tail(x, y, v, g, batch_last, keys_last, key_q, active=None,
                   W=None):
        w_t = weights_of(W)
        act = gated(active)
        layout = layout_for(x)
        X = layout.to_planar_stacked(x)                  # [m, per, W]
        y2d = layout.to_planar_stacked(y)
        v2d = layout.to_planar_stacked(v)
        g2d = layout.to_planar_stacked(g)
        if act is not None:
            am = act[:, None, None]
            y2d = torch.where(am > 0, y2d, X)
            v2d = v2d * am
            g2d = g2d * am
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
        if act is not None:
            gK2d = gK2d * act[:, None, None]
        base = (_weighted_replica_base(X, w_t, src_t)
                if quant.delta_mode == "lemma5" else X)
        out = layout.decode_apply_momentum(base, words, scales, w_t, src_t,
                                           v_out, gK2d, et, quant)
        return layout.from_planar_stacked(out), y_pub, loss_last

    return quant_tail if quant_on else fp32_tail


def _make_cycle_mixer(schedule: TopologySchedule, quant: QuantConfig | None,
                      dev: torch.device) -> Callable:
    """The plan realization of a cycle: each member's static plan (its
    own support, baked weights), their tables stacked and padded to the
    largest K with identity streams of weight 0 (after the member's own
    streams, so its combination order is its plan's), and the member
    picked by ``t mod n`` — a host int, or a device tensor in a captured
    round: one graph holds every member, where the reference switches
    between per-member programs."""
    tables = [_PlanTables(p, dev) for p in schedule.gossip_plans()]
    k_max = max(t.src.shape[0] for t in tables)
    m = schedule.m
    ident = torch.arange(m, dtype=torch.int32, device=dev)
    src_all = torch.stack([torch.cat([t.src, ident.expand(
        k_max - t.src.shape[0], m)]) for t in tables])       # [n, K, m]
    w_all = torch.stack([torch.cat([t.static, t.static.new_zeros(
        m, k_max - t.static.shape[1])], dim=1) for t in tables])
    n = len(tables)
    ones = schedule.tables(dev)["ones"]
    ex = _make_plan_exec(m, quant)

    def mixer(x: Params, z: Params, key, t):
        return ex(x, z, _at(w_all, t, n), _at(src_all, t, n), key), ones

    return mixer


def _schedule_plan(schedule: TopologySchedule, cfg: MixerConfig
                  ) -> GossipPlan | None:
    """The support plan a schedule's rounds run on (impl ``"sparse"``,
    which ``"auto"`` picks), or None for the dense reference."""
    if cfg.impl not in ("auto", "dense", "sparse"):
        raise ValueError("time-varying schedules support impl 'dense', "
                         f"'sparse' or 'auto', got impl={cfg.impl!r}")
    return (schedule.gossip_plan() if cfg.resolved_impl(schedule) == "sparse"
            else None)


def make_scheduled_mixer(schedule: TopologySchedule, cfg: MixerConfig,
                         device=None) -> Callable:
    """Build mixer(x, z, key, t) -> (x', active) for a time-varying
    topology: ``(W_t, active, key_q) = schedule.round_event(key, t)`` on
    the device, inactive clients' z gated back to x, then gossip with
    W_t through the chosen backend (``dense``, or ``sparse``: the support
    plan with the round's weights gathered from W_t; ``auto`` is
    ``sparse``). ``key`` lies on the device; ``t`` is the round, a host
    int or a 0-dim device tensor. The schedule's tables go to the device
    here, once.

    As in the reference, the ``eq7`` recursion is only stable for PSD
    W_t, which a sampled Metropolis W_t need not be: prefer ``lemma5``.
    """
    dev = resolve_device(device)
    schedule.tables(dev)
    plan = _schedule_plan(schedule, cfg)
    if plan is not None and schedule.kind == "cycle":
        return _make_cycle_mixer(schedule, cfg.quant, dev)
    ev = make_event_mixer(schedule.m, quant=cfg.quant, plan=plan,
                          gate=schedule.gates_participation, device=dev)

    def mixer(x: Params, z: Params, key: torch.Tensor, t):
        W_t, active, key_q = schedule.round_event(_key_on(key, dev), t)
        return ev(x, z, W_t, active, key_q), active

    return mixer


def make_mixer(spec: MixingSpec | TopologySchedule, cfg: MixerConfig,
               device=None) -> Callable:
    """Return mixer(x_stacked, z_stacked, key=None, t=None) -> x_next for
    a static spec. The one device is a one-shard client mesh: ``"auto"``
    on a ring (a torus) resolves to ``"ring"`` (``"torus"``), the plan
    realization; ``"dense"`` stays available as the second oracle.

    A :class:`TopologySchedule` returns the time-varying mixer(x, z, key,
    t) -> (x', active) of :func:`make_scheduled_mixer`."""
    if isinstance(spec, TopologySchedule):
        return make_scheduled_mixer(spec, cfg, device=device)
    if not isinstance(spec, MixingSpec):
        raise TypeError(f"expected a MixingSpec or a TopologySchedule, got "
                        f"{type(spec).__name__}")
    impl = cfg.resolved_impl(spec)
    if impl == "ring" and spec.kind == "torus":
        impl = "torus"   # the reference's alias: ring impl on a torus
    quant = cfg.quant
    if impl in ("ring", "torus", "sparse"):
        if impl != "sparse" and spec.kind != impl:
            raise ValueError(f"{impl} mixer needs a {impl} MixingSpec, got "
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
