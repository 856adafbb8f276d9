"""DFedAvgM (Algorithm 1) and quantized DFedAvgM (Algorithm 2) — the
synchronous round of the JAX package's ``core/dfedavgm.py`` for a static
``MixingSpec`` or a time-varying ``TopologySchedule``, unfused or fused
(``DFedAvgMConfig.fuse_round``).

One communication round:

  1. every client i runs K heavy-ball SGD steps from x^t(i)   (local_sgd)
  2. unquantized: send z^t(i) = y^{t,K}(i); x^{t+1} = W z^t    (eq. 5)
     quantized:   send q^t(i) = Q(y^{t,K}(i) - x^t(i)) and mix (eq. 7,
                  or the Lemma-5 recursion)

Client copies are stacked on a leading axis of size m. The PRNG chain is
the JAX one: ``split(state.rng, 3)`` gives the round, mixing and next
keys, and ``split(key_round, m)`` the client keys. The key lives on the
parameters' device, so the chain runs there and a round copies nothing
from the host (``core.compiled`` captures it in one CUDA graph).

A schedule's round samples its event ``(W_t, active)`` on the device from
the mixing key and the round index (a host int, or in a captured round a
0-dim device tensor); a stateful walk also carries its token in
``RoundState.token``. With a statically bounded active count the round
trains only the active lanes (``skip_inactive_compute``): a fixed-size
gather and a scatter into an [m + 1] buffer whose last row takes the
padded slots, with no host sync.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from .. import prng
from ..device import resolve_device
from .comm_cost import dfedavgm_round_bits, schedule_round_bits
from .local_sgd import local_train, local_train_deferred
from .mixing import (MixerConfig, _schedule_plan, consensus_distance,
                     make_event_mixer, make_fused_tail, make_mixer)
from .quantize import QuantConfig
from .topology import MixingSpec, TopologySchedule

Params = dict[str, torch.Tensor]
LossFn = Callable[..., torch.Tensor]

__all__ = ["DFedAvgMConfig", "RoundState", "init_round_state",
           "make_round_step", "average_params", "round_comm_bits"]


@dataclasses.dataclass(frozen=True)
class DFedAvgMConfig:
    """Hyper-parameters of Algorithms 1/2.

    eta:   local learning rate
    theta: heavy-ball momentum in [0, 1)
    local_steps: K — local iterations per communication round
    quant: None -> Algorithm 1; QuantConfig -> Algorithm 2
    mixer_impl: "auto" | "dense" | "ring" | "torus" | "sparse" (see
           MixerConfig)
    fuse_round: the fused round (``core.mixing.make_fused_tail``): the
           last two local steps fold into the wire encode (B4) and decode
           (B5) kernels. An algorithm variant — neighbours see y_{K-1},
           not y_K — equal to the default round only at ``eta == 0``.
           Needs ``local_steps >= 2``; refuses stateful schedules and
           compute-skip gathers.
    """

    eta: float = 0.01
    theta: float = 0.9
    local_steps: int = 4
    quant: QuantConfig | None = None
    mixer_impl: str = "auto"
    fuse_round: bool = False

    def mixer_config(self) -> MixerConfig:
        return MixerConfig(impl=self.mixer_impl, quant=self.quant)


class RoundState(NamedTuple):
    """Carried state of the synchronous round loop: stacked client
    params, the key chain, the round counter and, for a stateful
    schedule, the walk token."""

    params: Params        # stacked client copies, leaves [m, ...]
    rng: torch.Tensor     # round-level key, int64 [2], on the params' device
    round: int            # a host int (a 0-dim device tensor when captured)
    token: torch.Tensor | None = None   # stateful walk: int64 0-dim


def init_round_state(params_stacked: Params, key: torch.Tensor,
                     token: torch.Tensor | None = None) -> RoundState:
    """The round loop's first state; the key (and a stateful schedule's
    ``token``, ``schedule.init_token()``) move to the parameters' device,
    where the whole key chain then runs."""
    dev = next(iter(params_stacked.values())).device
    return RoundState(params=params_stacked, rng=key.to(dev), round=0,
                      token=None if token is None else token.to(dev))


def average_params(stacked: Params) -> Params:
    """Consensus/average model xbar = (1/m) sum_i x(i)."""
    return {n: z.to(torch.float32).mean(dim=0).to(z.dtype)
            for n, z in stacked.items()}


def round_comm_bits(spec: MixingSpec | TopologySchedule, n_params: int,
                    quant: QuantConfig | None, t: int | None = None,
                    plan=None) -> float:
    """Bits moved on the graph in ONE round (paper §3.2 accounting):
    every participating client sends its (possibly quantized) message
    across each live directed edge. A schedule bills the expectation over
    its sampled edges (exact for the deterministic kinds; ``t`` picks a
    cycle's round). ``plan`` does not change the bill."""
    del plan
    if isinstance(spec, TopologySchedule):
        return schedule_round_bits(spec, n_params, quant, t)
    return dfedavgm_round_bits(spec.graph, n_params, quant)


def _check_spec(spec) -> bool:
    """Whether ``spec`` is a schedule (True) or a static spec (False)."""
    if isinstance(spec, TopologySchedule):
        return True
    if not isinstance(spec, MixingSpec):
        raise TypeError(f"expected a MixingSpec or a TopologySchedule, got "
                        f"{type(spec).__name__}")
    return False


def _weighted_mean(losses: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The mean of ``losses`` over the lanes ``w`` marks (at least 1)."""
    return (losses * w).sum() / torch.clamp(w.sum(), min=1.0)


def _active_lanes(active: torch.Tensor, k: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's ``nonzero(active, size=k, fill_value=m)`` without a
    host sync: a stable sort puts the active lanes first, in order; slots
    past the round's active count get the index m. Returns (idx [k], safe
    [k] = min(idx, m - 1), valid [k] f32)."""
    m = active.shape[0]
    order = torch.sort((active == 0).to(torch.int32), stable=True).indices
    first = order[:k]
    idx = torch.where(active[first] != 0, first, m)
    return idx, torch.clamp(idx, max=m - 1), (idx < m).to(torch.float32)


def make_round_step(loss_fn: LossFn, cfg: DFedAvgMConfig,
                    spec: MixingSpec | TopologySchedule,
                    *, device=None, with_metrics: bool = True,
                    with_telemetry: bool = False,
                    skip_inactive_compute: bool | str = "auto",
                    async_cfg=None, placement=None) -> Callable:
    """Build round_step(state, batches) -> (state', metrics).

    ``batches``: dict with leaves [m, K, ...] on ``device``. ``loss_fn``
    (params, batch, rng) returns the per-client losses [m]. ``device``
    defaults to CUDA; pass ``"cpu"`` to run the plain versions of the
    kernels on the CPU. Metrics are 0-dim tensors on the device: ``loss``
    (mean over the participating clients of the mean local loss), and
    with ``with_metrics`` ``consensus_dist`` of x^{t+1}, ``local_drift``
    of z^t and, for a schedule, ``active_frac``.

    ``spec`` may be a :class:`TopologySchedule`: the round index picks
    the event, inactive clients are held exactly, and a stateful walk
    threads its token (``init_round_state(..., token=spec.init_token())``).
    ``skip_inactive_compute``: with a statically bounded active count
    (``partial(exact=True)``, ``partial(cap_slack=...)``, walks) the round
    trains only those lanes and scatters them back; ``"auto"`` does so
    whenever the bound is below m, True insists, False keeps the full
    width. Parameters and ``loss`` are the same either way;
    ``local_drift`` then counts only the effective z (with skip off it
    includes inactive lanes' discarded updates).

    ``async_cfg`` (an :class:`~repro_torch.core.async_gossip.AsyncConfig`)
    returns the async engine's event step instead
    (``make_async_round_step``, on an ``AsyncRoundState``).
    """
    scheduled = _check_spec(spec)
    if placement is not None and async_cfg is not None:
        raise ValueError("placement is not supported with the async "
                         "engine (its lane bookkeeping is client-order)")
    if async_cfg is not None:
        from .async_gossip import make_async_round_step
        return make_async_round_step(loss_fn, cfg, spec, async_cfg,
                                     device=device,
                                     with_metrics=with_metrics,
                                     with_telemetry=with_telemetry)
    if placement is not None:
        raise NotImplementedError("client placement is not ported yet "
                                  "(ROADMAP A17)")
    if with_telemetry:
        raise NotImplementedError("telemetry is not ported yet "
                                  "(ROADMAP A16)")
    if cfg.fuse_round:
        return _make_fused_round_step(
            loss_fn, cfg, spec, device=device, with_metrics=with_metrics,
            skip_inactive_compute=skip_inactive_compute)
    dev = resolve_device(device)
    m = spec.m
    stateful = scheduled and spec.is_stateful
    k_active = spec.static_active_count if scheduled else None
    if skip_inactive_compute == "auto":
        skip = k_active is not None and k_active < m
    else:
        skip = bool(skip_inactive_compute)
        if skip and k_active is None:
            raise ValueError(
                "skip_inactive_compute=True needs a schedule with a "
                "statically bounded per-round active count "
                "(partial(..., exact=True), partial(..., cap_slack=...) "
                "or random_walk); got "
                f"{getattr(spec, 'name', spec)!r}")
        skip = skip and k_active < m
    mcfg = cfg.mixer_config()
    if stateful or skip:
        # The event is sampled before local training (it gates compute)
        # and handed to the event mixer: one draw a round.
        spec.tables(dev)
        event_mixer = make_event_mixer(
            m, quant=cfg.quant, plan=_schedule_plan(spec, mcfg),
            gate=stateful or spec.gates_participation, device=dev)
    else:
        mixer = make_mixer(spec, mcfg, device=dev)

    def round_step(state: RoundState, batches: Params):
        key_round, key_mix, key_next = prng.split(state.rng, 3)
        client_keys = prng.split(key_round, m)
        token_next = state.token
        active = None
        if stateful:
            if state.token is None:
                raise ValueError(
                    "stateful schedule: seed the walk with "
                    "init_round_state(..., token=spec.init_token())")
            W_t, active, key_q, token_next = spec.token_event(key_mix,
                                                              state.token)
        elif skip:
            W_t, active, key_q = spec.round_event(key_mix, state.round)
        if skip:
            idx, safe, valid = _active_lanes(active, k_active)
            z_sub, losses = local_train(
                loss_fn, {n: p[safe] for n, p in state.params.items()},
                {n: b[safe] for n, b in batches.items()}, client_keys[safe],
                eta=cfg.eta, theta=cfg.theta)
            # Inactive lanes never trained: their z is their held x. Padded
            # slots (index m) land in the spare last row, which is dropped.
            z = {}
            for n, xl in state.params.items():
                buf = torch.cat([xl, xl[-1:]])
                z[n] = buf.index_copy_(0, idx, z_sub[n])[:m]
        else:
            z, losses = local_train(loss_fn, state.params, batches,
                                    client_keys, eta=cfg.eta,
                                    theta=cfg.theta)
        if stateful or skip:
            x_next = event_mixer(state.params, z, W_t, active, key_q)
        elif scheduled:
            x_next, active = mixer(state.params, z, key_mix, state.round)
        else:
            x_next = mixer(state.params, z, key_mix, state.round)
        if skip:
            metrics = {"loss": _weighted_mean(losses, valid)}
        elif scheduled and spec.gates_participation:
            metrics = {"loss": _weighted_mean(losses, active)}
        else:
            metrics = {"loss": losses.mean()}
        if with_metrics:
            if scheduled:
                metrics["active_frac"] = active.mean()
            metrics["consensus_dist"] = consensus_distance(x_next)
            metrics["local_drift"] = consensus_distance(z)
        return RoundState(params=x_next, rng=key_next,
                          round=state.round + 1, token=token_next), metrics

    return round_step


def _make_fused_round_step(loss_fn: LossFn, cfg: DFedAvgMConfig,
                           spec: MixingSpec | TopologySchedule, *,
                           device=None, with_metrics: bool = True,
                           skip_inactive_compute: bool | str = "auto"
                           ) -> Callable:
    """The ``cfg.fuse_round`` realization of :func:`make_round_step`: K-2
    local steps (``local_train_deferred``), then the fused tail
    (``core.mixing.make_fused_tail``) — penultimate update + encode in
    one pass (B4), the last gradient, mix + deferred last update in one
    pass (B5). Same ``round_step(state, batches)`` contract and PRNG
    chain; the ``loss`` metric averages the same K per-step losses and
    ``local_drift`` is taken of the published z = y_{K-1}. Not
    bit-compatible with the unfused round except at ``eta == 0``. A
    schedule runs at full width (no compute-skip) with its event's W_t
    and active mask; a cycle takes the dense tail, as in the reference."""
    scheduled = _check_spec(spec)
    if scheduled and spec.is_stateful:
        raise ValueError("fuse_round does not support stateful schedules "
                         "(the walk token gates compute mid-round)")
    if skip_inactive_compute is True:
        raise ValueError("fuse_round runs the full-width client vmap; "
                         "skip_inactive_compute=True is incompatible")
    if cfg.local_steps < 2:
        raise ValueError(
            f"fuse_round needs local_steps >= 2 (one step is deferred "
            f"past the mix), got {cfg.local_steps}")
    dev = resolve_device(device)
    m = spec.m
    impl = cfg.mixer_config().resolved_impl(spec)
    if impl == "ring" and not scheduled and spec.kind not in ("ring",
                                                              "torus"):
        raise ValueError(f"ring mixer needs a ring MixingSpec, got "
                         f"kind={spec.kind!r}")
    sparse = impl in ("ring", "torus", "sparse") and not (
        scheduled and spec.kind == "cycle")
    plan = spec.gossip_plan() if sparse else None
    if scheduled:
        spec.tables(dev)
    gate = scheduled and spec.gates_participation
    tail = make_fused_tail(loss_fn, m, eta=cfg.eta, theta=cfg.theta,
                           quant=cfg.quant, plan=plan,
                           W=None if scheduled else spec.W, device=dev,
                           gate=gate)

    def round_step(state: RoundState, batches: Params):
        key_round, key_mix, key_next = prng.split(state.rng, 3)
        client_keys = prng.split(key_round, m)
        K = next(iter(batches.values())).shape[1]
        step_keys = prng.split(client_keys, K)           # [m, K, 2], once
        y, v, g, losses_head = local_train_deferred(
            loss_fn, state.params, batches, step_keys, eta=cfg.eta,
            theta=cfg.theta)                             # losses [m, K-1]
        batch_last = {n: b[:, K - 1] for n, b in batches.items()}
        keys_last = step_keys[:, K - 1]
        if scheduled:
            W_t, active, key_q = spec.round_event(key_mix, state.round)
            x_next, y_pub, loss_last = tail(state.params, y, v, g,
                                            batch_last, keys_last, key_q,
                                            active, W_t)
        else:
            x_next, y_pub, loss_last = tail(state.params, y, v, g,
                                            batch_last, keys_last, key_mix)
        losses = torch.cat([losses_head, loss_last[:, None]],
                           dim=1).mean(dim=1)
        metrics = {"loss": _weighted_mean(losses, active) if gate
                   else losses.mean()}
        if with_metrics:
            if scheduled:
                metrics["active_frac"] = active.mean()
            metrics["consensus_dist"] = consensus_distance(x_next)
            metrics["local_drift"] = consensus_distance(y_pub)
        return RoundState(params=x_next, rng=key_next,
                          round=state.round + 1, token=state.token), metrics

    return round_step
