"""DFedAvgM (Algorithm 1) and quantized DFedAvgM (Algorithm 2) — the
synchronous round of the JAX package's ``core/dfedavgm.py`` for a static
``MixingSpec``, unfused or fused (``DFedAvgMConfig.fuse_round``).

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
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from .. import prng
from ..device import resolve_device
from .comm_cost import dfedavgm_round_bits
from .local_sgd import local_train, local_train_deferred
from .mixing import (MixerConfig, consensus_distance, make_fused_tail,
                     make_mixer)
from .quantize import QuantConfig
from .topology import MixingSpec

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
    mixer_impl: "auto" | "dense" | "ring" | "sparse" (see MixerConfig)
    fuse_round: the fused round (``core.mixing.make_fused_tail``): the
           last two local steps fold into the wire encode (B4) and decode
           (B5) kernels. An algorithm variant — neighbours see y_{K-1},
           not y_K — equal to the default round only at ``eta == 0``.
           Needs ``local_steps >= 2``.
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
    """Carried state of the synchronous round loop."""

    params: Params        # stacked client copies, leaves [m, ...]
    rng: torch.Tensor     # round-level key, int64 [2], on the params' device
    round: int


def init_round_state(params_stacked: Params, key: torch.Tensor
                     ) -> RoundState:
    """The round loop's first state; the key moves to the parameters'
    device, where the whole key chain then runs."""
    dev = next(iter(params_stacked.values())).device
    return RoundState(params=params_stacked, rng=key.to(dev), round=0)


def average_params(stacked: Params) -> Params:
    """Consensus/average model xbar = (1/m) sum_i x(i)."""
    return {n: z.to(torch.float32).mean(dim=0).to(z.dtype)
            for n, z in stacked.items()}


def round_comm_bits(spec: MixingSpec, n_params: int,
                    quant: QuantConfig | None) -> int:
    """Bits moved on the graph in ONE round (paper §3.2 accounting):
    every client sends its (possibly quantized) message across each
    directed edge."""
    return dfedavgm_round_bits(spec.graph, n_params, quant)


def make_round_step(loss_fn: LossFn, cfg: DFedAvgMConfig, spec: MixingSpec,
                    *, device=None, with_metrics: bool = True,
                    with_telemetry: bool = False,
                    skip_inactive_compute: bool = False,
                    async_cfg=None, placement=None) -> Callable:
    """Build round_step(state, batches) -> (state', metrics).

    ``batches``: dict with leaves [m, K, ...] on ``device``. ``loss_fn``
    (params, batch, rng) returns the per-client losses [m]. ``device``
    defaults to CUDA; pass ``"cpu"`` to run the plain versions of the
    kernels on the CPU. Metrics are 0-dim tensors on the device: ``loss``
    (mean over clients of the mean local loss), and with ``with_metrics``
    ``consensus_dist`` of x^{t+1} and ``local_drift`` of z^t.
    """
    if not isinstance(spec, MixingSpec):
        raise NotImplementedError("time-varying schedules are not ported "
                                  "yet (ROADMAP A12)")
    if async_cfg is not None:
        raise NotImplementedError("the async engine is not ported yet "
                                  "(ROADMAP A14)")
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
    if skip_inactive_compute:
        raise NotImplementedError("compute-skip gathers come with the "
                                  "schedules (ROADMAP A12)")
    resolve_device(device)
    m = spec.m
    mixer = make_mixer(spec, cfg.mixer_config(), device=device)

    def round_step(state: RoundState, batches: Params):
        key_round, key_mix, key_next = prng.split(state.rng, 3)
        client_keys = prng.split(key_round, m)
        z, losses = local_train(loss_fn, state.params, batches, client_keys,
                                eta=cfg.eta, theta=cfg.theta)
        x_next = mixer(state.params, z, key_mix, state.round)
        metrics = {"loss": losses.mean()}
        if with_metrics:
            metrics["consensus_dist"] = consensus_distance(x_next)
            metrics["local_drift"] = consensus_distance(z)
        return RoundState(params=x_next, rng=key_next,
                          round=state.round + 1), metrics

    return round_step


def _make_fused_round_step(loss_fn: LossFn, cfg: DFedAvgMConfig,
                           spec: MixingSpec, *, device=None,
                           with_metrics: bool = True,
                           skip_inactive_compute: bool = False) -> Callable:
    """The ``cfg.fuse_round`` realization of :func:`make_round_step`: K-2
    local steps (``local_train_deferred``), then the fused tail
    (``core.mixing.make_fused_tail``) — penultimate update + encode in
    one pass (B4), the last gradient, mix + deferred last update in one
    pass (B5). Same ``round_step(state, batches)`` contract and PRNG
    chain; the ``loss`` metric averages the same K per-step losses and
    ``local_drift`` is taken of the published z = y_{K-1}. Not
    bit-compatible with the unfused round except at ``eta == 0``."""
    if skip_inactive_compute is True:
        raise ValueError("fuse_round runs the full-width client vmap; "
                         "skip_inactive_compute=True is incompatible")
    if cfg.local_steps < 2:
        raise ValueError(
            f"fuse_round needs local_steps >= 2 (one step is deferred "
            f"past the mix), got {cfg.local_steps}")
    resolve_device(device)
    m = spec.m
    impl = cfg.mixer_config().resolved_impl(spec)
    if impl == "ring" and spec.kind != "ring":
        raise ValueError(f"ring mixer needs a ring MixingSpec, got "
                         f"kind={spec.kind!r}")
    plan = spec.gossip_plan() if impl in ("ring", "sparse") else None
    tail = make_fused_tail(loss_fn, m, eta=cfg.eta, theta=cfg.theta,
                           quant=cfg.quant, plan=plan, W=spec.W,
                           device=device)

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
        x_next, y_pub, loss_last = tail(state.params, y, v, g, batch_last,
                                        keys_last, key_mix)
        losses = torch.cat([losses_head, loss_last[:, None]], dim=1)
        metrics = {"loss": losses.mean(dim=1).mean()}
        if with_metrics:
            metrics["consensus_dist"] = consensus_distance(x_next)
            metrics["local_drift"] = consensus_distance(y_pub)
        return RoundState(params=x_next, rng=key_next,
                          round=state.round + 1), metrics

    return round_step
