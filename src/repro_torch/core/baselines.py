"""Baselines the paper compares against (Fig. 6): FedAvg and DSGD — the
JAX package's ``core/baselines.py``.

* FedAvg [McMahan et al. 2017] — centralized: all clients run K local
  steps, the "server" averages (a mean over the client axis, broadcast
  back). Equivalent to DFedAvgM on the complete graph with W = 11^T/m.

* DSGD [Lian et al. 2017] — decentralized SGD, eq. (2) of the paper:
  one gradient step + one gossip per round:
      x^{t+1}(i) = sum_l w_il x^t(l) - gamma * g^t(i).

Both take the round step's contract (``RoundState``, batches [m, K, ...]
on the device, metrics as 0-dim device tensors) and its PRNG chain with
two keys a round, so ``core.compiled.capture_step`` captures them too.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .. import prng
from ..device import resolve_device
from .dfedavgm import RoundState
from .local_sgd import local_train, loss_and_grad
from .mixing import _device_w, consensus_distance, mix_dense
from .topology import MixingSpec

Params = dict[str, torch.Tensor]
LossFn = Callable[..., torch.Tensor]

__all__ = ["FedAvgConfig", "make_fedavg_step", "DSGDConfig", "make_dsgd_step"]


@dataclasses.dataclass(frozen=True)
class FedAvgConfig:
    """Centralized FedAvg baseline hyper-parameters (the paper's
    comparison point: one server round == K local steps + an average)."""
    eta: float = 0.1
    theta: float = 0.0       # plain local SGD unless momentum requested
    local_steps: int = 4


def make_fedavg_step(loss_fn: LossFn, cfg: FedAvgConfig, m: int, *,
                     device=None, with_metrics: bool = True) -> Callable:
    """round_step(state, batches[m, K, ...]) -> (state', metrics), with
    full participation (the paper's Fig. 6 setting). The K local steps
    are :func:`~repro_torch.core.local_sgd.local_train` (B3 on the
    card). ``device`` defaults to CUDA; ``"cpu"`` runs the plain
    versions."""
    resolve_device(device)

    def round_step(state: RoundState, batches: Params):
        key_round, key_next = prng.split(state.rng)
        client_keys = prng.split(key_round, m)
        z, losses = local_train(loss_fn, state.params, batches, client_keys,
                                eta=cfg.eta, theta=cfg.theta)
        # Server aggregation: mean over the client axis, broadcast back.
        zbar = {n: t.to(torch.float32).mean(dim=0, keepdim=True)
                .expand(t.shape).to(t.dtype).contiguous()
                for n, t in z.items()}
        metrics = {"loss": losses.mean()}
        if with_metrics:
            metrics["consensus_dist"] = consensus_distance(zbar)
            metrics["local_drift"] = consensus_distance(z)
        return RoundState(params=zbar, rng=key_next,
                          round=state.round + 1), metrics

    return round_step


@dataclasses.dataclass(frozen=True)
class DSGDConfig:
    """Decentralized SGD (eq. 2) baseline: one gradient step per gossip
    round, step size ``gamma`` — no local epochs, no momentum."""
    gamma: float = 0.1


def make_dsgd_step(loss_fn: LossFn, cfg: DSGDConfig, spec: MixingSpec, *,
                   device=None, with_metrics: bool = True) -> Callable:
    """Eq. (2): gossip the current params, subtract a local gradient.

    ``batches`` leaves are [m, 1, ...] (one minibatch per round), the
    data pipeline of DFedAvgM at K=1. The mix is ``mix_dense`` with W
    put on the device once, here."""
    m = spec.m
    Wt = _device_w(spec.W, resolve_device(device))

    def round_step(state: RoundState, batches: Params):
        key_round, key_next = prng.split(state.rng)
        client_keys = prng.split(key_round, m)
        one = {n: b[:, 0] for n, b in batches.items()}
        losses, grads = loss_and_grad(loss_fn, state.params, one, client_keys)
        mixed = mix_dense(Wt, state.params)
        x_next = {n: (xm.to(torch.float32)
                      - cfg.gamma * grads[n].to(torch.float32)).to(xm.dtype)
                  for n, xm in mixed.items()}
        metrics = {"loss": losses.mean()}
        if with_metrics:
            metrics["consensus_dist"] = consensus_distance(x_next)
        return RoundState(params=x_next, rng=key_next,
                          round=state.round + 1), metrics

    return round_step
