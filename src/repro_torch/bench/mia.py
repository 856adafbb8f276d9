"""§6 MIA: membership-privacy probe — AUC for a DFedAvgM-trained target
(more training => more leakage; the paper's qualitative claim); the
reference's ``benchmarks/bench_mia.py`` on the port.

For 5 and 60 rounds a shadow model (seed 0) and a target model (seed 1)
train by DFedAvgM (m 8, K 4, batch 16, the ring, eta 0.1, theta 0.9,
fp32 gossip) on their halves of ``classification_dataset(n=1600, d=64,
noise=3.0, seed=3)``; the attack model learns membership from the
shadow's top-3 probabilities and is scored on the target's. On the card
every round is one CUDA graph replay. ``--smoke``: 2 rounds on n 400.
"""
from __future__ import annotations

from .. import prng
from ..core import (DFedAvgMConfig, MixingSpec, average_params,
                    init_round_state, make_round_step)
from ..data import FederatedDataset, classification_dataset
from ..device import resolve_device
from ..models.paper_nets import apply_2nn, init_2nn
from ..privacy import attack_auc, mia_split
from .common import loss_2nn, run_rounds, stacked

M, K, B = 8, 4, 16
N, D, NOISE, DATA_SEED = 1600, 64, 3.0, 3
ROUNDS = (5, 60)
SMOKE_N, SMOKE_ROUNDS = 400, (2,)


def train_run(data, idx, rounds, seed=0, *, device=None, capture=True
              ) -> dict:
    """DFedAvgM on ``data``'s rows ``idx`` for ``rounds`` rounds from
    ``init_2nn(PRNGKey(seed), d_in=64)`` broadcast to M clients and
    ``init_round_state(..., PRNGKey(seed + 1))``: the reference's
    ``_train_on`` set-up; returns :func:`~.common.run_rounds`' record."""
    dev = resolve_device(device)
    sub = type(data)(x=data.x[idx], y=data.y[idx], n_classes=data.n_classes)
    fed = FederatedDataset.make(sub, M, iid=True, seed=seed)
    step = make_round_step(loss_2nn, DFedAvgMConfig(
        eta=0.1, theta=0.9, local_steps=K), MixingSpec.ring(M), device=dev)
    p0 = init_2nn(prng.PRNGKey(seed), d_in=data.x.shape[1], device=dev)
    st = init_round_state(stacked(p0, M), prng.PRNGKey(seed + 1))
    return run_rounds(step, st, lambda t: fed.round_batches(
        t, K=K, batch=B, device="cpu"), rounds, capture=capture)


def _train_on(data, idx, rounds, seed=0, *, device=None, capture=True):
    """The consensus model after :func:`train_run` (the reference's
    ``_train_on``)."""
    return average_params(train_run(data, idx, rounds, seed, device=device,
                                    capture=capture)["state"].params)


def aucs(*, smoke: bool = False, device=None, capture: bool = True):
    """(rounds, auc, shadow params, target params) for each row."""
    dev = resolve_device(device)
    data = classification_dataset(n=SMOKE_N if smoke else N, d=D,
                                  noise=NOISE, seed=DATA_SEED)
    split = mia_split(len(data.y), seed=0)
    for rounds in SMOKE_ROUNDS if smoke else ROUNDS:
        shadow = _train_on(data, split.shadow_train, rounds, seed=0,
                           device=dev, capture=capture)
        target = _train_on(data, split.target_train, rounds, seed=1,
                           device=dev, capture=capture)
        auc = attack_auc(lambda v: apply_2nn(shadow, v),
                         lambda v: apply_2nn(target, v), data, split,
                         device=dev)
        yield rounds, auc, shadow, target


def run(*, smoke: bool = False, device=None):
    return [(f"mia/dfedavgm/rounds{rounds}", 0.0, f"auc={auc:.3f}")
            for rounds, auc, _, _ in aucs(smoke=smoke, device=device)]
