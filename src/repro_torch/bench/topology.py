"""Gossip topology study: the reference's ``benchmarks/bench_topology.py``
on the port. A torus moves the same O(1) plan steps a round as a ring
but mixes far faster (smaller lambda), so it reaches a better non-IID
accuracy at equal communication.

Rows: lambda, rounds to consensus and degree of ring16, torus4x4,
ring32, torus4x8 and complete16 (numpy, as in the reference); then the
non-IID 2NN accuracy of ring16 against torus4x4 after 30 rounds (the
port's "auto" mixer: the ring and torus plan realizations).
"""
from __future__ import annotations

import numpy as np

from ..core import MixingSpec
from ..data import classification_dataset
from .common import train_dfedavgm_2nn

M, K, B, ROUNDS = 16, 4, 32, 30
SMOKE_M, SMOKE_K, SMOKE_B, SMOKE_ROUNDS = 4, 2, 8, 2


def _rounds_to_consensus(spec, eps=1e-3, cap=4000, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(spec.m, 5))
    for t in range(cap):
        x = spec.W @ x
        if np.abs(x - x.mean(0)).max() < eps:
            return t
    return cap


def lambda_rows():
    """(name, 0.0, derived) for each spec's lambda, consensus rounds and
    degree: the reference's rows exactly."""
    rows = []
    for name, spec in (("ring16", MixingSpec.ring(16)),
                       ("torus4x4", MixingSpec.torus(4, 4)),
                       ("ring32", MixingSpec.ring(32)),
                       ("torus4x8", MixingSpec.torus(4, 8)),
                       ("complete16", MixingSpec.complete(16))):
        rows.append((f"topology/lambda/{name}", 0.0,
                     f"lambda={spec.lam:.4f};"
                     f"consensus_rounds={_rounds_to_consensus(spec)};"
                     f"deg={int(spec.graph.degrees().max())}"))
    return rows


def arms(*, smoke: bool = False, device=None, capture: bool = True):
    """(name, result) of the non-IID accuracy arms, ring against torus
    at m 16 (smoke: ring4 against torus2x2)."""
    m, k, b, rounds = ((SMOKE_M, SMOKE_K, SMOKE_B, SMOKE_ROUNDS) if smoke
                       else (M, K, B, ROUNDS))
    data = classification_dataset(n=600 if smoke else 6000, seed=0)
    side = int(np.sqrt(m))
    for name, spec in ((f"ring{m}", MixingSpec.ring(m)),
                       (f"torus{side}x{m // side}",
                        MixingSpec.torus(side, m // side))):
        r = train_dfedavgm_2nn(m=m, K=k, batch=b, rounds=rounds, iid=False,
                               data=data, topology=spec, mixer="auto",
                               device=device, capture=capture)
        yield f"topology/noniid_acc/{name}", dict(
            r, derived=f"acc={r['acc']:.3f}")


def run(*, smoke: bool = False, device=None):
    """The runner's entry: the spectral-gap rows of each topology, then its
    training arms, as CSV rows."""
    return lambda_rows() + [(name, r["us_per_round"], r["derived"])
                            for name, r in arms(smoke=smoke, device=device)]
