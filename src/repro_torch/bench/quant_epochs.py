"""Figs 2-5: communication bits {32,16,8,4} x local epochs {1,2,5}, IID and
Non-IID — accuracy is (nearly) bit-independent; K helps IID only. The
reference's ``benchmarks/bench_quant_epochs.py`` on the port."""
from __future__ import annotations

from ..data import classification_dataset
from ..device import resolve_device
from .common import train_dfedavgm_2nn

ROUNDS = 25
M = 16
SMOKE_M, SMOKE_ROUNDS = 4, 2


def arms(*, smoke: bool = False, device=None, capture: bool = True):
    """(name, result of ``train_dfedavgm_2nn`` with the CSV ``derived``
    string) for each arm, in the reference's row order."""
    dev = resolve_device(device)
    m, rounds = (SMOKE_M, SMOKE_ROUNDS) if smoke else (M, ROUNDS)
    data = classification_dataset(n=8000, seed=0)
    for iid in (True, False):
        tag = "iid" if iid else "noniid"
        for bits in (32, 16, 8, 4):
            r = train_dfedavgm_2nn(m=m, K=4, rounds=rounds, bits=bits,
                                   iid=iid, data=data, device=dev,
                                   capture=capture)
            yield (f"fig2345/{tag}/bits{bits}",
                   dict(r, derived=f"acc={r['acc']:.3f}"))
        for K in (1, 2, 5):
            r = train_dfedavgm_2nn(m=m, K=K, rounds=rounds, bits=16,
                                   iid=iid, data=data, device=dev,
                                   capture=capture)
            yield (f"fig2345/{tag}/K{K}",
                   dict(r, derived=f"acc={r['acc']:.3f}"))


def run(*, smoke: bool = False, device=None):
    """The runner's entry: Figs 2-5's quantized arms over epochs as CSV rows
    (name, us a round, derived); ``smoke`` runs them small."""
    return [(name, r["us_per_round"], r["derived"])
            for name, r in arms(smoke=smoke, device=device)]
