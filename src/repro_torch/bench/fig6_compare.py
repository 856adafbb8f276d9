"""Fig. 6: DFedAvgM vs FedAvg vs DSGD — accuracy per round AND per bit;
the reference's ``benchmarks/bench_fig6_compare.py`` on the port.

Derived metric: accuracy @ fixed rounds + total/bottleneck comm MB.
``arms`` yields each arm's full result (losses, times, bits), ``run``
the CSV rows.
"""
from __future__ import annotations

from .. import prng
from ..core import (DSGDConfig, FedAvgConfig, MixingSpec, average_params,
                    bottleneck_bits, dfedavgm_round_bits, dsgd_round_bits,
                    fedavg_round_bits, init_round_state, make_dsgd_step,
                    make_fedavg_step)
from ..data import FederatedDataset, classification_dataset
from ..device import resolve_device
from .common import (acc_2nn, loss_2nn, run_rounds, stacked_2nn,
                     train_dfedavgm_2nn)

M, K, B, ROUNDS = 16, 4, 32, 30
SMOKE_M, SMOKE_ROUNDS = 4, 2


def arms(*, smoke: bool = False, device=None, capture: bool = True):
    """(name, result) for the three arms; a result holds ``acc``,
    ``loss``, ``first_loss``, ``consensus_dist``, ``us_per_round``,
    ``capture_s``, ``comm_bits`` and the CSV ``derived`` string."""
    dev = resolve_device(device)
    m, rounds = (SMOKE_M, SMOKE_ROUNDS) if smoke else (M, ROUNDS)
    data = classification_dataset(n=8000, seed=0)
    fed = FederatedDataset.make(data, m, iid=True)

    r = train_dfedavgm_2nn(m=m, K=K, batch=B, rounds=rounds, data=data,
                           device=dev, capture=capture)
    d = r["d"]
    bits = dfedavgm_round_bits(r["spec"].graph, d) * rounds
    bneck = bottleneck_bits("dfedavgm", d, graph=r["spec"].graph) * rounds
    yield "fig6/dfedavgm", dict(
        r, comm_bits=bits, derived=f"acc={r['acc']:.3f};"
        f"commMB={bits/8e6:.0f};bottleneckMB={bneck/8e6:.1f}")

    # FedAvg
    step = make_fedavg_step(loss_2nn, FedAvgConfig(
        eta=0.05, theta=0.9, local_steps=K), m, device=dev)
    st = init_round_state(stacked_2nn(m, 0, dev), prng.PRNGKey(1))
    r = run_rounds(step, st, lambda t: fed.round_batches(
        t, K=K, batch=B, device="cpu"), rounds, capture=capture)
    acc = acc_2nn(average_params(r["state"].params), data)
    bits = fedavg_round_bits(m, d) * rounds
    bneck = bottleneck_bits("fedavg", d, m=m) * rounds
    yield "fig6/fedavg", dict(
        r, acc=acc, loss=float(r["metrics"]["loss"]),
        consensus_dist=float(r["metrics"]["consensus_dist"]), comm_bits=bits,
        derived=f"acc={acc:.3f};commMB={bits/8e6:.0f};"
        f"bottleneckMB={bneck/8e6:.1f}")

    # DSGD (1 grad step / round; give it the same wall budget in rounds)
    spec = MixingSpec.ring(m)
    step = make_dsgd_step(loss_2nn, DSGDConfig(gamma=0.1), spec, device=dev)
    st = init_round_state(stacked_2nn(m, 0, dev), prng.PRNGKey(1))
    r = run_rounds(step, st, lambda t: fed.round_batches(
        t, K=1, batch=B, device="cpu"), rounds * K, capture=capture)
    acc = acc_2nn(average_params(r["state"].params), data)
    bits = dsgd_round_bits(spec.graph, d) * rounds * K
    yield "fig6/dsgd", dict(
        r, acc=acc, loss=float(r["metrics"]["loss"]),
        consensus_dist=float(r["metrics"]["consensus_dist"]), comm_bits=bits,
        derived=f"acc={acc:.3f};commMB={bits/8e6:.0f}")


def run(*, smoke: bool = False, device=None):
    """The runner's entry: Fig. 6's arms (quantized against full-precision
    DFedAvgM) as CSV rows (name, us a round, derived); ``smoke`` runs them
    small."""
    return [(name, r["us_per_round"], r["derived"])
            for name, r in arms(smoke=smoke, device=device)]
