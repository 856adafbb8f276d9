"""Fig. 8 analogue: the paper's CNN on an image-classification task
(CIFAR-like synthetic, IID), the effect of local epochs — the reference's
``benchmarks/bench_cnn.py`` on the port. 16x16 images, a 16-bit wire on
the dense mixer (the per-leaf noise drawn by T2 on the card)."""
from __future__ import annotations

from .. import prng
from ..core import (DFedAvgMConfig, MixingSpec, QuantConfig, average_params,
                    init_round_state, make_round_step)
from ..data import FederatedDataset, classification_dataset
from ..device import resolve_device
from ..models.paper_nets import init_cnn
from .common import acc_cnn, loss_cnn, run_rounds, stacked

M, B, ROUNDS, IMG = 4, 8, 20, 16
SMOKE_ROUNDS = 2


def arms(*, smoke: bool = False, device=None, capture: bool = True):
    """(name, result) for K = 1 and 2; a result holds ``acc``, ``loss``,
    ``first_loss``, ``consensus_dist``, ``us_per_round``, ``capture_s``,
    ``graph`` and the CSV ``derived`` string."""
    dev = resolve_device(device)
    rounds = SMOKE_ROUNDS if smoke else ROUNDS
    data = classification_dataset(n=800, image=True, img_side=IMG,
                                  noise=1.0, seed=0)
    fed = FederatedDataset.make(data, M, iid=True)
    for K in (1, 2):
        step = make_round_step(loss_cnn, DFedAvgMConfig(
            eta=0.03, theta=0.9, local_steps=K, quant=QuantConfig(bits=16),
            mixer_impl="dense"), MixingSpec.ring(M, self_weight=0.5),
            device=dev)
        st = init_round_state(
            stacked(init_cnn(0, in_ch=3, img=IMG, device=dev), M),
            prng.PRNGKey(1))
        r = run_rounds(step, st, lambda t: fed.round_batches(
            t, K=K, batch=B, device="cpu"), rounds, capture=capture)
        acc = acc_cnn(average_params(r["state"].params), data.x[:256],
                      data.y[:256])
        loss = float(r["metrics"]["loss"])
        yield f"fig8/cnn/K{K}", dict(
            r, acc=acc, loss=loss,
            consensus_dist=float(r["metrics"]["consensus_dist"]),
            derived=f"acc={acc:.3f};loss={loss:.3f}")


def run(*, smoke: bool = False, device=None):
    """The runner's entry: Fig. 8's CNN arms as CSV rows (name, us a round,
    derived); ``smoke`` runs them small."""
    return [(name, r["us_per_round"], r["derived"])
            for name, r in arms(smoke=smoke, device=device)]
