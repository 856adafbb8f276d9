"""Quickstart on the PyTorch/CUDA port: DFedAvgM with 8-bit gossip.

16 clients on a ring train the paper's 2NN on a synthetic 10-class
problem — the configuration of ``examples/quickstart.py``, through the
port's library API. The round runs the CUDA kernels (encode, decode-mix,
heavy-ball update; with ``--fuse-round`` the fused encode and decode that
fold in the last two local steps) on the card, each round one replay of a
CUDA graph captured around the round step (``capture_step``, the port's
counterpart of the reference's ``jax.jit``); on the CPU the step runs
eagerly. Run:

    PYTHONPATH=src python examples/quickstart_torch.py            # GPU
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
    PYTHONPATH=src python examples/quickstart_torch.py --fuse-round
"""
import argparse

import torch

from repro_torch import prng
from repro_torch.core import (DFedAvgMConfig, MixingSpec, QuantConfig,
                              average_params, capture_step,
                              init_round_state, make_round_step)
from repro_torch.data import FederatedDataset, classification_dataset
from repro_torch.models.paper_nets import apply_2nn, init_2nn, softmax_xent

M_CLIENTS, K, BATCH = 16, 4, 32


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--fuse-round", action="store_true")
    args = ap.parse_args()
    dev = torch.device(args.device)

    data = classification_dataset(n=8000, d=784, seed=0)
    fed = FederatedDataset.make(data, M_CLIENTS, iid=True)

    def loss_fn(params, batch, rng):
        return softmax_xent(apply_2nn(params, batch["x"]), batch["y"])

    params = init_2nn(0, device=dev)
    stacked = {n: t.unsqueeze(0).expand((M_CLIENTS,) + t.shape).contiguous()
               for n, t in params.items()}

    spec = MixingSpec.ring(M_CLIENTS, self_weight=0.5)  # PSD ring
    cfg = DFedAvgMConfig(eta=0.05, theta=0.9, local_steps=K,
                         quant=QuantConfig(bits=8),
                         fuse_round=args.fuse_round)
    step = make_round_step(loss_fn, cfg, spec, device=dev)
    state = init_round_state(stacked, prng.PRNGKey(1))

    for t in range(args.rounds):
        batches = fed.round_batches(t, K=K, batch=BATCH, device=dev)
        if t == 0 and dev.type == "cuda":
            step = capture_step(step, state, batches)
        state, metrics = step(state, batches)
        if t % 10 == 0 or t == args.rounds - 1:
            print(f"round {t:3d}  loss={float(metrics['loss']):.4f}  "
                  f"consensus={float(metrics['consensus_dist']):.2e}")

    avg = average_params(state.params)
    x = torch.from_numpy(data.x).to(dev)
    y = torch.from_numpy(data.y).to(dev)
    with torch.no_grad():
        acc = (apply_2nn(avg, x).argmax(-1) == y).float().mean()
    print(f"consensus-model accuracy: {float(acc):.3f}")


if __name__ == "__main__":
    main()
