"""The virtual client pool on the PyTorch/CUDA port: 100 000 logical
clients of the paper's 2NN, a cohort of 64 on the device each round —
the port's counterpart of the README's

    python -m repro.launch.train --pool --clients 100000 \\
        --schedule partial --resident-lanes 64

Every client lives in a host store (copy-on-write: a client that never
trained reads the shared init and holds no memory); each round draws its
exact cohort on the structural ring, fetches it through a pinned staging
buffer, trains K heavy-ball steps on the cohort's lanes and gossips at
cohort width on the plan realization with the 8-bit wire, and writes the
cohort back. The next round's cohort is drawn, gathered and copied while
this one trains; on the card the step is one CUDA graph replay. A
client's batches are rows of the synthetic MNIST-like set drawn by
``prng.randint`` from ``fold_in(fold_in(key, client), round)``. Run:

    PYTHONPATH=src python examples/pool_torch.py                    # GPU
    PYTHONPATH=src python examples/pool_torch.py --device cpu --rounds 3
"""
import argparse
import time

import torch

from repro_torch import prng
from repro_torch.core import (ClientPool, DFedAvgMConfig, PoolSchedule,
                              PooledRunner, QuantConfig)
from repro_torch.data import classification_dataset
from repro_torch.models.paper_nets import apply_2nn, init_2nn, softmax_xent

K, BATCH = 4, 32


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--clients", type=int, default=100_000)
    ap.add_argument("--resident-lanes", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--bits", type=int, default=8)
    args = ap.parse_args()
    dev = torch.device(args.device)

    data = classification_dataset(n=8000, d=784, seed=0)
    xs, ys = torch.from_numpy(data.x).to(dev), torch.from_numpy(data.y).to(dev)
    key = prng.PRNGKey(0, device=dev)

    def batch_fn(ids, t):
        keys = prng.fold_in(prng.fold_in(key, ids), t)
        rows = prng.randint(keys, (K, BATCH), 0, xs.shape[0]).long()
        return {"x": xs[rows], "y": ys[rows]}

    def loss_fn(params, batch, rng):
        return softmax_xent(apply_2nn(params, batch["x"]), batch["y"])

    psched = PoolSchedule.ring_partial(args.clients,
                                       args.resident_lanes / args.clients)
    cfg = DFedAvgMConfig(eta=0.05, theta=0.9, local_steps=K,
                         quant=QuantConfig(bits=args.bits))
    pool = ClientPool(init_2nn(0, device="cpu"), args.clients)
    runner = PooledRunner(pool, psched, loss_fn, cfg, batch_fn,
                          key=prng.PRNGKey(1), backend="sparse", device=dev)
    print(f"{psched.name}: {pool.n_params} params a client, "
          f"{runner.bits_per_round / 8e6:.3f} MB billed a round")
    t0 = time.perf_counter()
    for t in range(args.rounds):
        metrics = runner.round()
        print(f"round {t:3d}  loss={float(metrics['loss']):.4f}  "
              f"materialized={pool.materialized}  "
              f"host={pool.nbytes / 2 ** 20:.0f} MB")
    wall = time.perf_counter() - t0
    print(f"{args.rounds / wall:.2f} rounds/s over {args.rounds} rounds "
          f"(the first captures the step on the card); consensus distance "
          f"over all {args.clients} clients {pool.consensus_distance():.3e}")


if __name__ == "__main__":
    main()
