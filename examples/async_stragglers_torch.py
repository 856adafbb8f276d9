"""Async gossip on the PyTorch/CUDA port: 8 clients, one 10x straggler,
no round barrier — the demo of ``examples/async_stragglers.py`` through
the port's library API.

Each client draws its compute time from a straggler-tailed speed model
and mixes the moment it finishes; neighbours still computing contribute
their last published parameters, downweighted by how stale they are. The
event log shows the seven fast clients gossiping while client 0 surfaces
rarely. Then the same queue runs through ``make_async_engine``: on the
card each event is one replay of a captured CUDA graph, bitwise with the
event loop. Run:

    PYTHONPATH=src python examples/async_stragglers_torch.py            # GPU
    PYTHONPATH=src python examples/async_stragglers_torch.py --device cpu
"""
import argparse

import torch

from repro_torch import prng
from repro_torch.core import (AsyncConfig, DFedAvgMConfig, MixingSpec,
                              SpeedModel, average_params, init_async_state,
                              make_async_engine, make_round_step)
from repro_torch.data import FederatedDataset, classification_dataset
from repro_torch.models.paper_nets import apply_2nn, init_2nn, softmax_xent

M_CLIENTS, K, BATCH = 8, 2, 32


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--events", type=int, default=96)
    args = ap.parse_args()
    dev = torch.device(args.device)

    data = classification_dataset(n=4000, d=784, seed=0)
    fed = FederatedDataset.make(data, M_CLIENTS, iid=True)

    def loss_fn(params, batch, rng):
        return softmax_xent(apply_2nn(params, batch["x"]), batch["y"])

    params = init_2nn(0, device=dev)
    stacked = {n: t.unsqueeze(0).expand((M_CLIENTS,) + t.shape).contiguous()
               for n, t in params.items()}
    spec = MixingSpec.ring(M_CLIENTS, self_weight=0.5)
    cfg = DFedAvgMConfig(eta=0.05, theta=0.9, local_steps=K)
    acfg = AsyncConfig(speed=SpeedModel.straggler(
        mean=1.0, sigma=0.4, frac=1.0 / M_CLIENTS, factor=10.0),
        max_staleness=8)

    # Single events through the round-step API, to log each one...
    event = make_round_step(loss_fn, cfg, spec, device=dev, async_cfg=acfg)
    state = init_async_state(stacked, prng.PRNGKey(1), acfg.speed)
    batches = [fed.round_batches(t, K=K, batch=BATCH, device=dev)
               for t in range(args.events)]
    print(f"straggler set: clients 0..{acfg.speed.n_stragglers(M_CLIENTS) - 1}"
          f" ({acfg.speed.straggler_factor:.0f}x slower)")
    for t, b in enumerate(batches):
        before = state.version
        state, metrics = event(state, b)
        if t % 8 == 0 or t == args.events - 1:
            finished = torch.nonzero(state.version != before).flatten()
            print(f"event {t:3d}  t={float(state.clock):6.2f}  "
                  f"finished={finished.tolist()}  "
                  f"max_staleness={int(metrics['max_staleness'])}  "
                  f"loss={float(metrics['loss']):.4f}")

    avg = average_params(state.params)
    x = torch.from_numpy(data.x).to(dev)
    y = torch.from_numpy(data.y).to(dev)
    with torch.no_grad():
        acc = (apply_2nn(avg, x).argmax(-1) == y).float().mean()
    print(f"consensus-model accuracy after {args.events} events "
          f"(virtual t={float(state.clock):.1f}): {float(acc):.3f}")

    # ...and the same queue through the engine (captured on the card).
    engine = make_async_engine(loss_fn, cfg, spec, acfg, device=dev,
                               capture=True)
    state2, _ = engine(init_async_state(stacked, prng.PRNGKey(1), acfg.speed),
                       {n: torch.stack([b[n] for b in batches])
                        for n in batches[0]})
    same = all(torch.equal(state.params[n], state2.params[n])
               for n in state.params)
    print(f"the engine reproduces the event loop bit for bit: {same}")


if __name__ == "__main__":
    main()
