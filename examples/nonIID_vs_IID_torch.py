"""The paper's central qualitative finding (Figs 2-6) on the PyTorch/CUDA
port: DFedAvgM matches FedAvg per ROUND on IID data but lags on non-IID
label-shard data, while communicating far fewer bits; quantization
barely hurts. The configuration of ``examples/nonIID_vs_IID.py`` (16
clients on a ring, the 2NN, K 4, batch 32, 50 rounds): DFedAvgM at 32
and 8 bits against FedAvg, each printing accuracy, loss and comm MB. On
the card each round is one replay of a captured CUDA graph
(``capture_step``); on the CPU the step runs eagerly. Run:

    PYTHONPATH=src python examples/nonIID_vs_IID_torch.py            # GPU
    PYTHONPATH=src python examples/nonIID_vs_IID_torch.py --device cpu
"""
import argparse

import torch

from repro_torch import prng
from repro_torch.core import (DFedAvgMConfig, FedAvgConfig, MixingSpec,
                              QuantConfig, average_params, capture_step,
                              dfedavgm_round_bits, fedavg_round_bits,
                              init_round_state, make_fedavg_step,
                              make_round_step)
from repro_torch.data import FederatedDataset, classification_dataset
from repro_torch.models.paper_nets import apply_2nn, init_2nn, softmax_xent

M, K, B = 16, 4, 32


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=50)
    args = ap.parse_args()
    dev = torch.device(args.device)
    data = classification_dataset(n=8000, d=784, seed=0)
    x_all = torch.from_numpy(data.x).to(dev)
    y_all = torch.from_numpy(data.y).to(dev)

    def loss_fn(p, batch, rng):
        return softmax_xent(apply_2nn(p, batch["x"]), batch["y"])

    def accuracy(p) -> float:
        with torch.no_grad():
            return float((apply_2nn(p, x_all).argmax(-1) == y_all)
                         .float().mean())

    for iid in (True, False):
        fed = FederatedDataset.make(data, M, iid=iid)
        spec = MixingSpec.ring(M, self_weight=0.5)
        runs = {
            "DFedAvgM-32b": make_round_step(loss_fn, DFedAvgMConfig(
                eta=0.05, theta=0.9, local_steps=K), spec, device=dev),
            "DFedAvgM-8b": make_round_step(loss_fn, DFedAvgMConfig(
                eta=0.05, theta=0.9, local_steps=K,
                quant=QuantConfig(bits=8)), spec, device=dev),
            "FedAvg": make_fedavg_step(loss_fn, FedAvgConfig(
                eta=0.05, theta=0.9, local_steps=K), M, device=dev),
        }
        print(f"\n===== {'IID' if iid else 'Non-IID'} =====")
        for name, step in runs.items():
            p0 = init_2nn(0, device=dev)
            st = init_round_state(
                {n: t.unsqueeze(0).expand((M,) + t.shape).contiguous()
                 for n, t in p0.items()}, prng.PRNGKey(1))
            for t in range(args.rounds):
                batches = fed.round_batches(t, K=K, batch=B, device=dev)
                if t == 0 and dev.type == "cuda":
                    step = capture_step(step, st, batches)
                st, mt = step(st, batches)
            d = sum(x.numel() for x in p0.values())
            bits = (fedavg_round_bits(M, d) if name == "FedAvg" else
                    dfedavgm_round_bits(spec.graph, d,
                                        QuantConfig(bits=8) if "8b" in name
                                        else None)) * args.rounds
            print(f"{name:14s} acc={accuracy(average_params(st.params)):.3f} "
                  f"loss={float(mt['loss']):.3f} comm={bits/8/1e6:.0f}MB")


if __name__ == "__main__":
    main()
