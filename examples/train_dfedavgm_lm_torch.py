"""End-to-end driver on the PyTorch/CUDA port: train a (reduced)
registered-architecture LM with DFedAvgM on synthetic data, comparing
32-bit and 8-bit quantized gossip — ``examples/train_dfedavgm_lm.py``
through ``repro_torch.launch.train``.

  PYTHONPATH=src python examples/train_dfedavgm_lm_torch.py --arch smollm-135m
  PYTHONPATH=src python examples/train_dfedavgm_lm_torch.py --device cpu \
      --rounds 3
(Any of the 10 registered archs works: --arch mamba2-780m, mixtral-8x22b...)
"""
import argparse

from repro_torch.launch.train import main as train_main

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()
    device = [] if args.device is None else ["--device", args.device]
    for bits in (32, 8):
        print(f"\n=== {args.arch} bits={bits} ===")
        train_main(["--arch", args.arch, "--rounds", str(args.rounds),
                    "--clients", "8", "--batch", "4", "--seq", "128",
                    "--bits", str(bits)] + device)
