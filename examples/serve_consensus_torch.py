"""Serve the consensus model with batched requests on the PyTorch/CUDA
port: prefill + greedy decode (KV caches / SSM states as appropriate for
the arch) — ``examples/serve_consensus.py`` through
``repro_torch.launch.serve``.

  PYTHONPATH=src python examples/serve_consensus_torch.py --arch mamba2-780m
  PYTHONPATH=src python examples/serve_consensus_torch.py --device cpu
"""
import argparse

from repro_torch.launch.serve import main as serve_main

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()
    device = [] if args.device is None else ["--device", args.device]
    serve_main(["--arch", args.arch, "--batch", "4",
                "--prompt-len", "32", "--gen", "16"] + device)
