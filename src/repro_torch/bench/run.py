"""Bench runner of the port: the paper's figures, one module each.
Prints ``name,us_per_call,derived`` CSV, as the reference's
``benchmarks/run.py`` does, and exits non-zero if a bench failed.

    python -m repro_torch.bench.run [--only fig6,quant] [--smoke]
                                    [--device cpu|cuda]

``--smoke`` runs every bench at tiny scale (m 4, 2 rounds). On the card
(the default) every round is one CUDA graph replay, TF32 is off, as the
reference's f32 matmuls and convolutions are IEEE, and cuDNN keeps to
deterministic algorithms (one with atomics in its weight gradient would
make a captured round differ from the eager one); ``--device cpu`` runs
the rounds eagerly on the CPU.
"""
from __future__ import annotations

import argparse
import importlib
import sys
import traceback

import torch

MODULES = [
    "fig6_compare",     # Fig 6: vs FedAvg / DSGD (rounds & bits)
    "quant_epochs",     # Figs 2-5: bits x local epochs, IID/non-IID
    "cnn",              # Fig 8: the CNN, local epochs
    "charlm",           # Fig 7: the char-LSTM, fp32 vs 8-bit wire
    "topology",         # ring vs torus: lambda, consensus, non-IID acc
    "timevarying",      # time-varying schedules vs the static ring
    "async_compare",    # async vs sync under stragglers (bench_async)
    "pool",             # virtual client pool: rounds/s vs m (bench_pool)
    "mia",              # §6 MIA privacy probe (bench_mia)
    "comm_cost",        # Prop 3 table per assigned arch (bench_comm_cost)
    "kernels",          # kernel microbench (bench_kernels)
    "roofline",         # dry-run roofline table (bench_roofline)
]


def main(argv=None) -> int:
    """Run the benches named by ``--only`` (every module by default) on
    ``--device``, captured on the card, printing ``name,us_per_call,derived``
    rows; returns the exit code."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None,
                    help="comma-separated bench module suffixes")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny configs, 2 rounds: entrypoint sanity only")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    mods = MODULES if not args.only else [
        m for m in MODULES if any(s in m for s in args.only.split(","))]
    print("name,us_per_call,derived")
    failed = []
    for mod in mods:
        try:
            m = importlib.import_module(f"repro_torch.bench.{mod}")
            for name, us, derived in m.run(smoke=args.smoke,
                                           device=args.device):
                print(f"{name},{us:.1f},{derived}", flush=True)
        except Exception as e:  # noqa: BLE001 — report, run the next bench
            failed.append(mod)
            traceback.print_exc()
            print(f"{mod},NaN,FAILED:{e!r}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
