"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object: ``correct``, ``attempted`` (rounds in the window), ``failed``
(rounds whose loss is not finite), ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checked``: each number compared
for ``correct`` with its limit, which also close standard error. Exits
non-zero, printing no result, without a card (or with fewer than the cell
asks for), without the port under ``src/``, or where a module of JAX or of
the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"
# Every kernel cache at a fixed path inside the checkout (the port's own
# nvcc builds go to src/repro_torch/_build/, also inside it).
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch
    from portbench.harness.bench import Bench
    from portbench.harness import cell as cells

    bench = Bench()
    chips = bench.cell(args.workload)["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); found "
              f"{found}", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the port is not importable from {ROOT / 'src'}: "
              f"{e}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result, notes, checked = cells.run_cell(
        bench, args.workload, args.seed, args.seconds, bool(args.trace),
        torch.device("cuda", 0), T_START)
    bad = cells.forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or the JAX package were loaded: "
              f"{bad}", file=sys.stderr)
        return 3
    for line in notes:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    for line in checked:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
