"""The readings that a cell's limits are set from, in one process: the
program against the reference on every seed given (the lower readings),
and on the first ``--faulty`` of them the control and the planted faults
against the reference (the upper readings).

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 \\
        [--faulty 3] [--device cuda]

Arms: ``program`` (the port's captured check rounds), ``control`` (the
reference computing its products in fp8), ``half_batch`` (the reference
with each loss over half its batch) and ``no_exchange`` (the reference
with W = I). A state left unchanged reads 1 in both change numbers by
their measure and needs no run. Prints one JSON line an arm and seed,
then each arm's largest and smallest reading of each number.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FAULTS = {"control": {"precision": "fp8"},
          "half_batch": {"half_batch": True},
          "no_exchange": {"no_exchange": True}}


def readings(bench, name: str, seeds: list[int], faulty: int, device,
             arms=tuple(FAULTS), out=sys.stdout) -> dict:
    """Arm -> [numbers of each seed] (module docstring)."""
    import torch
    from portbench.harness import check, inputs, program
    from portbench.harness.cell import Cell, check_rounds

    cell = Cell(bench, name, device)
    step = program.build_step(cell.arch, cell.mix, cell.device)
    run, kept = None, {}
    for seed in seeds:
        x0 = cell.weights(seed)
        key = inputs.round_key(seed, cell.device)
        data = cell.batches(seed)
        if run is None:
            run = program.capture(step, program.initial_state(x0, key),
                                  data.next())
        _, prog, batches = check_rounds(run, x0, key, data,
                                        check.CHECK_ROUNDS)
        kept[seed] = (prog, batches)
        del x0
    del run, step
    gc.collect()
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    out_arms: dict[str, list] = {}
    for i, seed in enumerate(seeds):
        prog, batches = kept[seed]
        t0 = time.perf_counter()
        ref = cell.reference(seed, batches)
        print(f"reference {time.perf_counter() - t0:.3f} s", file=sys.stderr)
        sides = {"program": prog}
        if i < faulty:
            sides.update({arm: cell.reference(seed, batches, **FAULTS[arm])
                          for arm in arms})
        for arm, side in sides.items():
            nums = check.numbers(side, ref)
            out_arms.setdefault(arm, []).append(nums)
            print(json.dumps({"arm": arm, "seed": seed, **nums,
                              "losses": side["losses"],
                              "reference_losses": ref["losses"]}),
                  file=out, flush=True)
    return out_arms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faulty", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arms", default=",".join(FAULTS),
                    help="the arms read on the first --faulty seeds")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from portbench.harness.bench import Bench
    from portbench.harness.check import NUMBERS

    torch.set_num_threads(2)
    arms = readings(Bench(), args.workload,
                    [int(s) for s in args.seeds.split(",")], args.faulty,
                    torch.device(args.device), args.arms.split(","))
    for arm, rows in arms.items():
        print(json.dumps({"arm": arm, "seeds": len(rows), **{
            k: {"max": max(r[k] for r in rows), "min": min(r[k] for r in rows)}
            for k in NUMBERS}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
