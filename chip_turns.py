#!/usr/bin/env python3
"""The eager quickstart round of two trees of this repo, in turns on one
CUDA card.

    python3 chip_turns.py PARENT_DIR [CHANGE_DIR]

CHANGE_DIR defaults to this file's tree. This tree's ``chip_smoke.py``
is copied into each tree as ``chip_smoke_turns.py``: its
``eager_round_ms`` and ``host_groups`` use only the package's public
names, so imported there they time that tree's round. Four turns, one
process each, in the order parent, change, change, parent; each builds
its tree's kernels, then prints one JSON line with the tree, the card
(``nvidia-smi`` name and power limit), the eager round's host-clock ms
(median of rounds 2-12, unfused and fused, two passes) and its host time
by group. Exits non-zero if a turn fails.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TURN = """
import json, sys, torch
sys.path.insert(0, "src")
import chip_smoke_turns as c
from repro_torch.kernels import native
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
native.build()
dev = torch.device("cuda:0")
rep = {"tree": sys.argv[1], "card": c.card_line(), **c.eager_round_ms(dev),
       "host_ms_by_group": c.host_groups(dev)}
print("TURN " + json.dumps(rep), flush=True)
"""


def main() -> int:
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    trees = {"parent": Path(sys.argv[1]).resolve(),
             "change": Path(sys.argv[2] if len(sys.argv) == 3
                            else ROOT).resolve()}
    for tree in trees.values():
        shutil.copy(ROOT / "chip_smoke.py", tree / "chip_smoke_turns.py")
    rc = 0
    for label in ("parent", "change", "change", "parent"):
        out = subprocess.run([sys.executable, "-c", TURN, label],
                             cwd=trees[label], capture_output=True,
                             text=True)
        lines = [ln[5:] for ln in out.stdout.splitlines()
                 if ln.startswith("TURN ")]
        if out.returncode or not lines:
            print(f"turn {label} failed:\n{out.stderr[-3000:]}",
                  file=sys.stderr)
            rc = 1
            continue
        print(json.dumps(json.loads(lines[-1])), flush=True)
    for tree in trees.values():
        (tree / "chip_smoke_turns.py").unlink()
    return rc


if __name__ == "__main__":
    sys.exit(main())
