"""The comparison that decides ``correct``: the program's first
``CHECK_ROUNDS`` rounds against the reference's from the same weights,
batches and key. Every limit under ``portbench/limits/`` was set from
readings of three rounds, so the number of rounds is fixed here, not by a
cell.

The numbers (a cell's limits file names those it compares):
  loss_gap     each round's loss, |program - reference| / |reference|, the
               worst round;
  update1_gap  each leaf's norm of the first round's change x1 - x0 (every
               client), |program - reference| over the larger of the
               reference's norm of that leaf and of the median leaf, the
               worst leaf;
  change_gap   the same for the change over all the rounds compared;
  update1_median_gap  the same gap for each client's part of each leaf
               (over the larger of its reference norm and the median
               part's), the median over every client and leaf: steady
               from seed to seed where the worst leaf swings.
Leaves whose first gradient (round 1, step 1, every client) is below a
thousandth of the median leaf's in the reference are left out of the
changes: they move by round-off alone.
"""
from __future__ import annotations

import math
import statistics

NUMBERS = ("loss_gap", "update1_gap", "change_gap", "update1_median_gap")
CHECK_ROUNDS = 3
ROUNDOFF_LEAF = 1e-3


def counted(grad_norms: dict) -> list:
    med = statistics.median(grad_norms.values())
    return sorted(n for n, g in grad_norms.items()
                  if g >= ROUNDOFF_LEAF * med)


def leaf_gaps(prog: dict, ref: dict, leaves: list) -> dict:
    """Each key's gap of norms over the larger of its reference norm and
    the median key's."""
    med = statistics.median(ref[n] for n in leaves)
    out = {}
    for n in leaves:
        base, gap = max(ref[n], med), abs(prog[n] - ref[n])
        out[n] = gap / base if base > 0 else (0.0 if gap == 0 else math.inf)
    return out


def whole(client_norms: dict) -> dict:
    """Leaf -> its norm over every client, from its norms a client."""
    return {n: math.hypot(*v) for n, v in client_norms.items()}


def parts(client_norms: dict) -> dict:
    """(leaf, client) -> that client's norm of the leaf."""
    return {(n, c): v for n, vs in client_norms.items()
            for c, v in enumerate(vs)}


def numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: each round's loss and each leaf's norms a
    client of the first round's change and the whole change (``ref`` also
    its first gradients'), as ``reference.dfedavgm.rounds`` returns them."""
    leaves = counted(ref["grad_norms"])
    loss = max(abs(p - r) / abs(r) if math.isfinite(p) else math.inf
               for p, r in zip(prog["losses"], ref["losses"]))
    update1 = leaf_gaps(whole(prog["update1"]), whole(ref["update1"]),
                        leaves)
    change = leaf_gaps(whole(prog["change"]), whole(ref["change"]), leaves)
    each = [(n, c) for n in leaves for c in range(len(ref["update1"][n]))]
    update1_parts = leaf_gaps(parts(prog["update1"]), parts(ref["update1"]),
                              each)
    return {"loss_gap": loss,
            "update1_gap": max(update1.values()),
            "change_gap": max(change.values()),
            "update1_median_gap": statistics.median(update1_parts.values()),
            "worst_leaves": [max(update1, key=update1.get),
                             max(change, key=change.get)],
            "leaves_left_out": sorted(set(ref["grad_norms"]) - set(leaves))}


def judge(nums: dict, limits: dict) -> tuple[bool, dict]:
    """(every number that ``limits`` names within its limit, {name:
    {value, limit}})."""
    if not limits or set(limits) - set(NUMBERS):
        raise ValueError(f"limits must name some of {NUMBERS}: {limits}")
    shown = {k: {"value": nums[k], "limit": limits[k]} for k in NUMBERS
             if k in limits}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in shown.values())
    return ok, shown
