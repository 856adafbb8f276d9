"""A round's model FLOPs (forward and backward, nothing recomputed;
``counts/<family>.py``) over the profiled rounds' mean wall time, as a
share of the card's published bf16 peak, %."""
from portbench.harness.yardstick import BF16_FLOPS


def read(run):
    t = run.trace
    if t is None or t.rounds == 0:
        return None
    per_round = t.window_s / t.rounds
    return 100.0 * run.counts["flops_per_round"] / per_round / BF16_FLOPS
