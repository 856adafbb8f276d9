"""The 90th percentile of every round's time in the window (host clock,
from handing in the round's batch to a synchronize after ``run``)."""
import statistics


def read(run):
    if len(run.round_s) < 2:
        return None
    return statistics.quantiles([t * 1e3 for t in run.round_s], n=10)[-1]
