"""B3 (``momentum_sgd``, the heavy-ball step): the least time
its work a round needs (``harness/yardstick.py``) over its device time
a round, %."""


def read(run):
    t = run.trace
    if t is None or t.group_s.get("b3", 0.0) <= 0.0:
        return None
    return 100.0 * run.counts["b3_least_s"] / (t.group_s["b3"] / t.rounds)
