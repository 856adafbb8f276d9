"""B1 (``quantize_pack_buffer``, the keyed 8-bit encode): the least time
its work a round needs (``harness/yardstick.py``) over its device time
a round, %."""


def read(run):
    t = run.trace
    if t is None or t.group_s.get("b1", 0.0) <= 0.0:
        return None
    return 100.0 * run.counts["b1_least_s"] / (t.group_s["b1"] / t.rounds)
