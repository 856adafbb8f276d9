"""B2 (``dequant_mix_buffer``, the gossip's decode-mix): the least time
its work a round needs (``harness/yardstick.py``) over its device time
a round, %."""


def read(run):
    t = run.trace
    if t is None or t.group_s.get("b2", 0.0) <= 0.0:
        return None
    return 100.0 * run.counts["b2_least_s"] / (t.group_s["b2"] / t.rounds)
