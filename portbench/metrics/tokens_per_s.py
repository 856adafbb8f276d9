"""All tokens every client trained in the window's rounds, over the
window's seconds (host clock)."""


def read(run):
    return run.counts["tokens_per_round"] * len(run.round_s) / run.window_s
