"""Device ms a round in every kernel, copy and fill that is neither a
matmul nor one of the port's hand-written kernels."""


def read(run):
    t = run.trace
    if t is None or "torch_other" not in t.group_s:
        return None
    return t.group_s["torch_other"] * 1e3 / t.rounds
