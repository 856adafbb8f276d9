"""Device ms a round in matmul kernels (cuBLAS and CUTLASS)."""


def read(run):
    t = run.trace
    if t is None or "matmul" not in t.group_s:
        return None
    return t.group_s["matmul"] * 1e3 / t.rounds
