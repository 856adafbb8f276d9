"""Seconds from the process's start to the first timed round: imports,
the CUDA context, the kernels built or loaded, the weights, the capture's
warm-ups and the check rounds."""


def read(run):
    return run.setup_s
