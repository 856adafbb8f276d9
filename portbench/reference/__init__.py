"""The plain reference the benchmark holds the program to: a model family a
module (``<family>.py``, its ``loss(params, tokens, targets, cfg, prec)``),
the DFedAvgM round (``dfedavgm.py``), the precisions it computes in
(``precision.py``) and a frozen Threefry (``threefry.py``).

Plain PyTorch in float32 with TF32 off. It imports nothing of the program
and takes nothing the program made: the benchmark hands both sides the
same weights, batches and key, and the reference works the rounds out
again. Leaves are named and shaped as the benchmark lays its inputs out:
a family's layers stacked on a leading axis under ``stages/0/``.
"""
from __future__ import annotations

import importlib


def family(name: str):
    """The reference module of model family ``name``
    (``portbench/reference/<name>.py``)."""
    return importlib.import_module(f"{__name__}.{name}")
