"""Device selection for the port's entry points: they run on the card
unless the caller asks for the CPU, and never move to the CPU silently."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``. Raises when CUDA is asked for and there
    is no card. A CUDA device comes back with its index (the current one
    when none was given), so it compares equal to its tensors' device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to "
                           "run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
