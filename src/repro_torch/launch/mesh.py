"""Device-memory sizing of the pooled runner's lanes — the one part of the
JAX package's ``launch/mesh.py`` that one card needs
(``resident_lane_capacity``). The client and production meshes, the
2D ``(clients, model)`` layout and the hardware constants of the TPU
roofline belong to the multi-card port (ROADMAP A17).
"""
from __future__ import annotations

import torch

from ..device import resolve_device

CPU_BUDGET_BYTES = 2 << 30


def resident_lane_capacity(bytes_per_client: int,
                           budget_bytes: int | None = None,
                           overhead: float = 4.0,
                           model_parallel: int = 1, device=None) -> int:
    """How many client lanes fit device memory — the pooled-execution
    sizing heuristic (``--resident-lanes`` defaults from this).

    ``bytes_per_client`` is one client's parameter bytes; ``overhead``
    budgets the working set per lane (params + momentum + grads + update
    temporaries ~= 4x params). ``budget_bytes`` defaults to the card's
    free memory (``torch.cuda.mem_get_info``) on ``device`` (CUDA unless
    ``"cpu"``), or 2 GiB on the CPU. ``model_parallel > 1`` (a 2D mesh)
    is the multi-card port's (ROADMAP A17) and raises. Always returns at
    least 1.
    """
    if model_parallel != 1:
        raise NotImplementedError(
            f"model_parallel={model_parallel}: the (clients, model) mesh is "
            "not ported yet (ROADMAP A17)")
    if budget_bytes is None:
        dev = resolve_device(device)
        budget_bytes = (torch.cuda.mem_get_info(dev)[0]
                        if dev.type == "cuda" else CPU_BUDGET_BYTES)
    return max(1, int(budget_bytes / (overhead * bytes_per_client)))
