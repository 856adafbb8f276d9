"""The paper's own experimental models (§6), PyTorch port — the 2NN.

  2NN — MLP, 2 hidden layers x 200 ReLU units (199,210 params on 784->10
        MNIST-shaped data)

Parameters are plain dicts in the JAX package's layout (weights
``[d_in, d_out]``, applied as ``x @ w``). Every function also takes a
leading client axis on both params and inputs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import resolve_device
from .layers import dense_init

Params = dict[str, torch.Tensor]


def init_2nn(generator: torch.Generator | int, *, d_in: int = 784,
             d_hidden: int = 200, n_classes: int = 10,
             dtype=torch.float32, device=None) -> Params:
    """2NN parameters drawn from ``generator`` (or a seed) on the CPU,
    then placed on ``device`` (CUDA unless ``"cpu"`` is given)."""
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator().manual_seed(generator)
    params = {
        "w1": dense_init(generator, (d_in, d_hidden), dtype),
        "b1": torch.zeros((d_hidden,), dtype=dtype),
        "w2": dense_init(generator, (d_hidden, d_hidden), dtype),
        "b2": torch.zeros((d_hidden,), dtype=dtype),
        "w3": dense_init(generator, (d_hidden, n_classes), dtype),
        "b3": torch.zeros((n_classes,), dtype=dtype),
    }
    return {n: t.to(dev) for n, t in params.items()}


def apply_2nn(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x [..., B, d_in] -> logits [..., B, n_classes]; a leading client
    axis on params (w [m, d_in, d_out], b [m, d_out]) batches clients."""
    h = F.relu(x @ params["w1"] + params["b1"].unsqueeze(-2))
    h = F.relu(h @ params["w2"] + params["b2"].unsqueeze(-2))
    return h @ params["w3"] + params["b3"].unsqueeze(-2)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the batch axis: logits [..., B, C], labels
    [..., B] -> [...] (a scalar without leading axes, as in JAX)."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -logp.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
    return nll.mean(dim=-1)


def count_params(params: Params) -> int:
    return sum(int(p.numel()) for p in params.values())
