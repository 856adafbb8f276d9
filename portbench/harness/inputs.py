"""The inputs a run makes from its ``--seed``, on the device: the weights
(one client's, copied to every client), the round's key and each round's
token batch. The same seed gives the same inputs; both the program and
the reference are handed them.

Weights: the configuration's ``init`` rules by leaf name (the leaves'
names and shapes are the program's layout, read from an init on
``meta``), drawn with one ``torch.Generator`` on the device seeded from
the seed: every ``normal`` leaf from one standard-normal draw scaled a
leaf, then the special leaves (``ones``, a log-uniform ``A``, a ``dt``
bias) in sorted-name order, each in its leaf's dtype.

Batches: each round ``randint(0, vocab_ids)`` of [m, K, b, l + 1] from a
second generator; the tokens are the first l ids of each row, the
targets the next-token ids.
"""
from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF


def generator(seed: int, stream: int, device) -> torch.Generator:
    """Stream ``stream`` (0: weights, 1: batches) of ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(2 * seed + stream)
    return g


def rule_of(name: str, init: dict) -> dict | str:
    """The init rule of leaf ``name``: its longest matching suffix's."""
    best = None
    for suffix in init:
        if name == suffix or name.endswith("/" + suffix):
            if best is None or len(suffix) > len(best):
                best = suffix
    if best is None:
        raise KeyError(f"no init rule for leaf {name!r}")
    return init[best]


def _special(rule: dict, shape, dtype, g, device) -> torch.Tensor:
    if "log_uniform_a" in rule:         # A_log = log(U[lo, hi])
        lo, hi = rule["log_uniform_a"]
        u = torch.rand(shape, generator=g, device=device)
        return torch.log(lo + (hi - lo) * u).to(dtype)
    if "dt_bias" in rule:               # softplus^-1 of a log-uniform dt
        lo, hi, floor = rule["dt_bias"]
        u = torch.rand(shape, generator=g, device=device)
        dt = torch.exp(math.log(lo) + (math.log(hi) - math.log(lo)) * u)
        dt = dt.clamp(min=floor)
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    raise ValueError(f"unknown init rule {rule!r}")


def weights(shapes: dict, init: dict, seed: int, m: int,
            device) -> dict:
    """Every leaf [m, ...] in its dtype, the m clients alike. ``shapes``:
    name -> (shape, dtype)."""
    g = generator(seed, 0, device)
    names = sorted(shapes)
    normal = [n for n in names if isinstance(rule_of(n, init), dict)
              and "normal" in rule_of(n, init)]
    sizes = [math.prod(shapes[n][0]) for n in normal]
    draw = torch.randn(sum(sizes), generator=g, device=device)
    std = torch.repeat_interleave(
        torch.tensor([rule_of(n, init)["normal"] for n in normal],
                     device=device),
        torch.tensor(sizes, device=device))
    draw.mul_(std)
    one = {}
    for n, part in zip(normal, torch.split(draw, sizes)):
        one[n] = part.reshape(shapes[n][0]).to(shapes[n][1])
    del draw, std
    for n in names:
        if n in one:
            continue
        rule = rule_of(n, init)
        shape, dtype = shapes[n]
        if rule == "ones":
            one[n] = torch.ones(shape, dtype=dtype, device=device)
        else:
            one[n] = _special(rule, shape, dtype, g, device)
    return {n: one[n].unsqueeze(0).expand((m,) + tuple(one[n].shape))
            .contiguous() for n in names}


def round_key(seed: int, device) -> torch.Tensor:
    """The round loop's first key: the seed's two 32-bit words, int64 [2]."""
    return torch.tensor([(seed >> 32) & MASK32, seed & MASK32],
                        dtype=torch.int64, device=device)


class Batches:
    """Each round's batch: tokens and targets int64 [m, K, b, l]."""

    def __init__(self, seed: int, mix: dict, vocab_ids: int, device):
        self.g = generator(seed, 1, device)
        self.shape = (mix["clients"], mix["local_steps"], mix["batch"],
                      mix["seq"] + 1)
        self.vocab = vocab_ids
        self.device = device

    def next(self) -> dict:
        ids = torch.randint(0, self.vocab, self.shape, generator=self.g,
                            device=self.device)
        return {"tokens": ids[..., :-1].contiguous(),
                "targets": ids[..., 1:].contiguous()}
