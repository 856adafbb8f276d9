"""The system under test: the port's round, built as its users build it.

``make_round_step(make_loss(arch), DFedAvgMConfig(eta, theta, K,
QuantConfig(bits)), MixingSpec.ring(m, self_weight))`` on the state's
device, captured by ``capture_step`` (three eager warm-ups on a side
stream, then one CUDA graph a round; a CPU round runs eagerly). This is
the only module of the benchmark that imports the port, and it takes
from it the round, the configuration's registered architecture and its
leaves' names and shapes.
"""
from __future__ import annotations

import dataclasses

import torch


def arch_config(config: dict):
    """The port's registered architecture, with the configuration's
    ``port.set`` applied; raises where a field differs from
    ``port.expect``."""
    from repro_torch.configs import get_config

    port = config["port"]
    arch = dataclasses.replace(get_config(port["registered"]),
                               **port.get("set", {}))
    wrong = {k: (getattr(arch, k), v) for k, v in port["expect"].items()
             if getattr(arch, k) != v}
    if wrong:
        raise ValueError(f"the port's {port['registered']} differs from "
                         f"the configuration: {wrong}")
    return arch


def leaf_shapes(arch) -> dict:
    """Leaf name -> (shape, dtype) of one client's parameters, from the
    port's init on ``meta`` (nothing allocated)."""
    from repro_torch.models.model import init_model

    meta = init_model(torch.zeros(2, dtype=torch.int64, device="meta"), arch,
                      device="meta")
    return {n: (tuple(t.shape), t.dtype) for n, t in meta.items()}


def loss_for(arch):
    from repro_torch.models.model import make_loss
    return make_loss(arch)


def spec_for(mix: dict):
    from repro_torch.core import MixingSpec
    if mix["topology"] != "ring":
        raise ValueError(f"unknown topology {mix['topology']!r}")
    return MixingSpec.ring(mix["clients"], self_weight=mix["self_weight"])


def build_step(arch, mix: dict, device):
    """The round step."""
    from repro_torch.core import DFedAvgMConfig, QuantConfig, make_round_step

    spec = spec_for(mix)
    cfg = DFedAvgMConfig(eta=mix["eta"], theta=mix["theta"],
                         local_steps=mix["local_steps"],
                         quant=QuantConfig(bits=mix["bits"]))
    return make_round_step(loss_for(arch), cfg, spec, device=device)


def initial_state(params: dict, key: torch.Tensor):
    from repro_torch.core import init_round_state
    return init_round_state(params, key)


def capture(step, state, batch):
    """``run(state, batch) -> (state', metrics)``: the round as one CUDA
    graph replay, or the eager step on the CPU."""
    dev = next(iter(state.params.values())).device
    if dev.type != "cuda":
        return step
    from repro_torch.core import capture_step
    return capture_step(step, state, batch)
