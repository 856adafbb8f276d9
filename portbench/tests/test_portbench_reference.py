"""The reference against the port on the CPU at a reduced size: the frozen
Threefry bitwise, each family's loss and gradients in float32, and whole
quantized rounds (bf16 state, the same stochastic-rounding noise) within
the tiny cells' limits."""
from __future__ import annotations

import time

import pytest
import torch

from portbench.harness import cell as cells
from portbench.harness import inputs, program
from portbench.reference import family, threefry
from portbench.reference.precision import F32
from portbench.tests import tiny


def test_threefry_is_the_ports():
    from repro_torch import prng

    for seed in (0, 7, 2 ** 31 + 5):
        key = inputs.round_key(seed, "cpu")
        assert torch.equal(threefry.split(key, 33), prng.split_plain(key, 33))
        assert torch.equal(threefry.uniform(key, 1000),
                           prng.uniform_plain(key, (1000,)))


@pytest.mark.parametrize("name", ["smollm.tiny", "mamba2.tiny"])
def test_family_loss_and_gradients_are_the_ports(tmp_path, name):
    from repro_torch.models.model import loss_fn

    bench = tiny.make(tmp_path)
    cell = cells.Cell(bench, name, "cpu")
    cell.config["torch_dtype"] = "float32"
    arch = program.arch_config({**cell.config, "port": {
        **cell.config["port"],
        "set": {**cell.config["port"]["set"], "dtype": "float32"},
        "expect": {}}})
    shapes = {n: (s, torch.float32) for n, (s, _) in
              program.leaf_shapes(arch).items()}
    params = inputs.weights(shapes, cell.config["init"], 3, 1, "cpu")
    ids = torch.randint(0, cell.config["vocab_ids"], (2, cell.mix["seq"] + 1),
                        generator=torch.Generator().manual_seed(0))
    tok, tgt = ids[:, :-1], ids[:, 1:]
    p = {n: t[0].clone().requires_grad_(True) for n, t in params.items()}
    ours = family(cell.config["family"]).loss(p, tok, tgt, cell.config,
                                              F32)
    g_ours = torch.autograd.grad(ours, list(p.values()))
    q = {n: t.clone().requires_grad_(True) for n, t in params.items()}
    port = loss_fn(q, arch, {"tokens": tok[None], "targets": tgt[None]})[0]
    g_port = torch.autograd.grad(port, list(q.values()))
    assert float(ours.detach()) == pytest.approx(float(port.detach()),
                                                 rel=1e-5)
    for n, a, b in zip(p, g_ours, g_port):
        scale = float(b.abs().max()) + 1e-12
        assert float((a - b).abs().max()) <= 2e-4 * scale, n


@pytest.mark.parametrize("name", ["smollm.tiny", "mamba2.tiny"])
def test_rounds_agree_with_the_program(tmp_path, name):
    bench = tiny.make(tmp_path)
    result, notes, lines = cells.run_cell(bench, name, 2 ** 31 + 11, 0.2,
                                          False, "cpu", time.perf_counter())
    assert result["correct"], lines
    assert result["checked"]["loss_gap"]["value"] < 1e-4
