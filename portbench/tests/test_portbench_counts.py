"""The yardstick's counts against hand-worked numbers, and against the
port's own leaves (an init on ``meta``) for the stored values."""
from __future__ import annotations

import math

import pytest
import torch

from portbench.harness import program, yardstick
from portbench.harness.bench import Bench

BENCH = Bench()


def _counts(cell: str) -> dict:
    spec = BENCH.cell(cell)
    config = BENCH.config(spec)
    return yardstick.counts(BENCH.counts(config["family"]), config,
                            BENCH.mix(spec))


def test_smollm_flops_and_bytes():
    c = _counts("smollm135m.q8.k4")
    # a layer's q, k, v, o and SwiGLU: 331 776 + 221 184 + 331 776 +
    # 2 654 208; 30 layers and the tied head 49 152 x 576
    assert c["flops_per_token"] == {"matmul": 6 * 134_479_872,
                                    "attention": 12 * 30 * 128 * 9 * 64}
    assert sum(c["flops_per_token"].values()) == 833_421_312
    assert c["flops_per_round"] == 833_421_312 * 16_384
    assert c["params_per_client"] == 134_515_008
    assert c["b3_bytes"] == 4 * 8 * 134_515_008 * 10
    assert c["b1_bytes"] == 8 * 134_515_008 * 5
    assert c["b1_ops"] == 8 * 134_515_008 * 75
    assert c["b2_bytes"] == 8 * 134_515_008 * 9
    assert yardstick.INT32_OPS == 16_727_040_000_000
    assert c["b1_least_s"] == pytest.approx(80_709_004_800 / 16.72704e12)
    assert c["b3_least_s"] == pytest.approx(43_044_802_560 / 3.35e12)


def test_gossip_heavy_cell_keeps_the_per_parameter_work():
    k1, k4 = _counts("smollm135m.q8.k1"), _counts("smollm135m.q8.k4")
    assert k1["tokens_per_round"] * 16 == k4["tokens_per_round"]
    assert k1["b1_bytes"] == k4["b1_bytes"]
    assert k1["b2_bytes"] == k4["b2_bytes"]
    assert k1["b3_bytes"] * 4 == k4["b3_bytes"]


def test_mamba2_flops_and_bytes():
    c = _counts("mamba2-780m.q8.k2")
    # projections 2*1536*3072 + 2*1536*128 + 1536*48 + 3072*1536 a layer,
    # 12 layers and the tied head 50 280 x 1536
    assert c["flops_per_token"]["matmul"] == 6 * 252_702_720
    # SSD at chunk 128: 2*128*128 + 3 * 2*128*48*64 + 2*48*128*64/128
    assert c["flops_per_token"]["ssd"] == 3 * 12 * 2_398_208
    assert c["flops_per_round"] == 1_602_551_808 * 8_192
    assert c["params_per_client"] == 252_921_024
    assert c["b3_bytes"] == 2 * 4 * (252_919_296 * 10 + 1_728 * 20)
    assert c["b1_bytes"] == 4 * 252_921_024 * 5
    assert c["b1_ops"] == 4 * 252_921_024 * 75
    assert c["b2_bytes"] == 4 * 252_921_024 * 9


@pytest.mark.parametrize("cell", ["smollm135m.q8.k4", "mamba2-780m.q8.k2"])
def test_stored_values_are_the_ports_leaves(cell):
    spec = BENCH.cell(cell)
    config = BENCH.config(spec)
    shapes = program.leaf_shapes(program.arch_config(config))
    by_dtype: dict = {}
    for shape, dtype in shapes.values():
        name = str(dtype).removeprefix("torch.")
        by_dtype[name] = by_dtype.get(name, 0) + math.prod(shape)
    assert by_dtype == BENCH.counts(config["family"]).params_by_dtype(config)
    assert all(d in (torch.bfloat16, torch.float32)
               for _, d in shapes.values())
