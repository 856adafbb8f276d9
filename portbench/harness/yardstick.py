"""The work a round needs, counted from the cell's shapes alone (its
configuration and traffic mix), and the card's published peaks: so a
share reads the same work whatever implements the kernel.

Peaks: NVIDIA H100 SXM data sheet (dense, no sparsity), at its 700 W
power limit: 989e12 bf16 FLOP/s, 3.35e12 HBM bytes/s. The INT32 rate is
worked out from the Hopper architecture: 132 SMs x 64 INT32 lanes a
clock (16 in each of an SM's four partitions) x 1.98e9 clocks/s (the
largest SM clock) = 16.73e12 operations/s.

Threefry-2x32 a draw (``reference/threefry.py``): 20 rounds of an add,
a rotate and an xor (60 operations; a rotate is one funnel shift), 6 key
injections of two adds each (12; the injection counter folds into the
key words), and 3 to turn the two words into a float's bits (an xor, a
shift, an or): 75 integer operations.

Least time of a kernel's work a round: the larger of its bytes over the
HBM rate (each input read once and each output written once, at its
dtype) and its operations over their rate.
  B3 (``momentum_sgd``): K steps x m clients x every stored value: y, v,
     g in and y', v' out (5 values of the leaf's dtype).
  B1 (``quantize_pack_buffer``): m x n values: the f32 delta in, the
     ``bits``-wide level out; one Threefry draw a value.
  B2 (``dequant_mix_buffer``): m x n values: the f32 base and the level
     in, the f32 mixed value out.
Per-leaf scales, keys, weights and tables are below 0.05 % of these and
left out.
"""
from __future__ import annotations

BF16_FLOPS = 989e12
HBM_BYTES = 3.35e12
SM_COUNT, INT32_LANES, SM_HZ = 132, 64, 1.98e9
INT32_OPS = SM_COUNT * INT32_LANES * SM_HZ
THREEFRY_OPS = 20 * 3 + 6 * 2 + 3
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def counts(family, config: dict, mix: dict) -> dict:
    """A round's model FLOPs and each kernel's least seconds (module
    docstring); ``family`` is the configuration's counts module."""
    m, k = mix["clients"], mix["local_steps"]
    tokens = m * k * mix["batch"] * mix["seq"]
    values = family.params_by_dtype(config)
    n = sum(values.values())
    terms = family.flops_terms(config, mix["seq"])
    level = mix["bits"] / 8
    b3_bytes = k * m * sum(5 * DTYPE_BYTES[d] * v for d, v in values.items())
    b1_bytes = m * n * (4 + level)
    b1_ops = m * n * THREEFRY_OPS
    b2_bytes = m * n * (4 + level + 4)
    return {
        "tokens_per_round": tokens,
        "params_per_client": n,
        "flops_per_token": terms,
        "flops_per_round": sum(terms.values()) * tokens,
        "b1_least_s": max(b1_bytes / HBM_BYTES, b1_ops / INT32_OPS),
        "b2_least_s": b2_bytes / HBM_BYTES,
        "b3_least_s": b3_bytes / HBM_BYTES,
        "b1_bytes": b1_bytes, "b1_ops": b1_ops, "b2_bytes": b2_bytes,
        "b3_bytes": b3_bytes,
    }
