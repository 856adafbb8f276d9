#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. print the card (``nvidia-smi`` name and power limit) and versions;
2. build the CUDA sources in ``src/repro_torch/csrc`` (timed, one nvcc
   per source, all in parallel);
3. hold every kernel against its plain PyTorch version on the card at the
   shapes its path gives it — B1-B5 at the quickstart's wire shapes (2NN,
   m=16, ring, 8 and 4 bits), B6-B8 on one client's flat 2NN vector —
   packed words bitwise equal, floats within MAX_ULP (bitwise is
   expected: the kernels pin rounding with _rn intrinsics and keep the
   plain version's operation order); time kernel and plain version with
   CUDA events;
4. one quickstart round on the card against the same round on the CPU,
   and the plan realization against the dense one on the card, for the
   unfused and the fused round;
5. drive three paths through the library API, each with every launch
   counter set to 0 just before and read just after: the quickstart
   round (2NN 784-200-200-10, 16 clients on a ring with self-weight 0.5,
   K=4, batch 32, eta=0.05, theta=0.9, 8-bit stochastic lemma5 gossip)
   for ROUNDS rounds, unfused (B1, B2, B3) and fused (B3, B4, B5); then
   the per-tensor ``ops`` entry points once each (B6, B7, B8, B3);
   check the counts, a finite falling loss and the ops against the CPU;
6. profile both rounds (device busy and idle share, time by kernel);
7. print the kernel table as one JSON line, then the card again, then
   ``{"ok": true, "device": {...}}`` as the last line.

It needs one CUDA card and exits non-zero without one.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

M, K, BATCH, ROUNDS = 16, 4, 32, 12
ETA, THETA = 0.05, 0.9
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
F32_OPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
MAX_ULP = 2                  # stated float bound kernel vs plain
REPS, WARMUP = 20, 3
SLEEP_CYCLES = 4_000_000     # ~2 ms of GPU clock: covers the host enqueue
KERNEL_SOURCES = {
    "quantize_pack_buffer": ("src/repro_torch/csrc/quantize_pack.cu",
                             "src/repro/kernels/quantize_pack.py:48"),
    "dequant_mix_buffer": ("src/repro_torch/csrc/dequant_mix.cu",
                           "src/repro/kernels/dequant_mix.py:100"),
    "momentum_sgd": ("src/repro_torch/csrc/momentum_sgd.cu",
                     "src/repro/kernels/momentum_sgd.py:45"),
    "momentum_quantize_pack_buffer": (
        "src/repro_torch/csrc/quantize_pack.cu",
        "src/repro/kernels/quantize_pack.py:121"),
    "dequant_mix_momentum_buffer": ("src/repro_torch/csrc/dequant_mix.cu",
                                    "src/repro/kernels/dequant_mix.py:163"),
    "quantize_pack": ("src/repro_torch/csrc/quantize_pack.cu",
                      "src/repro/kernels/quantize_pack.py:166"),
    "dequant_mix_plan": ("src/repro_torch/csrc/dequant_mix.cu",
                         "src/repro/kernels/dequant_mix.py:203"),
    "dequant_mix": ("src/repro_torch/csrc/dequant_mix.cu",
                    "src/repro/kernels/dequant_mix.py:232"),
}
# The path whose launch counts each kernel's row reports.
KERNEL_PATH = {"quantize_pack_buffer": "unfused",
               "dequant_mix_buffer": "unfused", "momentum_sgd": "unfused",
               "momentum_quantize_pack_buffer": "fused",
               "dequant_mix_momentum_buffer": "fused", "quantize_pack": "ops",
               "dequant_mix_plan": "ops", "dequant_mix": "ops"}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ulp_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in f32 units in the last place."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    if a.numel() == 0:
        return 0
    return int((ordered(a) - ordered(b)).abs().max())


def time_ms(fn, flush: torch.Tensor) -> tuple[float, float]:
    """(device ms, call ms) of one call, medians over REPS.

    Device: the L2 is flushed, then the stream is held busy
    (``torch.cuda._sleep``) while the host enqueues the call between two
    events, so the events time the call's kernels alone, not the host's
    Python and launch overhead. Call: the same events with the stream
    idle, so the host's launch path is in the time."""
    for _ in range(WARMUP):
        fn()
    dev, call = [], []
    for _ in range(REPS):
        for held, out in ((True, dev), (False, call)):
            flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if held:
                torch.cuda._sleep(SLEEP_CYCLES)
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
    return statistics.median(dev), statistics.median(call)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(n_bytes: int, n_ops: int) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def quickstart_setup(dev, fuse_round: bool = False):
    from repro_torch.core import (DFedAvgMConfig, MixingSpec, QuantConfig,
                                  make_round_step)
    from repro_torch.data import FederatedDataset, classification_dataset
    from repro_torch.models.paper_nets import (apply_2nn, init_2nn,
                                               softmax_xent)

    data = classification_dataset(n=8000, d=784, seed=0)
    fed = FederatedDataset.make(data, M, iid=True)
    params = init_2nn(0, device=dev)
    stacked = {n: t.unsqueeze(0).expand((M,) + t.shape).contiguous()
               for n, t in params.items()}
    spec = MixingSpec.ring(M, self_weight=0.5)
    cfg = DFedAvgMConfig(eta=ETA, theta=THETA, local_steps=K,
                         quant=QuantConfig(bits=8), fuse_round=fuse_round)

    def loss_fn(p, b, rng):
        return softmax_xent(apply_2nn(p, b["x"]), b["y"])

    step = make_round_step(loss_fn, cfg, spec, device=dev)
    return data, fed, stacked, spec, cfg, loss_fn, step


def kernel_checks(dev, flush):
    """Phase 3: every kernel against its plain version at main-path
    shapes. Returns {kernel: record} with the main-path configuration's
    times and the largest error over all configurations."""
    from repro_torch import prng
    from repro_torch.core import MixingSpec, WireLayout
    from repro_torch.core.mixing import _quant_leaf_keys
    from repro_torch.core.quantize import QuantConfig
    from repro_torch.kernels import ref
    from repro_torch.kernels.dequant_mix import (dequant_mix_buffer,
                                                 dequant_mix_buffer_plain)
    from repro_torch.kernels.momentum_sgd import momentum_sgd
    from repro_torch.kernels.quantize_pack import quantize_pack_buffer
    from repro_torch.models.paper_nets import init_2nn

    gen = torch.Generator().manual_seed(1)
    shapes = {n: t.shape for n, t in init_2nn(0, device="cpu").items()}

    def stacked_randn(scale):
        return {n: (torch.randn((M,) + tuple(s), generator=gen) * scale)
                .to(dev) for n, s in shapes.items()}

    x = stacked_randn(0.05)
    z = {n: t + 0.01 * torch.randn(t.shape, generator=gen).to(dev)
         for n, t in x.items()}
    plan = MixingSpec.ring(M, self_weight=0.5).gossip_plan()
    src = torch.tensor(np.stack([np.arange(M), plan.src[0], plan.src[1]]),
                       dtype=torch.int32, device=dev)
    w = torch.tensor(np.stack([plan.w_self, plan.w_steps[0],
                               plan.w_steps[1]], 1), dtype=torch.float32,
                     device=dev)
    key = prng.PRNGKey(3)
    rec = {k: {"max_abs_err": 0.0, "max_ulp": 0, "checks": []}
           for k in KERNEL_SOURCES}

    for bits, stochastic in ((8, True), (8, False), (4, True)):
        quant = QuantConfig(bits=bits, stochastic=stochastic)
        layout = WireLayout.for_tree(x, bits, stacked=True)
        X = layout.to_planar_stacked(x)
        delta = layout.to_planar_stacked({n: z[n] - x[n] for n in x})
        sblk = layout.block_scales(layout.leaf_scales(delta, quant))
        noise = (layout.noise_stacked(
            _quant_leaf_keys(key, layout.n_leaves, M).to(dev))
            if stochastic else None)
        words = quantize_pack_buffer(delta, sblk, bits, noise)
        words_ref = ref.quantize_pack_buffer_ref(delta, sblk, bits, noise)
        torch.cuda.synchronize()
        check_words(f"B1 bits={bits} stochastic={stochastic}", words,
                    words_ref)
        r = rec["quantize_pack_buffer"]
        r["checks"].append(f"bits={bits} stochastic={stochastic} "
                           f"shape={list(delta.shape)} words bitwise")
        if (bits, stochastic) == (8, True):
            n_el = delta.numel()
            r["ms"], r["call_ms"] = time_ms(lambda: quantize_pack_buffer(
                delta, sblk, bits, noise), flush)
            r["plain_ms"], r["plain_call_ms"] = time_ms(
                lambda: ref.quantize_pack_buffer_ref(delta, sblk, bits,
                                                     noise), flush)
            r["bound_ms"], r["bound_by"] = bound(
                nbytes(delta, sblk, noise, words), 8 * n_el)
            r["shape"] = list(delta.shape)

        if not stochastic:
            continue
        out = dequant_mix_buffer(X, words, sblk, w, src, bits)
        out_ref = dequant_mix_buffer_plain(X, words, sblk, w, src, bits)
        torch.cuda.synchronize()
        r = rec["dequant_mix_buffer"]
        check_floats(r, f"B2 bits={bits}", [(out, out_ref)])
        r["checks"].append(f"bits={bits} K=3 shape={list(X.shape)} "
                           f"max_ulp={r['max_ulp']}")
        if bits == 8:
            r["ms"], r["call_ms"] = time_ms(lambda: dequant_mix_buffer(
                X, words, sblk, w, src, bits), flush)
            r["plain_ms"], r["plain_call_ms"] = time_ms(
                lambda: dequant_mix_buffer_plain(X, words, sblk, w, src,
                                                 bits), flush)
            r["bound_ms"], r["bound_by"] = bound(
                nbytes(X, words, sblk, w, src, out),
                X.numel() * 3 * src.shape[0])
            r["shape"] = list(X.shape)

    y = stacked_randn(0.05)
    v = stacked_randn(0.01)
    g = stacked_randn(0.1)
    r = rec["momentum_sgd"]
    outs = {n: momentum_sgd(y[n], v[n], g[n], ETA, THETA) for n in y}
    refs = {n: ref.momentum_sgd_ref(y[n], v[n], g[n], ETA, THETA) for n in y}
    torch.cuda.synchronize()
    for n in y:
        check_floats(r, f"B3 leaf {n}", zip(outs[n], refs[n]))
    n_el = sum(t.numel() for t in y.values())
    r["checks"].append(f"6 leaves x {M} clients = {n_el} values, "
                       f"max_ulp={r['max_ulp']}")
    r["ms"], r["call_ms"] = time_ms(
        lambda: [momentum_sgd(y[n], v[n], g[n], ETA, THETA) for n in y],
        flush)
    r["plain_ms"], r["plain_call_ms"] = time_ms(
        lambda: [ref.momentum_sgd_ref(y[n], v[n], g[n], ETA, THETA)
                 for n in y], flush)
    r["bound_ms"], r["bound_by"] = bound(5 * 4 * n_el, 3 * n_el)
    r["shape"] = f"one local step: 6 leaves x {M} clients ({n_el} f32)"
    fused_kernel_checks(dev, flush, rec, x, stacked_randn)
    ops_kernel_checks(dev, flush, rec)
    for name, r in rec.items():
        print(json.dumps({"check": name, **r}), flush=True)
    return rec


def check_floats(rec: dict, what: str, pairs) -> None:
    """Fail if any (kernel, plain) float pair is more than MAX_ULP apart;
    record the largest distance."""
    for a, b in pairs:
        ulp = ulp_diff(a, b)
        if ulp > MAX_ULP:
            raise AssertionError(f"{what}: {ulp} ulp from plain")
        rec["max_ulp"] = max(rec["max_ulp"], ulp)
        rec["max_abs_err"] = max(rec["max_abs_err"],
                                 float((a - b).abs().max()))


def check_words(what: str, got: torch.Tensor, want: torch.Tensor) -> None:
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"{what}: {bad} words differ from the plain "
                             "version")


def fused_kernel_checks(dev, flush, rec, x, stacked_randn):
    """B4 and B5 at the quickstart's wire shapes, the inputs the fused
    tail gives them: planar y, v, g of the penultimate step, the held x,
    per-leaf scales of the resulting delta, the lemma5 replica base."""
    from repro_torch import prng
    from repro_torch.core import MixingSpec, WireLayout
    from repro_torch.core.mixing import (_plan_tables, _quant_leaf_keys,
                                         _weighted_replica_base)
    from repro_torch.core.quantize import QuantConfig
    from repro_torch.kernels import ref
    from repro_torch.kernels.dequant_mix import (
        dequant_mix_momentum_buffer, dequant_mix_momentum_buffer_plain)
    from repro_torch.kernels.quantize_pack import (
        momentum_quantize_pack_buffer)

    et = (ETA, THETA)
    eta_f, theta_f = float(np.float32(ETA)), float(np.float32(THETA))
    y = {n: t + 0.01 * torch.randn_like(t) for n, t in x.items()}
    v, g, gk = stacked_randn(0.01), stacked_randn(0.1), stacked_randn(0.1)
    src, w = _plan_tables(MixingSpec.ring(M, self_weight=0.5).gossip_plan(),
                          dev)
    for bits, stochastic in ((8, True), (8, False), (4, True)):
        quant = QuantConfig(bits=bits, stochastic=stochastic)
        layout = WireLayout.for_tree(x, bits, stacked=True)
        X, Y, V, G, GK = (layout.to_planar_stacked(t)
                          for t in (x, y, v, g, gk))
        delta = (Y + (theta_f * V - eta_f * G)) - X
        sblk = layout.block_scales(layout.leaf_scales(delta, quant))
        noise = (layout.noise_stacked(
            _quant_leaf_keys(prng.PRNGKey(4), layout.n_leaves, M).to(dev))
            if stochastic else None)
        y_out, v_out, words = momentum_quantize_pack_buffer(
            Y, V, G, X, sblk, bits, et, noise)
        want = ref.momentum_quantize_pack_buffer_ref(Y, V, G, X, sblk, bits,
                                                     et, noise)
        torch.cuda.synchronize()
        what = f"B4 bits={bits} stochastic={stochastic}"
        check_words(what, words, want[2])
        r = rec["momentum_quantize_pack_buffer"]
        check_floats(r, what, zip((y_out, v_out), want[:2]))
        r["checks"].append(f"bits={bits} stochastic={stochastic} "
                           f"shape={list(Y.shape)} words bitwise, "
                           f"max_ulp={r['max_ulp']}")
        if (bits, stochastic) == (8, True):
            r["ms"], r["call_ms"] = time_ms(
                lambda: momentum_quantize_pack_buffer(Y, V, G, X, sblk, bits,
                                                      et, noise), flush)
            r["plain_ms"], r["plain_call_ms"] = time_ms(
                lambda: ref.momentum_quantize_pack_buffer_ref(
                    Y, V, G, X, sblk, bits, et, noise), flush)
            r["bound_ms"], r["bound_by"] = bound(
                nbytes(Y, V, G, X, noise, sblk, y_out, v_out, words),
                10 * Y.numel())
            r["shape"] = list(Y.shape)

        if not stochastic:
            continue
        base = _weighted_replica_base(X, w, src)
        out = dequant_mix_momentum_buffer(base, words, sblk, w, src, v_out,
                                          GK, et, bits)
        out_ref = dequant_mix_momentum_buffer_plain(base, words, sblk, w, src,
                                                    v_out, GK, et, bits)
        torch.cuda.synchronize()
        r = rec["dequant_mix_momentum_buffer"]
        check_floats(r, f"B5 bits={bits}", [(out, out_ref)])
        r["checks"].append(f"bits={bits} K=3 shape={list(X.shape)} "
                           f"max_ulp={r['max_ulp']}")
        if bits == 8:
            r["ms"], r["call_ms"] = time_ms(
                lambda: dequant_mix_momentum_buffer(
                    base, words, sblk, w, src, v_out, GK, et, bits), flush)
            r["plain_ms"], r["plain_call_ms"] = time_ms(
                lambda: dequant_mix_momentum_buffer_plain(
                    base, words, sblk, w, src, v_out, GK, et, bits), flush)
            r["bound_ms"], r["bound_by"] = bound(
                nbytes(base, words, sblk, w, src, v_out, GK, out),
                base.numel() * (3 * src.shape[0] + 4))
            r["shape"] = list(X.shape)


def ops_kernel_checks(dev, flush, rec):
    """B6, B7 and B8 on one client's flat 2NN vector (n = 199 210, 8 bits:
    planar [4, 50 176]; k = 3 streams), the inputs the ops entry points
    give them."""
    import torch.nn.functional as F

    from repro_torch import prng
    from repro_torch.kernels import ref
    from repro_torch.kernels.dequant_mix import dequant_mix, dequant_mix_plan
    from repro_torch.kernels.quantize_pack import quantize_pack
    from repro_torch.models.paper_nets import init_2nn

    gen = torch.Generator().manual_seed(2)
    flat = torch.cat([t.reshape(-1) for _, t in
                      sorted(init_2nn(0, device="cpu").items())])
    n = flat.numel()
    per, wd = ref.planar_pad_len(n, 8)
    delta = (0.01 * torch.randn(n, generator=gen)).to(dev)
    x2d = F.pad(delta, (0, per * wd - n)).reshape(per, wd)
    s = delta.abs().amax() / torch.full((), 127.0, device=dev)
    noise = prng.uniform(prng.PRNGKey(6).to(dev), (per, wd))
    r = rec["quantize_pack"]
    for nz in (noise, None):
        got = quantize_pack(x2d, s, 8, nz)
        check_words(f"B6 stochastic={nz is not None}", got,
                    ref.quantize_pack_ref(x2d, s, 8, nz))
        r["checks"].append(f"bits=8 stochastic={nz is not None} "
                           f"shape={list(x2d.shape)} words bitwise")
    words = quantize_pack(x2d, s, 8, noise)
    r["ms"], r["call_ms"] = time_ms(lambda: quantize_pack(x2d, s, 8, noise),
                                    flush)
    r["plain_ms"], r["plain_call_ms"] = time_ms(
        lambda: ref.quantize_pack_ref(x2d, s, 8, noise), flush)
    r["bound_ms"], r["bound_by"] = bound(nbytes(x2d, s, noise, words),
                                         8 * x2d.numel())
    r["shape"] = list(x2d.shape)

    xb = (torch.randn(per * wd, generator=gen) * 0.05).to(dev).reshape(
        per, wd)
    streams = torch.randint(-2 ** 31, 2 ** 31, (3, wd), generator=gen,
                            dtype=torch.int64).to(torch.int32).to(dev)
    scales = (torch.rand(3, generator=gen) * 1e-3).to(dev)
    weights = torch.tensor([0.5, 0.25, 0.25], device=dev)
    cases = {
        "dequant_mix_plan": (
            lambda: dequant_mix_plan(xb, streams, scales, weights, 8),
            lambda: ref.dequant_mix_plan_ref(xb, streams, scales, weights,
                                             8),
            (xb, streams, scales, weights)),
        "dequant_mix": (
            lambda: dequant_mix(xb, streams[0], streams[1], streams[2],
                                scales, 8, 0.5, 0.25),
            lambda: ref.dequant_mix_ref(xb, streams[0], streams[1],
                                        streams[2], scales, 8, 0.5, 0.25),
            (xb, streams, scales)),
    }
    for name, (kernel, plain, inputs) in cases.items():
        r = rec[name]
        out = kernel()
        check_floats(r, name, [(out, plain())])
        r["checks"].append(f"bits=8 k=3 shape={list(xb.shape)} "
                           f"max_ulp={r['max_ulp']}")
        r["ms"], r["call_ms"] = time_ms(kernel, flush)
        r["plain_ms"], r["plain_call_ms"] = time_ms(plain, flush)
        r["bound_ms"], r["bound_by"] = bound(nbytes(*inputs, out),
                                             9 * xb.numel())
        r["shape"] = list(xb.shape)


def expected_launches(fuse_round: bool, n_leaves: int) -> dict:
    """Launch counts of ROUNDS quickstart rounds: one encode and one
    decode a round, B3 once per leaf per applied local step (K unfused,
    K - 2 fused: B4 and B5 apply the last two)."""
    expect = {k: 0 for k in KERNEL_SOURCES}
    if fuse_round:
        expect.update(momentum_quantize_pack_buffer=ROUNDS,
                      dequant_mix_momentum_buffer=ROUNDS,
                      momentum_sgd=ROUNDS * (K - 2) * n_leaves)
    else:
        expect.update(quantize_pack_buffer=ROUNDS, dequant_mix_buffer=ROUNDS,
                      momentum_sgd=ROUNDS * K * n_leaves)
    return expect


def round_path(dev, fuse_round: bool):
    """Phase 5: ROUNDS quickstart rounds through the library API, with
    the launch counters read around exactly that run."""
    from repro_torch import prng
    from repro_torch.core import init_round_state
    from repro_torch.kernels import launch_counts, reset_launch_counts

    data, fed, stacked, spec, cfg, loss_fn, step = quickstart_setup(
        dev, fuse_round)
    batches = [fed.round_batches(t, K=K, batch=BATCH, device=dev)
               for t in range(ROUNDS)]
    state = init_round_state(stacked, prng.PRNGKey(1))
    torch.cuda.synchronize()
    reset_launch_counts()
    losses, cons, round_ms = [], [], []
    for t in range(ROUNDS):
        t0 = time.perf_counter()
        state, met = step(state, batches[t])
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(met["loss"]))
        cons.append(float(met["consensus_dist"]))
    counts = launch_counts()
    expect = expected_launches(fuse_round, len(stacked))
    name = "fused" if fuse_round else "unfused"
    print(json.dumps({"path": f"quickstart {name}", "rounds": ROUNDS,
                      "loss": losses, "consensus_dist": cons,
                      "round_ms": round_ms, "launches": counts,
                      "expected_launches": expect}), flush=True)
    if counts != expect:
        raise AssertionError(f"{name} launch counts {counts} != {expect}")
    if not all(math.isfinite(v) for v in losses + cons):
        raise AssertionError(f"{name}: non-finite loss or consensus")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: loss did not fall: {losses[0]} -> "
                             f"{losses[-1]}")
    for n, t in state.params.items():
        if t.shape != stacked[n].shape or not torch.isfinite(t).all():
            raise AssertionError(f"{name} leaf {n}: bad shape or non-finite")
    return counts, statistics.median(round_ms[1:]), losses


def ops_path(dev):
    """Phase 5: each per-tensor ``ops`` entry point once on one client's
    flat 2NN vector, with the launch counters read around exactly those
    calls; then the same calls on the CPU (plain versions) must agree:
    words and scale bitwise, floats within MAX_ULP."""
    from repro_torch import prng
    from repro_torch.kernels import (decode_apply_plan, decode_apply_ring,
                                     encode_delta, launch_counts,
                                     momentum_update_flat, ref,
                                     reset_launch_counts)

    gen = torch.Generator().manual_seed(3)
    n = 199210
    _, wd = ref.planar_pad_len(n, 8)
    x, delta, y, v, g = (torch.randn(n, generator=gen) * sc
                         for sc in (0.05, 0.01, 0.05, 0.01, 0.1))
    streams = torch.randint(-2 ** 31, 2 ** 31, (3, wd), generator=gen,
                            dtype=torch.int64).to(torch.int32)
    scales = torch.rand(3, generator=gen) * 1e-3
    weights = torch.tensor([0.5, 0.25, 0.25])
    key = prng.PRNGKey(8)

    def calls(d):
        t = [a.to(d) for a in (x, delta, y, v, g, streams, scales, weights)]
        xd, dd, yd, vd, gd, sd, scd, wtd = t
        return {"encode_delta": encode_delta(dd, 8, key=key),
                "decode_apply_ring": decode_apply_ring(
                    xd, sd[0], sd[1], sd[2], scd, bits=8, w_self=0.5,
                    w_nb=0.25),
                "decode_apply_plan": decode_apply_plan(xd, sd, scd, wtd,
                                                       bits=8),
                "momentum_update_flat": momentum_update_flat(yd, vd, gd, ETA,
                                                             THETA)}

    torch.cuda.synchronize()
    reset_launch_counts()
    got = calls(dev)
    torch.cuda.synchronize()
    counts = launch_counts()
    expect = {k: 0 for k in KERNEL_SOURCES}
    expect.update(quantize_pack=1, dequant_mix=1, dequant_mix_plan=1,
                  momentum_sgd=1)
    want = calls("cpu")
    words, s = got["encode_delta"]
    rep = {"path": "ops", "launches": counts, "expected_launches": expect,
           "encode_delta_bitwise": bool(
               torch.equal(words.cpu(), want["encode_delta"][0])
               and s.cpu().numpy().tobytes()
               == want["encode_delta"][1].numpy().tobytes()),
           "max_ulp_vs_cpu": {}}
    for name in ("decode_apply_ring", "decode_apply_plan",
                 "momentum_update_flat"):
        outs = got[name] if isinstance(got[name], tuple) else (got[name],)
        refs = want[name] if isinstance(want[name], tuple) else (want[name],)
        rep["max_ulp_vs_cpu"][name] = max(ulp_diff(a.cpu(), b)
                                          for a, b in zip(outs, refs))
    print(json.dumps(rep), flush=True)
    if counts != expect:
        raise AssertionError(f"ops launch counts {counts} != {expect}")
    if not rep["encode_delta_bitwise"]:
        raise AssertionError("encode_delta on the card differs from the CPU")
    if max(rep["max_ulp_vs_cpu"].values()) > MAX_ULP:
        raise AssertionError(f"ops entry points vs CPU: {rep}")
    return counts


def round_vs_cpu(dev, fuse_round: bool) -> tuple[dict, dict]:
    """One quickstart round on the card against the same round on the
    CPU (plain versions)."""
    from repro_torch import prng
    from repro_torch.core import init_round_state, make_round_step
    data, fed, stacked, spec, cfg, loss_fn, step = quickstart_setup(
        dev, fuse_round)
    b = fed.round_batches(0, K=K, batch=BATCH, device="cpu")
    s_gpu, m_gpu = step(init_round_state(stacked, prng.PRNGKey(1)),
                        {n: t.to(dev) for n, t in b.items()})
    step_cpu = make_round_step(loss_fn, cfg, spec, device="cpu")
    s_cpu, m_cpu = step_cpu(init_round_state(
        {n: t.cpu() for n, t in stacked.items()}, prng.PRNGKey(1)), b)
    loss_rel = abs(float(m_gpu["loss"]) / float(m_cpu["loss"]) - 1)
    cons_rel = abs(float(m_gpu["consensus_dist"])
                   / float(m_cpu["consensus_dist"]) - 1)
    far = sum(int(((s_gpu.params[n].cpu() - s_cpu.params[n]).abs()
                   > 1e-5).sum()) for n in stacked)
    total = sum(t.numel() for t in stacked.values())
    rep = {"loss_rel": loss_rel, "consensus_rel": cons_rel,
           "params_off_by_1e-5": far, "params": total}
    if loss_rel > 1e-5 or cons_rel > 1e-3 or far > 1e-3 * total:
        raise AssertionError(f"card round (fuse_round={fuse_round}) "
                             f"disagrees with CPU round: {rep}")
    return rep, s_gpu.params


def reference_checks(dev):
    """Phase 4, at full width: the unfused and the fused round on the
    card against the CPU; the plan mixer against the dense mixer, and
    the fused plan tail against the fused dense tail, on the card."""
    from repro_torch import prng
    from repro_torch.core import MixerConfig, make_mixer
    from repro_torch.core.local_sgd import local_train_deferred
    from repro_torch.core.mixing import make_fused_tail

    rep = {}
    rep["round_vs_cpu"], x = round_vs_cpu(dev, False)
    rep["fused_round_vs_cpu"], _ = round_vs_cpu(dev, True)
    data, fed, stacked, spec, cfg, loss_fn, step = quickstart_setup(dev)
    z = {n: t + 0.01 * torch.randn_like(t) for n, t in x.items()}
    key = prng.PRNGKey(5)
    ring = make_mixer(spec, MixerConfig(impl="ring", quant=cfg.quant),
                      device=dev)(x, z, key)
    dense = make_mixer(spec, MixerConfig(impl="dense", quant=cfg.quant),
                       device=dev)(x, z, key)
    rep["ring_vs_dense_mixer_max_abs"] = max(
        float((ring[n] - dense[n]).abs().max()) for n in x)

    ck = prng.split(prng.PRNGKey(6), M)
    b = fed.round_batches(1, K=K, batch=BATCH, device=dev)
    y, v, g, _ = local_train_deferred(loss_fn, x, b, ck, eta=ETA, theta=THETA)
    args = (x, y, v, g, {n: t[:, K - 1] for n, t in b.items()},
            prng.split(ck, K)[:, K - 1], key)
    tails = [make_fused_tail(loss_fn, M, eta=ETA, theta=THETA,
                             quant=cfg.quant, plan=plan, W=spec.W,
                             device=dev)(*args)
             for plan in (spec.gossip_plan(), None)]
    rep["fused_plan_vs_dense_tail_max_abs"] = max(
        float((tails[0][0][n] - tails[1][0][n]).abs().max()) for n in x)
    print(json.dumps(rep), flush=True)
    for k in ("ring_vs_dense_mixer_max_abs",
              "fused_plan_vs_dense_tail_max_abs"):
        if rep[k] > 1e-5:
            raise AssertionError(f"{k}: {rep[k]}")
    return rep


def _kernel_group(name: str) -> str:
    # Longest names first: "quantize_pack_buffer_kernel" is inside
    # "momentum_quantize_pack_buffer_kernel".
    for kernel in sorted(KERNEL_SOURCES, key=len, reverse=True):
        if f"{kernel}_kernel" in name:
            return kernel
    if "gemm" in name or "xmma" in name:
        return "matmul"
    if "<long" in name or "long," in name:
        return "int64 elementwise (threefry keys and noise)"
    return "other elementwise, reductions, copies"


def profile_rounds(step, state, batches) -> dict:
    """A torch.profiler trace of len(batches) rounds: device busy time,
    idle share, kernels launched and device time by group."""
    from torch.profiler import ProfilerActivity, profile

    n_rounds = len(batches)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            state, _ = step(state, b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups: dict[str, float] = {}
    n_kernels = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            g = _kernel_group(e.name)
            groups[g] = groups.get(g, 0.0) + e.time_range.elapsed_us()
            n_kernels += 1
    busy_ms = sum(groups.values()) / 1e3
    return {"profile_rounds": n_rounds,
            "profiled_wall_ms_per_round": wall_ms / n_rounds,
            "device_busy_ms_per_round": busy_ms / n_rounds,
            "device_idle_share": 1 - busy_ms / wall_ms,
            "device_ops_per_round": n_kernels / n_rounds,
            "device_us_per_round_by_group": {
                k: v / n_rounds for k, v in
                sorted(groups.items(), key=lambda kv: -kv[1])}}


def round_breakdown(dev, n_rounds: int = 5) -> tuple[dict, dict]:
    """Phase 6, where a quickstart round's time goes: host-clock times of
    the unfused round's phases (each ended by a synchronize; median of
    n_rounds), then a profile of n_rounds unfused and n_rounds fused
    rounds."""
    from repro_torch import prng
    from repro_torch.core import MixerConfig, init_round_state, make_mixer
    from repro_torch.core.local_sgd import local_train
    from repro_torch.core.mixing import _quant_leaf_keys
    from repro_torch.core.wire_layout import WireLayout

    data, fed, stacked, spec, cfg, loss_fn, step = quickstart_setup(dev)
    batches = [fed.round_batches(t, K=K, batch=BATCH, device=dev)
               for t in range(n_rounds + 1)]
    state = init_round_state(stacked, prng.PRNGKey(1))
    state, _ = step(state, batches[-1])              # warm-up
    mixer = make_mixer(spec, MixerConfig(quant=cfg.quant), device=dev)
    layout = WireLayout.for_tree(stacked, cfg.quant.bits, stacked=True)
    keys = prng.split(prng.PRNGKey(2), M)
    x = state.params
    z, _ = local_train(loss_fn, x, batches[0], keys, eta=ETA, theta=THETA)
    mixer(x, z, prng.PRNGKey(3))                     # warm-up
    phases: dict[str, list] = {"round": [], "local_sgd": [], "mix": [],
                               "noise_in_mix": []}
    for b in batches[:n_rounds]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        z, _ = local_train(loss_fn, x, b, keys, eta=ETA, theta=THETA)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mixer(x, z, prng.PRNGKey(3))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        layout.noise_stacked(
            _quant_leaf_keys(prng.PRNGKey(3), layout.n_leaves, M).to(dev))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        step(state, b)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        phases["local_sgd"].append((t1 - t0) * 1e3)
        phases["mix"].append((t2 - t1) * 1e3)
        phases["noise_in_mix"].append((t3 - t2) * 1e3)
        phases["round"].append((t4 - t3) * 1e3)

    rep = {"path": "quickstart unfused",
           "phase_ms_median": {k: statistics.median(v)
                               for k, v in phases.items()},
           **profile_rounds(step, state, batches[:n_rounds])}
    print(json.dumps(rep), flush=True)

    fstep = quickstart_setup(dev, fuse_round=True)[-1]
    fstate = init_round_state(stacked, prng.PRNGKey(1))
    fstate, _ = fstep(fstate, batches[-1])           # warm-up
    frep = {"path": "quickstart fused",
            **profile_rounds(fstep, fstate, batches[:n_rounds])}
    print(json.dumps(frep), flush=True)
    return rep, frep


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import native

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = card_line()
    print(card, flush=True)
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0)}), flush=True)

    t0 = time.perf_counter()
    per_source = native.build()
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "nvcc_s": per_source}), flush=True)

    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device=dev)
    rec = kernel_checks(dev, flush)
    del flush
    reference_checks(dev)
    counts = {}
    counts["unfused"], unfused_ms, losses = round_path(dev, False)
    counts["fused"], fused_ms, fused_losses = round_path(dev, True)
    counts["ops"] = ops_path(dev)
    round_breakdown(dev)

    table = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        r = rec[name]
        path = KERNEL_PATH[name]
        table.append({"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": counts[path][name],
                      "path": path, "max_abs_err": r["max_abs_err"],
                      "ms": r["ms"], "plain_ms": r["plain_ms"],
                      "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                      "library_ms": None, "call_ms": r["call_ms"],
                      "max_ulp": r["max_ulp"], "shape": r["shape"]})
    print(json.dumps({"round_ms_median": {"unfused": unfused_ms,
                                          "fused": fused_ms},
                      "loss_first_last": {
                          "unfused": [losses[0], losses[-1]],
                          "fused": [fused_losses[0], fused_losses[-1]]}}))
    print(card)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
