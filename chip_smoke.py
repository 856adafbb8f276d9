#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. print the card (``nvidia-smi`` name and power limit) and versions;
2. build the three CUDA kernels from ``src/repro_torch/csrc`` (timed);
3. hold every kernel against its plain PyTorch version on the card at the
   main path's shapes (2NN, m=16, ring, 8 and 4 bits): packed words must
   be bitwise equal, floats within MAX_ULP (bitwise is expected: the
   kernels pin rounding with _rn intrinsics and keep the plain version's
   operation order); time kernel and plain version with CUDA events;
4. drive the main path through the library API — the quickstart
   configuration (2NN 784-200-200-10, 16 clients on a ring with
   self-weight 0.5, K=4, batch 32, eta=0.05, theta=0.9, 8-bit stochastic
   lemma5 gossip) for ROUNDS rounds — with every launch counter set to 0
   just before and read just after; check the counts, finite falling
   loss, and one round against the same round on the CPU and the plan
   mixer against the dense mixer on the card;
5. print the kernel table as one JSON line, then the card again, then
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
}


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


def unported_bounds() -> dict:
    """Byte bounds of the Pallas kernels not on this slice's path (B4-B8),
    at the main path's 2NN wire shapes (m=16 clients, 8 bits: per=4,
    W=51 712; k=3 ring streams), each input read once and each output
    written once, in the Pallas kernels' own operand forms."""
    per, w, k, f = 4, 51712, 3, 4
    buf, words = per * w * f, w * f
    per_client = {
        "momentum_quantize_pack_buffer": 5 * buf + 2 * buf + words,
        "dequant_mix_momentum_buffer": 3 * buf + k * words + buf,
        "quantize_pack": 2 * buf + words,
        "dequant_mix_plan": buf + k * words + buf,
        "dequant_mix": buf + 3 * words + buf,
    }
    return {name: {"bytes": M * b,
                   "bound_ms": M * b / HBM_BYTES_PER_S * 1e3}
            for name, b in per_client.items()}


def quickstart_setup(dev):
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
                         quant=QuantConfig(bits=8))

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
        if not torch.equal(words, words_ref):
            bad = int((words != words_ref).sum())
            raise AssertionError(f"B1 bits={bits} stochastic={stochastic}: "
                                 f"{bad} words differ from the plain version")
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
        err = float((out - out_ref).abs().max())
        ulp = ulp_diff(out, out_ref)
        if ulp > MAX_ULP:
            raise AssertionError(f"B2 bits={bits}: {ulp} ulp from plain")
        r = rec["dequant_mix_buffer"]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["max_ulp"] = max(r["max_ulp"], ulp)
        r["checks"].append(f"bits={bits} K=3 shape={list(X.shape)} "
                           f"max_ulp={ulp}")
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
        for a, b in zip(outs[n], refs[n]):
            ulp = ulp_diff(a, b)
            if ulp > MAX_ULP:
                raise AssertionError(f"B3 leaf {n}: {ulp} ulp from plain")
            r["max_ulp"] = max(r["max_ulp"], ulp)
            r["max_abs_err"] = max(r["max_abs_err"],
                                   float((a - b).abs().max()))
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
    for name, r in rec.items():
        print(json.dumps({"check": name, **r}), flush=True)
    return rec


def main_path(dev):
    """Phase 4: ROUNDS quickstart rounds through the library API, with
    the launch counters read around exactly that run."""
    from repro_torch import prng
    from repro_torch.core import init_round_state
    from repro_torch.kernels import launch_counts, reset_launch_counts

    data, fed, stacked, spec, cfg, loss_fn, step = quickstart_setup(dev)
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
    expect = {"quantize_pack_buffer": ROUNDS, "dequant_mix_buffer": ROUNDS,
              "momentum_sgd": ROUNDS * K * len(stacked)}
    print(json.dumps({"main_path": "quickstart", "rounds": ROUNDS,
                      "loss": losses, "consensus_dist": cons,
                      "round_ms": round_ms, "launches": counts,
                      "expected_launches": expect}), flush=True)
    if counts != expect:
        raise AssertionError(f"launch counts {counts} != {expect}")
    if not all(math.isfinite(v) for v in losses + cons):
        raise AssertionError("non-finite loss or consensus")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses[0]} -> "
                             f"{losses[-1]}")
    for n, t in state.params.items():
        if t.shape != stacked[n].shape or not torch.isfinite(t).all():
            raise AssertionError(f"leaf {n}: bad shape or non-finite")
    return counts, statistics.median(round_ms[1:]), losses


def reference_checks(dev):
    """One quickstart round on the card against the same round on the
    CPU (plain versions), and the plan mixer against the dense mixer on
    the card, at full width."""
    from repro_torch import prng
    from repro_torch.core import (MixerConfig, init_round_state,
                                  make_mixer, make_round_step)
    data, fed, stacked, spec, cfg, loss_fn, step = quickstart_setup(dev)
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
    rep = {"round_vs_cpu": {"loss_rel": loss_rel, "consensus_rel": cons_rel,
                            "params_off_by_1e-5": far, "params": total}}
    if loss_rel > 1e-5 or cons_rel > 1e-3 or far > 1e-3 * total:
        raise AssertionError(f"card round disagrees with CPU round: {rep}")

    x = s_gpu.params
    z = {n: t + 0.01 * torch.randn_like(t) for n, t in x.items()}
    key = prng.PRNGKey(5)
    ring = make_mixer(spec, MixerConfig(impl="ring", quant=cfg.quant),
                      device=dev)(x, z, key)
    dense = make_mixer(spec, MixerConfig(impl="dense", quant=cfg.quant),
                       device=dev)(x, z, key)
    mix_err = max(float((ring[n] - dense[n]).abs().max()) for n in x)
    rep["ring_vs_dense_mixer_max_abs"] = mix_err
    print(json.dumps(rep), flush=True)
    if mix_err > 1e-5:
        raise AssertionError(f"ring mixer vs dense mixer: {mix_err}")
    return rep


def _kernel_group(name: str) -> str:
    for kernel in KERNEL_SOURCES:
        if f"{kernel}_kernel" in name:
            return kernel
    if "gemm" in name or "xmma" in name:
        return "matmul"
    if "<long" in name or "long," in name:
        return "int64 elementwise (threefry keys and noise)"
    return "other elementwise, reductions, copies"


def round_breakdown(dev, n_rounds: int = 5) -> dict:
    """Where a main-path round's time goes: host-clock times of the
    round's phases (each ended by a synchronize; median of n_rounds),
    then a torch.profiler trace of n_rounds rounds — device busy time,
    idle share, kernels launched and device time by group."""
    from torch.profiler import ProfilerActivity, profile

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

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[:n_rounds]:
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
    rep = {"phase_ms_median": {k: statistics.median(v)
                               for k, v in phases.items()},
           "profile_rounds": n_rounds,
           "profiled_wall_ms_per_round": wall_ms / n_rounds,
           "device_busy_ms_per_round": busy_ms / n_rounds,
           "device_idle_share": 1 - busy_ms / wall_ms,
           "device_ops_per_round": n_kernels / n_rounds,
           "device_us_per_round_by_group": {
               k: v / n_rounds for k, v in
               sorted(groups.items(), key=lambda kv: -kv[1])}}
    print(json.dumps(rep), flush=True)
    return rep


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
    counts, round_ms, losses = main_path(dev)
    round_breakdown(dev)

    table = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        r = rec[name]
        table.append({"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": counts[name],
                      "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                      "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                      "bound_by": r["bound_by"], "library_ms": None,
                      "max_ulp": r["max_ulp"], "shape": r["shape"]})
    print(json.dumps({"round_ms_median": round_ms,
                      "loss_first": losses[0], "loss_last": losses[-1]}))
    print(json.dumps({"unported_bounds": unported_bounds()}))
    print(card)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
