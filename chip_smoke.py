#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. print the card (``nvidia-smi`` name and power limit) and versions;
2. build the CUDA sources in ``src/repro_torch/csrc`` (timed, one nvcc
   per source, all in parallel);
3. hold every kernel against its plain PyTorch version on the card at the
   shapes its path gives it — B1, B2, B4 and B5 at the quickstart's wire
   shapes (2NN, m=16, ring) at 2, 4, 8 and 16 bits (B1 and B4 keyed,
   drawing their own noise, against ``noise_stacked`` + the plain
   version, and with tensor noise), B3 over all six leaves in one launch
   and on a misaligned view, B6-B8 on one client's flat 2NN vector —
   packed words and B1-B5's floats bitwise equal, B6-B8's floats within
   MAX_ULP (bitwise is expected everywhere: the kernels pin rounding with
   _rn intrinsics and keep the plain version's operation order); time
   kernel, plain version and, for B3, the library's multi-tensor SGD step
   (``torch._fused_sgd_``) with CUDA events; count keyed B1's and keyed
   B4's compiled instructions by pipe (``cuobjdump -sass``) for their
   operations bounds;
4. one quickstart round on the card against the same round on the CPU,
   and the plan realization against the dense one on the card, for the
   unfused and the fused round;
5. drive three paths through the library API, each with every launch
   counter set to 0 just before and read just after: the quickstart
   round (2NN 784-200-200-10, 16 clients on a ring with self-weight 0.5,
   K=4, batch 32, eta=0.05, theta=0.9, 8-bit stochastic lemma5 gossip)
   for ROUNDS rounds, unfused (B1 keyed, B2, B3 once a local step) and
   fused (B3, B4 keyed, B5); then
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
import re
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
SMS, CLOCK_HZ = 132, 1.98e9  # H100 SXM: SMs, boost clock
# Thread instructions one Hopper SM retires per clock, by pipe. Four
# sub-partitions each issue one warp instruction a clock (issue: 128) and
# hold 16 ALU lanes (integer add, logic, shift, compare, select; float
# compare and min/max: 64), 16 FMA-heavy lanes (f32 and IMAD) beside 16
# FMA-lite lanes (f32 only), so 128 f32 but 64 IMAD a clock, and 4 XU
# lanes (MUFU and conversions: 16). 128 f32 lanes x 2 operations x 132 SMs
# x 1.98 GHz is the data sheet's 67 TFLOP/s.
PIPE_PER_CLK = {"issue": 128, "alu": 64, "fma": 128, "imad": 64, "xu": 16}
# SASS opcodes (the part before the first ".") by pipe; any other opcode
# (memory, uniform datapath, control) counts toward issue only.
SASS_PIPE = {
    "alu": {"IADD3", "LOP3", "SHF", "ISETP", "SEL", "FSEL", "PLOP3", "MOV",
            "FMNMX", "FSETP", "LEA", "IABS", "PRMT", "IMNMX", "VIMNMX",
            "BMSK", "FCHK", "P2R", "R2P", "CS2R", "FLO", "BREV", "POPC"},
    "imad": {"IMAD", "IMUL", "IDP", "VIADD"},
    "fp32": {"FFMA", "FADD", "FMUL", "FFMA32I", "FADD32I", "FMUL32I",
             "HFMA2", "HADD2", "HMUL2"},
    "xu": {"MUFU", "F2I", "I2F", "F2F", "FRND", "I2FP", "F2IP"},
}
MAX_ULP = 2                  # stated float bound kernel vs plain
# (bits, stochastic) of the wire at which B1, B2, B4 and B5 are checked.
CODECS = ((8, True), (8, False), (4, True), (2, True), (16, True))
REPS, WARMUP = 20, 3
HOST_RUNS, HOST_RUN = 100, 3  # host clock: runs of back-to-back calls
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
# Further times a row carries where its kernel has them, all measured.
EXTRA_KEYS = ("clean_ms", "host_ms", "plain_call_ms", "plain_host_ms",
              "library_call_ms", "library_host_ms", "library_clean_ms",
              "tensor_noise_ms", "tensor_noise_call_ms",
              "tensor_noise_host_ms", "tensor_noise_clean_ms")
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


def time_ms(fn, flush: torch.Tensor) -> tuple[float, float, float, float]:
    """(device ms, call ms, host ms, clean device ms) of one call.

    Device: the L2 is flushed by writing a 128 MB buffer, then the stream
    is held busy (``torch.cuda._sleep``) while the host enqueues the call
    between two events, so the events time the call's kernels alone, not
    the host's Python and launch overhead. The flush leaves the L2 full of
    dirty lines, which the call writes back as its own data evicts them.
    Clean device: the same, with the L2 flushed by reading the buffer, so
    the call finds it cold and clean and the events time its own traffic.
    Call: the dirty flush with
    the stream idle, so the host's launch path is in the time (less what
    overlaps the flush). All three are medians over REPS. Host: the host
    clock around one call — the wrapper's Python, checks and enqueue,
    without the device — as a median over HOST_RUNS runs of HOST_RUN
    back-to-back calls between synchronizes, the first call of each run
    left out (it follows the wait), with no flush or event in between."""
    for _ in range(WARMUP):
        fn()
    dev, call, clean = [], [], []
    for _ in range(REPS):
        for held, dirty, out in ((True, True, dev), (False, True, call),
                                 (True, False, clean)):
            if dirty:
                flush.zero_()
            else:
                flush.sum()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if held:
                torch.cuda._sleep(SLEEP_CYCLES)
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
    host = []
    for _ in range(HOST_RUNS):
        torch.cuda.synchronize()
        for i in range(HOST_RUN):
            t0 = time.perf_counter()
            fn()
            if i:
                host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return (statistics.median(dev), statistics.median(call),
            statistics.median(host), statistics.median(clean))


def timed(r: dict, prefix: str, fn, flush: torch.Tensor) -> None:
    """Store ``time_ms(fn)`` in r as <prefix>ms, <prefix>call_ms,
    <prefix>host_ms and <prefix>clean_ms."""
    (r[f"{prefix}ms"], r[f"{prefix}call_ms"], r[f"{prefix}host_ms"],
     r[f"{prefix}clean_ms"]) = time_ms(fn, flush)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(n_bytes: int, n_ops: int, ops_ms: float = 0.0
          ) -> tuple[float, str]:
    """Least time in ms for the work: the larger of the bytes over the
    memory rate and the operations over their peak rate — n_ops f32
    operations at the f32 rate, or ``ops_ms`` where the instructions were
    counted by pipe (:func:`sass_ops_ms`)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(n_ops / F32_OPS_PER_S * 1e3, ops_ms)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sass_counts(sass: str, pattern: str) -> dict[str, int]:
    """Instructions of the one kernel in the ``cuobjdump -sass`` text
    whose mangled name matches ``pattern``, by opcode (the part before
    the first "."), as one thread runs it once through. Left out: the
    subroutines it CALLs and the blocks that set up and make such a call
    (the IEEE division's slow path, taken only for operands out of its
    fast range), NOPs, and the closing branch to itself. A block starts
    at a branch or call target and after a branch, EXIT or RET; a loop's
    body counts once."""
    funcs = re.split(r"\n\s*Function : ", sass)[1:]
    found = [f for f in funcs if re.search(pattern, f.split()[0])]
    if len(found) != 1:
        raise AssertionError(f"{len(found)} kernels match {pattern}")
    code, labels, pending = [], {}, []   # code: (address, opcode, operands)
    for line in found[0].splitlines():
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                       r"([A-Z][A-Z0-9_.]*)([^;]*);", line)
        if lab:
            pending.append(lab.group(1))
        elif ins:
            at = int(ins.group(1), 16)
            labels.update((name, at) for name in pending)
            pending = []
            code.append((at, ins.group(2).split(".")[0], ins.group(3)))

    def targets(ops: tuple) -> set[int]:
        """Addresses the instructions ``ops`` branch or call to."""
        out = set()
        for _, op, arg in code:
            if op in ops:
                out.update(int(t, 16) for t in re.findall(r"0x([0-9a-f]+)",
                                                          arg))
                out.update(labels[t] for t in re.findall(r"\.L_x_\d+", arg))
        return out

    called = targets(("CALL",))
    starts = targets(("BRA", "CALL"))
    blocks: list[list[tuple[int, str, str]]] = []
    for k, ins in enumerate(code):
        if not blocks or ins[0] in starts or code[k - 1][1] in ("BRA",
                                                                 "EXIT",
                                                                 "RET"):
            blocks.append([])
        blocks[-1].append(ins)
    counts: dict[str, int] = {}
    in_sub = False
    for body in blocks:
        in_sub = in_sub or body[0][0] in called
        ops = [op for _, op, _ in body]
        if in_sub:
            in_sub = "RET" not in ops
            continue
        if "CALL" in ops or (ops == ["BRA"] and body[0][0] in targets(
                ("BRA",)) and re.search(f"0x0*{body[0][0]:x}\\b",
                                       body[0][2])):
            continue
        for op in ops:
            if op != "NOP":
                counts[op] = counts.get(op, 0) + 1
    return counts


def pipe_ms(counts: dict[str, float]) -> dict[str, float]:
    """Time in ms each pipe needs for ``counts`` thread instructions (by
    opcode) spread over every SM at its peak rate; the f32 and IMAD
    instructions share the FMA pipe."""
    n = {p: sum(v for k, v in counts.items() if k in ops)
         for p, ops in SASS_PIPE.items()}
    n["issue"] = sum(counts.values())
    per_s = {p: PIPE_PER_CLK[p] * SMS * CLOCK_HZ for p in PIPE_PER_CLK}
    return {"issue": n["issue"] / per_s["issue"] * 1e3,
            "alu": n["alu"] / per_s["alu"] * 1e3,
            "fma": max(n["imad"] / per_s["imad"],
                       (n["imad"] + n["fp32"]) / per_s["fma"]) * 1e3,
            "xu": n["xu"] / per_s["xu"] * 1e3}


def keyed_ops(kernel: str, bits: int, threads: int, n_real: int) -> dict:
    """The operations bound of keyed B1 (``kernel`` =
    "quantize_pack_buffer") or keyed B4 ("momentum_quantize_pack_buffer")
    from its compiled code. The tensor-noise kernel of the same body gives
    the work of a thread (T, per thread); the keyed kernel's surplus over
    it, over the values a thread packs, gives the work of one draw (D, per
    value: the hash, its counter and bounds check, a share of the leaf
    lookup, less the noise loads). This run's work is threads x T + real
    values x D (padding draws nothing); the bound is its busiest pipe."""
    from repro_torch.kernels import native

    sass = subprocess.run(
        [native.cuda_tool("cuobjdump"), "-sass",
         str(native.lib_path("quantize_pack"))], capture_output=True,
        text=True, check=True, timeout=120).stdout
    # The digit is the end of the mangled name's length prefix, so B1's
    # pattern does not match inside B4's name.
    name = r"\d" + kernel + r"_kernelILi{}ELN\w*NoiseE{}E"
    per_thread = sass_counts(sass, name.format(bits, 1))
    keyed = sass_counts(sass, name.format(bits, 2))
    values = 4 * (32 // bits)           # kCols columns x per rows
    per_draw = {k: (keyed.get(k, 0) - per_thread.get(k, 0)) / values
                for k in set(keyed) | set(per_thread)}
    work = {k: threads * per_thread.get(k, 0) + n_real * per_draw[k]
            for k in per_draw}
    ms = pipe_ms(work)
    pipe = max(ms, key=ms.get)
    return {"ms": ms[pipe], "pipe": pipe, "pipe_ms": ms,
            "threads": threads, "real_values": n_real,
            "instructions": sum(work.values()),
            "tensor_noise_per_thread": per_thread,
            "keyed_per_thread": keyed,
            "per_draw": {k: v for k, v in per_draw.items() if v}}


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

    for bits, stochastic in CODECS:
        quant = QuantConfig(bits=bits, stochastic=stochastic)
        layout = WireLayout.for_tree(x, bits, stacked=True)
        X = layout.to_planar_stacked(x)
        delta = layout.to_planar_stacked({n: z[n] - x[n] for n in x})
        sblk = layout.block_scales(layout.leaf_scales(delta, quant))
        r = rec["quantize_pack_buffer"]
        what = f"B1 bits={bits} stochastic={stochastic}"
        if not stochastic:
            words = quantize_pack_buffer(delta, sblk, bits)
            check_words(what, words, ref.quantize_pack_buffer_ref(
                delta, sblk, bits))
            r["checks"].append(f"bits={bits} deterministic "
                               f"shape={list(delta.shape)} words bitwise")
            continue
        keys = _quant_leaf_keys(key, layout.n_leaves, M).to(dev)
        table = layout.noise_table
        noise = layout.noise_stacked(keys)
        words = quantize_pack_buffer(delta, sblk, bits, keys=keys,
                                     table=table)
        words_ref = ref.quantize_pack_buffer_ref(delta, sblk, bits, noise)
        words_tensor = quantize_pack_buffer(delta, sblk, bits, noise)
        noise_ref = ref.keyed_noise_ref(keys, table, layout.per,
                                        layout.total_words)
        torch.cuda.synchronize()
        check_words(f"{what} keyed", words, words_ref)
        check_words(f"{what} tensor noise", words_tensor, words_ref)
        check_words("keyed_noise_ref vs noise_stacked",
                    noise_ref.view(torch.int32), noise.view(torch.int32))
        r["checks"].append(f"bits={bits} stochastic shape="
                           f"{list(delta.shape)} keyed and tensor-noise "
                           "words bitwise vs noise_stacked + plain")
        if bits == 8:
            n_real = sum(layout.sizes) * M
            timed(r, "", lambda: quantize_pack_buffer(
                delta, sblk, bits, keys=keys, table=table), flush)
            timed(r, "plain_", lambda: ref.quantize_pack_buffer_ref(
                delta, sblk, bits, layout.noise_stacked(keys)), flush)
            r["sass"] = keyed_ops("quantize_pack_buffer", bits,
                                  delta.shape[0] * delta.shape[2] // 4,
                                  n_real)
            r["bound_ms"], r["bound_by"] = bound(
                nbytes(delta, sblk, keys, words), 0, r["sass"]["ms"])
            r["bound_bytes_ms"] = bound(nbytes(delta, sblk, keys, words),
                                        0)[0]
            timed(r, "tensor_noise_", lambda: quantize_pack_buffer(
                delta, sblk, bits, noise), flush)
            r["tensor_noise_bound_ms"] = bound(
                nbytes(delta, sblk, noise, words), 8 * delta.numel())[0]
            r["shape"] = list(delta.shape)

        out = dequant_mix_buffer(X, words, sblk, w, src, bits)
        out_ref = dequant_mix_buffer_plain(X, words, sblk, w, src, bits)
        torch.cuda.synchronize()
        r = rec["dequant_mix_buffer"]
        check_words(f"B2 bits={bits}", out.view(torch.int32),
                    out_ref.view(torch.int32))
        check_floats(r, f"B2 bits={bits}", [(out, out_ref)])
        r["checks"].append(f"bits={bits} K=3 shape={list(X.shape)} "
                           "bitwise")
        if (bits, stochastic) == (8, True):
            timed(r, "", lambda: dequant_mix_buffer(
                X, words, sblk, w, src, bits), flush)
            timed(r, "plain_", lambda: dequant_mix_buffer_plain(
                X, words, sblk, w, src, bits), flush)
            r["bound_ms"], r["bound_by"] = bound(
                nbytes(X, words, sblk, w, src, out),
                X.numel() * 3 * src.shape[0])
            r["shape"] = list(X.shape)
            # What the card's memory gives a plain streaming pass under
            # the same timing: base copied into out (B2 less its words).
            timed(r, "copy_", lambda: out.copy_(X), flush)
            r["copy_bound_ms"] = bound(nbytes(X, out), 0)[0]

    momentum_checks(dev, flush, rec["momentum_sgd"], stacked_randn)
    fused_kernel_checks(dev, flush, rec, x, stacked_randn)
    ops_kernel_checks(dev, flush, rec)
    for name, r in rec.items():
        print(json.dumps({"check": name, **r}), flush=True)
    return rec


def momentum_checks(dev, flush, r, stacked_randn):
    """B3 at one local step of the quickstart: all six leaves of the 2NN
    for 16 clients in one launch, bitwise against the plain step, plus a
    leaf that is a misaligned view (the kernel's scalar loop); timed as
    one call of ``momentum_update`` against the plain per-leaf step and
    the library's multi-tensor SGD step over the same leaves."""
    from repro_torch.kernels import momentum_update, ref
    from repro_torch.kernels.momentum_sgd import momentum_sgd

    y, v, g = stacked_randn(0.05), stacked_randn(0.01), stacked_randn(0.1)
    ys, vs = momentum_update(y, v, g, ETA, THETA)
    refs = {n: ref.momentum_sgd_ref(y[n], v[n], g[n], ETA, THETA) for n in y}
    n_mis = y["b2"].numel() + 5
    spare = torch.empty(n_mis + 1, device=dev)
    y_mis = spare[1:].copy_(torch.randn(n_mis, device=dev))
    v_mis, g_mis = torch.randn(n_mis, device=dev), torch.randn(n_mis,
                                                               device=dev)
    mis = momentum_sgd(y_mis, v_mis, g_mis, ETA, THETA)
    mis_ref = ref.momentum_sgd_ref(y_mis, v_mis, g_mis, ETA, THETA)
    torch.cuda.synchronize()
    pairs = [(ys[n], refs[n][0]) for n in y] + [(vs[n], refs[n][1])
                                                for n in y]
    pairs += list(zip(mis, mis_ref))
    for a, b in pairs:
        check_words("B3 vs plain", a.view(torch.int32), b.view(torch.int32))
    check_floats(r, "B3", pairs)
    n_el = sum(t.numel() for t in y.values())
    r["checks"].append(f"6 leaves x {M} clients = {n_el} values in one "
                       f"launch, and a misaligned view of {n_mis} values: "
                       "bitwise")
    timed(r, "", lambda: momentum_update(y, v, g, ETA, THETA), flush)
    timed(r, "plain_", lambda: [ref.momentum_sgd_ref(
        y[n], v[n], g[n], ETA, THETA) for n in y], flush)
    # torch._fused_sgd_ makes the same step in place over a list of
    # tensors (buf' = theta*buf + g; p' = p - eta*buf', i.e. v = -eta*buf)
    # and reads and writes the same five streams: timed only.
    params = [t.clone() for t in y.values()]
    bufs = [t.clone() for t in v.values()]
    grads = list(g.values())
    timed(r, "library_", lambda: torch._fused_sgd_(
        params, grads, bufs, weight_decay=0.0, momentum=THETA, lr=ETA,
        dampening=0.0, nesterov=False, maximize=False, is_first_step=False),
        flush)
    r["bound_ms"], r["bound_by"] = bound(5 * 4 * n_el, 3 * n_el)
    r["shape"] = f"one local step: 6 leaves x {M} clients ({n_el} f32)"


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
    for bits, stochastic in CODECS:
        quant = QuantConfig(bits=bits, stochastic=stochastic)
        layout = WireLayout.for_tree(x, bits, stacked=True)
        X, Y, V, G, GK = (layout.to_planar_stacked(t)
                          for t in (x, y, v, g, gk))
        delta = (Y + (theta_f * V - eta_f * G)) - X
        sblk = layout.block_scales(layout.leaf_scales(delta, quant))
        r = rec["momentum_quantize_pack_buffer"]
        what = f"B4 bits={bits} stochastic={stochastic}"
        keys = table = noise = None
        if stochastic:
            keys = _quant_leaf_keys(prng.PRNGKey(4), layout.n_leaves,
                                    M).to(dev)
            table = layout.noise_table
            noise = layout.noise_stacked(keys)
        want = ref.momentum_quantize_pack_buffer_ref(Y, V, G, X, sblk, bits,
                                                     et, noise)
        runs = {"": momentum_quantize_pack_buffer(
            Y, V, G, X, sblk, bits, et, keys=keys, table=table)}
        if stochastic:
            runs["tensor noise "] = momentum_quantize_pack_buffer(
                Y, V, G, X, sblk, bits, et, noise)
        torch.cuda.synchronize()
        for form, got in runs.items():
            for a, b in zip(got, want):
                check_words(f"{what} {form}", a.view(torch.int32),
                            b.view(torch.int32))
            check_floats(r, what, zip(got[:2], want[:2]))
        y_out, v_out, words = runs[""]
        r["checks"].append(
            f"bits={bits} stochastic={stochastic} shape={list(Y.shape)} "
            + ("keyed and tensor-noise words vs noise_stacked + plain"
               if stochastic else "words") + ", y' and v' bitwise")
        if (bits, stochastic) == (8, True):
            n_real = sum(layout.sizes) * M
            timed(r, "", lambda: momentum_quantize_pack_buffer(
                Y, V, G, X, sblk, bits, et, keys=keys, table=table), flush)
            timed(r, "plain_", lambda: ref.momentum_quantize_pack_buffer_ref(
                Y, V, G, X, sblk, bits, et, layout.noise_stacked(keys)),
                flush)
            timed(r, "tensor_noise_", lambda: momentum_quantize_pack_buffer(
                Y, V, G, X, sblk, bits, et, noise), flush)
            moved = nbytes(Y, V, G, X, sblk, keys, y_out, v_out, words)
            r["sass"] = keyed_ops("momentum_quantize_pack_buffer", bits,
                                  Y.shape[0] * Y.shape[2] // 4, n_real)
            r["bound_ms"], r["bound_by"] = bound(moved, 0, r["sass"]["ms"])
            r["bound_bytes_ms"] = bound(moved, 0)[0]
            r["tensor_noise_bound_ms"] = bound(
                nbytes(Y, V, G, X, noise, sblk, y_out, v_out, words),
                10 * Y.numel())[0]
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
        check_words(f"B5 bits={bits}", out.view(torch.int32),
                    out_ref.view(torch.int32))
        check_floats(r, f"B5 bits={bits}", [(out, out_ref)])
        r["checks"].append(f"bits={bits} K=3 shape={list(X.shape)} "
                           "bitwise")
        if bits == 8:
            timed(r, "", lambda: dequant_mix_momentum_buffer(
                base, words, sblk, w, src, v_out, GK, et, bits), flush)
            timed(r, "plain_", lambda: dequant_mix_momentum_buffer_plain(
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
    timed(r, "", lambda: quantize_pack(x2d, s, 8, noise), flush)
    timed(r, "plain_", lambda: ref.quantize_pack_ref(x2d, s, 8, noise),
          flush)
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
        timed(r, "", kernel, flush)
        timed(r, "plain_", plain, flush)
        r["bound_ms"], r["bound_by"] = bound(nbytes(*inputs, out),
                                             9 * xb.numel())
        r["shape"] = list(xb.shape)


def expected_launches(fuse_round: bool) -> dict:
    """Launch counts of ROUNDS quickstart rounds: one encode and one
    decode a round, B3 once per applied local step over all leaves (K
    unfused, K - 2 fused: B4 and B5 apply the last two)."""
    expect = {k: 0 for k in KERNEL_SOURCES}
    if fuse_round:
        expect.update(momentum_quantize_pack_buffer=ROUNDS,
                      dequant_mix_momentum_buffer=ROUNDS,
                      momentum_sgd=ROUNDS * (K - 2))
    else:
        expect.update(quantize_pack_buffer=ROUNDS, dequant_mix_buffer=ROUNDS,
                      momentum_sgd=ROUNDS * K)
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
    expect = expected_launches(fuse_round)
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


def round_breakdown(dev, n_rounds: int = 9) -> tuple[dict, dict]:
    """Phase 6, where a quickstart round's time goes: host-clock times of
    the unfused round's phases (each ended by a synchronize; median of
    n_rounds) and of ``noise_stacked`` alone — the plain-torch noise
    that neither round draws any more (keyed B1 and B4 draw it) — with
    an unfused and a fused round timed in turn in every pass, so the two
    share the host's drift; then a profile of 5 unfused and 5 fused
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
    fstep = quickstart_setup(dev, fuse_round=True)[-1]
    fstate = init_round_state(stacked, prng.PRNGKey(1))
    fstate, _ = fstep(fstate, batches[-1])           # warm-up
    mixer = make_mixer(spec, MixerConfig(quant=cfg.quant), device=dev)
    layout = WireLayout.for_tree(stacked, cfg.quant.bits, stacked=True)
    keys = prng.split(prng.PRNGKey(2), M)
    x = state.params
    z, _ = local_train(loss_fn, x, batches[0], keys, eta=ETA, theta=THETA)
    mixer(x, z, prng.PRNGKey(3))                     # warm-up
    phases: dict[str, list] = {"round": [], "fused_round": [],
                               "local_sgd": [], "mix": [],
                               "noise_stacked_alone": []}
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
        fstep(fstate, b)
        torch.cuda.synchronize()
        t5 = time.perf_counter()
        phases["local_sgd"].append((t1 - t0) * 1e3)
        phases["mix"].append((t2 - t1) * 1e3)
        phases["noise_stacked_alone"].append((t3 - t2) * 1e3)
        phases["round"].append((t4 - t3) * 1e3)
        phases["fused_round"].append((t5 - t4) * 1e3)

    rep = {"path": "quickstart unfused",
           "phase_ms_median": {k: statistics.median(v)
                               for k, v in phases.items()},
           "phase_ms": phases,
           **profile_rounds(step, state, batches[:5])}
    print(json.dumps(rep), flush=True)
    frep = {"path": "quickstart fused",
            **profile_rounds(fstep, fstate, batches[:5])}
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
                      "library_ms": r.get("library_ms"),
                      "call_ms": r["call_ms"],
                      "max_ulp": r["max_ulp"], "shape": r["shape"],
                      **{k: r[k] for k in EXTRA_KEYS if k in r}})
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
