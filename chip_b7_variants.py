#!/usr/bin/env python3
"""B7 (``dequant_mix_plan``) against two variants of its own source, on
one CUDA card.

    python3 chip_b7_variants.py

Builds ``src/repro_torch/csrc/dequant_mix.cu`` three ways, one nvcc each,
all in parallel, into ``src/repro_torch/_build/variants/``:

- ``templated``: the source as it is (K fixed at compile time for
  K <= 8, groups of 8 above);
- ``grouped``: every K through the grouped kernel (K at run time, in
  groups of 8, each group's loads issued before its decode);
- ``volatile``: the scales and weights read by volatile loads, which
  the L1 does not serve, in place of loads relaxed at block scope.

Each variant's B7 is called through its flat C entry, as
``decode_apply_plan`` calls it, on one client's 2NN vector (n = 199 210,
8 bits) at K = 1, 3, 5, 8, 9, 13 and 17 and on the SmolLM-135M vector
(``chip_smoke.SMOLLM_N``) at K = 3 and 5: held bitwise against the plain
version, then timed (``chip_smoke.timed``: ``ms`` and ``clean_ms``) in
the order templated, grouped, volatile, volatile, grouped, templated, so
each variant has two readings and their spread shows the noise. Prints
the card, one JSON line per vector and K, the SASS load order of each
variant's 8-bit kernel at K = 3 (``chip_smoke.load_order``), and
``{"ok": true}`` last.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

VARIANTS = {
    "templated": (),
    "grouped": (("template <int BITS, int KS = kPlanStatic>",
                 "template <int BITS, int KS = 0>"),),
    "volatile": (("ld.relaxed.cta.global.f32", "ld.volatile.global.f32"),),
}
ORDER = ("templated", "grouped", "volatile", "volatile", "grouped",
         "templated")
KS = {"2nn": (1, 3, 5, 8, 9, 13, 17), "smollm": (3, 5)}
ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int64] + [ctypes.c_int] * 3
            + [ctypes.c_void_p])


def build() -> dict[str, Path]:
    """Write and compile each variant; returns {variant: library}."""
    from repro_torch.kernels import native

    src = (native.CSRC_DIR / "dequant_mix.cu").read_text()
    out = native.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = native.cuda_tool("nvcc")
    procs, libs = {}, {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise AssertionError(f"{name}: {old!r} not in the source")
            text = text.replace(old, new)
        cu = out / f"{name}.cu"
        cu.write_text(text)
        libs[name] = out / f"lib{name}.so"
        procs[name] = subprocess.Popen(
            [nvcc, *native.NVCC_FLAGS, "-o", str(libs[name]), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        for name, proc in procs.items():
            log, _ = proc.communicate(timeout=native.BUILD_TIMEOUT_S)
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {name}:\n{log}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_b7_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import native, ref

    dev = torch.device("cuda:0")
    print(cs.card_line(), flush=True)
    paths = build()
    fns = {}
    for name, path in paths.items():
        fn = ctypes.CDLL(str(path)).dequant_mix_plan
        fn.argtypes, fn.restype = ARGTYPES, ctypes.c_int
        fns[name] = fn
    for name, path in paths.items():
        sass = subprocess.run(
            [native.cuda_tool("cuobjdump"), "-sass", str(path)],
            capture_output=True, text=True, check=True, timeout=120).stdout
        kernel = r"\ddequant_mix_plan_kernelILi8ELi%dE" % (
            0 if name == "grouped" else 3)
        print(json.dumps({"variant": name, "sass_load_order_k3":
                          cs.load_order(sass, kernel)}), flush=True)

    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for size, n in (("2nn", cs.FLAT_2NN), ("smollm", cs.SMOLLM_N)):
        gen = torch.Generator(device=dev).manual_seed(n)
        x, streams, scales, weights = cs.plan_operands(
            dev, n, 8, max(KS[size]), gen)
        wd = streams.shape[1]
        out = torch.empty_like(x)
        for k in KS[size]:
            args = (streams[:k], scales[:k].contiguous(),
                    weights[:k].contiguous())
            want = ref.dequant_mix_plan_ref(ref.pad_planar(x, 8), *args,
                                            8).reshape(-1)[:n]

            def call(fn):
                return fn(x.data_ptr(), args[0].data_ptr(),
                          args[1].data_ptr(), args[2].data_ptr(),
                          out.data_ptr(), n, k, wd, 8, stream)

            for name, fn in fns.items():
                out.fill_(float("nan"))
                if call(fn):
                    raise RuntimeError(f"{name}: launch failed")
                cs.check_words(f"{name} {size} K={k}",
                               out.view(torch.int32), want.view(torch.int32))
            del want
            row = {"vector": size, "n": n, "k": k,
                   "bound_ms": cs.bound(cs.nbytes(x, *args, out), 0)[0]}
            for name in ORDER:
                r = {}
                cs.timed(r, "", lambda: call(fns[name]), flush)
                row.setdefault(name, []).append(
                    {"ms": r["ms"], "clean_ms": r["clean_ms"]})
            print(json.dumps(row), flush=True)
        del x, streams, out
    print(cs.card_line())
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
