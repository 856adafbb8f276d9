"""The CUDA sources of B1-B8 and T1-T4, compiled for the host and run on
the CPU against their plain PyTorch versions.

``tests/cuda_host/cuda_runtime.h`` stands in for the CUDA runtime and the
device intrinsics these kernels use; every ``kernel<<<...>>>(args)`` launch
is rewritten into a loop over blocks and threads. So the kernels' own index
arithmetic runs here — block-to-leaf search, float4 and scalar paths, the
keyed noise's leaf lookup, counters and threefry rounds, B3's bf16
entries (the f32 arithmetic, the round-to-nearest-even store, a table
mixing f32 and bf16 leaves through the wrapper's grouping), B2's and B5's
four columns a thread and their stream gather, keyed B6's counter over
the whole padded buffer and its key by value or by pointer, B7's streams
fixed at compile time or in groups, B8's three stream pointers, and the
flat [n] x of B7 and B8 with its ragged tail and scalar path, B3's lane
entry (a device eta [m], client c's values stepping with eta[c]), T1's
pair per thread (its fold_in of one counter, and of a counter a row)
and T2's, T3's and T4's
grid of (blocks of a row, rows) — called
through
their C entry points exactly as the wrappers call them. What it cannot show
(the device compiler, timing, memory coalescing) is left to
``chip_smoke.py`` on the card.

Contracts: words bitwise; float outputs bitwise, but T4's against
``prng.normal_plain`` within T4_HOST_ULP where the host's ``log1pf``
(glibc) and torch's CPU ``log1p`` round apart (3 ulp at most, on 0.7 %
of the draws; on the card both are the CUDA math library's, and
``chip_smoke.py`` holds T4 bitwise there).
"""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert, prng  # noqa: E402
from repro_torch.core import QuantConfig, WireLayout  # noqa: E402
from repro_torch.core.mixing import _quant_leaf_keys  # noqa: E402
from repro_torch.kernels import native, ref  # noqa: E402
from repro_torch.kernels.dequant_mix import (  # noqa: E402
    dequant_mix_buffer_plain, dequant_mix_momentum_buffer_plain)
from repro_torch.kernels.momentum_sgd import (  # noqa: E402
    momentum_sgd_lanes_ref, out_offsets)

torch.set_num_threads(1)

HOST_INCLUDE = Path(__file__).resolve().parent / "cuda_host"
LAUNCH = re.compile(r"([\w:]+(?:<[^<>;]*>)?)\s*<<<(.*?)>>>\s*\((.*?)\);",
                    re.S)
P = ctypes.c_void_p
RAGGED = {"a": (33,), "kernel": (4, 9), "bias": (), "z": (3, 7, 5),
          "big": (2100,)}
# More leaves than one launch's table holds (64): two launches.
MANY = {f"l{i:02d}": (i % 5 + 1,) if i % 3 else (i + 1, 2)
        for i in range(66)}
B3_ARGS = [P] * 2 + [ctypes.c_int, ctypes.c_float, ctypes.c_float, P, P]
B3_LANE_ARGS = [P] * 2 + [ctypes.c_int, P, ctypes.c_int64, ctypes.c_float,
                          P, P]
F32 = ctypes.c_float
TABLE_ARGS = [P] * 3 + [ctypes.c_int] + [P] * 2
PLAN_ARGS = [P] * 5 + [ctypes.c_int64] + [ctypes.c_int] * 3 + [P]
RING_ARGS = ([P] * 5 + [F32] * 2 + [P, ctypes.c_int64] + [ctypes.c_int] * 2
             + [P])
# Flat vector lengths: one value, ragged tails of partial and empty rows,
# and one client's 2NN vector.
FLAT_N = [1, 970, 3000, 199210]
ETA, THETA = 0.05, 0.9
cudaErrorInvalidValue = 1     # as tests/cuda_host/cuda_runtime.h has it
T4_HOST_ULP = 3


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """Compile ``csrc/<name>.cu`` for the host (once per module)."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out_dir = tmp_path_factory.mktemp("csrc_host")
    libs = {}

    def load(name):
        if name not in libs:
            src = (native.CSRC_DIR / f"{name}.cu").read_text()
            cpp = out_dir / f"{name}.cpp"
            cpp.write_text(LAUNCH.sub(
                lambda m: (f"emu::launch({m.group(2)}, [&] {{ "
                           f"{m.group(1)}({m.group(3)}); }});"), src))
            so = out_dir / f"lib{name}.so"
            subprocess.run([cxx, "-std=c++17", "-O1", "-ffp-contract=off",
                            "-shared", "-fPIC", "-I", str(HOST_INCLUDE),
                            "-I", str(native.CSRC_DIR), "-o", str(so),
                            str(cpp)], check=True, capture_output=True,
                           timeout=300)
            libs[name] = ctypes.CDLL(str(so))
        return libs[name]

    return load


def entry(lib, symbol, argtypes):
    fn = getattr(lib, symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def ptr(a) -> int:
    return a.ctypes.data if isinstance(a, np.ndarray) else a.data_ptr()


def b3_step(fn, ys, vs, gs, y_out, v_out, sizes):
    """One call of B3's C entry over host arrays; returns (rc, launches)."""
    ptrs = np.array([[ptr(a) for a in row]
                     for row in zip(ys, vs, gs, y_out, v_out)], np.uint64)
    n = np.array(sizes, np.int64)
    launches = ctypes.c_int(-1)
    rc = fn(ptr(ptrs), ptr(n), len(sizes), 0.05, 0.9, None,
            ctypes.byref(launches))
    return rc, launches.value


def test_b3_one_launch_over_ragged_and_misaligned_leaves(host_lib):
    fn = entry(host_lib("momentum_sgd"), "momentum_sgd", B3_ARGS)
    rng = np.random.default_rng(0)
    sizes = [0, 1, 3, 4097, 8192, 5, 12345, 777]
    ys, vs, gs = ([rng.normal(size=n).astype(np.float32) for n in sizes]
                  for _ in range(3))
    spare = rng.normal(size=sizes[-1] + 1).astype(np.float32)
    ys[-1] = spare[1:]                     # 4 bytes past 16: scalar path
    offs, total, _ = out_offsets(tuple(sizes))
    out = np.full((2, total), np.nan, np.float32)
    y_out = [out[0, o:] for o in offs]
    v_out = [out[1, o:] for o in offs]
    assert b3_step(fn, ys, vs, gs, y_out, v_out, sizes) == (0, 1)
    bad = sizes[:-1] + [-1]                # a negative size is refused
    assert b3_step(fn, ys, vs, gs, y_out, v_out, bad)[0] != 0
    for i, n in enumerate(sizes):
        wy, wv = ref.momentum_sgd_ref(*(torch.from_numpy(np.array(a[i]))
                                        for a in (ys, vs, gs)), 0.05, 0.9)
        assert np.array_equal(out[0, offs[i]:offs[i] + n], wy.numpy()), i
        assert np.array_equal(out[1, offs[i]:offs[i] + n], wv.numpy()), i


def b3_lane_step(fn, ys, vs, gs, y_out, v_out, sizes, eta, m):
    """One call of B3's lane entry over host arrays: (rc, launches)."""
    ptrs = np.array([[ptr(a) for a in row]
                     for row in zip(ys, vs, gs, y_out, v_out)], np.uint64)
    n = np.array(sizes, np.int64)
    launches = ctypes.c_int(-1)
    rc = fn(ptr(ptrs), ptr(n), len(sizes), None if eta is None
            else ptr(eta), m, 0.9, None, ctypes.byref(launches))
    return rc, launches.value


@pytest.mark.parametrize("m", [1, 3, 16])
def test_b3_lanes_one_launch_over_ragged_and_misaligned_leaves(host_lib, m):
    """B3's lane entry: leaves [m, per] of ragged sizes — clients smaller
    than a float4 and than a block (per 1, 3, 10), a leaf over several
    blocks, a misaligned one (the scalar path) — in one launch, each
    client's values with its own eta, bitwise against the plain lane
    update; and with every eta equal, bitwise with the scalar entry."""
    fn = entry(host_lib("momentum_sgd"), "momentum_sgd_lanes", B3_LANE_ARGS)
    scalar = entry(host_lib("momentum_sgd"), "momentum_sgd", B3_ARGS)
    rng = np.random.default_rng(m)
    per = [0, 1, 3, 10, 1031, 4097, 7]
    sizes = [m * p for p in per]
    ys, vs, gs = ([rng.normal(size=n).astype(np.float32) for n in sizes]
                  for _ in range(3))
    spare = rng.normal(size=sizes[-1] + 1).astype(np.float32)
    ys[-1] = spare[1:]                     # 4 bytes past 16: scalar path
    eta = (0.05 / (1.0 + 0.5 * rng.integers(0, 4, size=m))).astype(
        np.float32)
    offs, total, _ = out_offsets(tuple(sizes))
    out = np.full((2, total), np.nan, np.float32)
    y_out = [out[0, o:] for o in offs]
    v_out = [out[1, o:] for o in offs]
    assert b3_lane_step(fn, ys, vs, gs, y_out, v_out, sizes, eta, m) == (
        0, 1)
    for i, (n, p) in enumerate(zip(sizes, per)):
        wy, wv = momentum_sgd_lanes_ref(
            *(torch.from_numpy(np.array(a[i]).reshape(m, p))
              for a in (ys, vs, gs)), torch.from_numpy(eta), 0.9)
        assert np.array_equal(out[0, offs[i]:offs[i] + n],
                              wy.reshape(-1).numpy()), i
        assert np.array_equal(out[1, offs[i]:offs[i] + n],
                              wv.reshape(-1).numpy()), i
    same = np.full(m, np.float32(0.05))
    lane = np.full((2, total), np.nan, np.float32)
    assert b3_lane_step(fn, ys, vs, gs, [lane[0, o:] for o in offs],
                        [lane[1, o:] for o in offs], sizes, same, m)[0] == 0
    assert b3_step(scalar, ys, vs, gs, y_out, v_out, sizes) == (0, 1)
    for i, (o, n) in enumerate(zip(offs, sizes)):
        assert np.array_equal(lane[:, o:o + n], out[:, o:o + n]), i


def test_b3_lanes_refuses_a_bad_m(host_lib):
    """The lane entry refuses m < 1, a null eta and a leaf whose size m
    does not divide; it launches nothing then."""
    fn = entry(host_lib("momentum_sgd"), "momentum_sgd_lanes", B3_LANE_ARGS)
    ys, vs, gs = ([np.ones(12, np.float32)] for _ in range(3))
    eta = np.full(4, np.float32(0.05))
    out = [np.zeros(12, np.float32)]
    assert b3_lane_step(fn, ys, vs, gs, out, out, [12], eta, 4) == (0, 1)
    for sizes, m, e in (([12], 5, eta), ([12], 0, eta), ([12], -4, eta),
                        ([12], 4, None), ([-4], 4, eta)):
        assert b3_lane_step(fn, ys, vs, gs, out, out, sizes, e, m) == (
            cudaErrorInvalidValue, 0)


def bf16_leaves(rng, sizes, misalign_last=True):
    """bf16 host tensors of ``sizes`` (normal values, some exactly on a
    bf16 rounding tie after the step is not controlled: random); the last
    starts 2 bytes past a 16-byte boundary (the scalar path)."""
    out = [torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(
        torch.bfloat16) for n in sizes]
    if misalign_last:
        spare = torch.from_numpy(rng.normal(size=sizes[-1] + 1).astype(
            np.float32)).to(torch.bfloat16)
        out[-1] = spare[1:]
    return out


@pytest.mark.parametrize("lanes", [False, True], ids=["scalar", "lanes"])
def test_b3_bf16_leaves_bitwise(host_lib, lanes):
    """B3's bf16 entries (scalar eta and a device eta [m]) over ragged
    bf16 leaves — empty, smaller than four values, several blocks, one
    misaligned (its scalar loop) — in one launch, bitwise against the
    plain version, which computes in f32 and rounds to nearest even."""
    m = 4
    lib = host_lib("momentum_sgd")
    fn = (entry(lib, "momentum_sgd_lanes_bf16", B3_LANE_ARGS) if lanes
          else entry(lib, "momentum_sgd_bf16", B3_ARGS))
    rng = np.random.default_rng(7 + lanes)
    sizes = [m * p for p in (0, 1, 3, 10, 1031, 4097, 7)]
    ys, vs, gs = (bf16_leaves(rng, sizes) for _ in range(3))
    eta = (0.05 / (1.0 + 0.5 * rng.integers(0, 4, size=m))).astype(
        np.float32)
    offs, total, _ = out_offsets(tuple(sizes), 8)
    out = torch.full((2, total), float("nan"), dtype=torch.bfloat16)
    y_out = [out[0, o:] for o in offs]
    v_out = [out[1, o:] for o in offs]
    if lanes:
        got = b3_lane_step(fn, ys, vs, gs, y_out, v_out, sizes, eta, m)
    else:
        got = b3_step(fn, ys, vs, gs, y_out, v_out, sizes)
    assert got == (0, 1)
    for i, (o, n) in enumerate(zip(offs, sizes)):
        args = [a[i].reshape(m, -1) for a in (ys, vs, gs)]
        wy, wv = (momentum_sgd_lanes_ref(*args, torch.from_numpy(eta), 0.9)
                  if lanes else ref.momentum_sgd_ref(*args, 0.05, 0.9))
        assert torch.equal(out[0, o:o + n].view(torch.int16),
                           wy.reshape(-1).view(torch.int16)), i
        assert torch.equal(out[1, o:o + n].view(torch.int16),
                           wv.reshape(-1).view(torch.int16)), i


def test_b3_bf16_rounding_ties_and_nan(host_lib):
    """The bf16 store rounds to nearest even on exact ties and carries
    infinities, zeros and subnormals, as ``Tensor.to(bfloat16)``: with y
    and g zero, y' = v' = theta * v, whose products with theta = 1 + 2^-8
    land on ties and beside them. NaN stays NaN (its payload is the
    platform's: torch's CPU conversion and the kernel's 0x7fc0 differ)."""
    fn = entry(host_lib("momentum_sgd"), "momentum_sgd_bf16", B3_ARGS)
    # bf16 values whose product with theta = 1 + 2^-8 lands on ties and
    # around them, plus the specials.
    v = torch.tensor([1.0, 1.0078125, 3.0, -5.0, 255.0, float("inf"),
                      float("-inf"), float("nan"), 0.0, -0.0, 1e-40, 7.0],
                     dtype=torch.float32).to(torch.bfloat16)
    y = torch.zeros_like(v)
    g = torch.zeros_like(v)
    theta = 1.0 + 2.0 ** -8
    n = v.numel()
    out = torch.zeros((2, -(-n // 8) * 8), dtype=torch.bfloat16)
    ptrs = np.array([[ptr(y), ptr(v), ptr(g), ptr(out[0]), ptr(out[1])]],
                    np.uint64)
    launches = ctypes.c_int(-1)
    assert fn(ptr(ptrs), ptr(np.array([n], np.int64)), 1, 0.05, theta,
              None, ctypes.byref(launches)) == 0
    wy, wv = ref.momentum_sgd_ref(y, v, g, 0.05, theta)
    nan = torch.isnan(v)
    for got, want in ((out[0, :n], wy), (out[1, :n], wv)):
        assert torch.equal(torch.isnan(got), nan)
        assert torch.equal(got[~nan].view(torch.int16),
                           want[~nan].view(torch.int16))


def test_b3_mixed_table_one_launch_a_dtype(host_lib, monkeypatch):
    """The wrapper's own grouping (``_launch_groups``) over a table that
    mixes f32 and bf16 leaves, run through the host build: one launch a
    dtype (two in all, counted in ``LAUNCHES["momentum_sgd"]``), every
    output in its leaf's dtype and bitwise with the plain version."""
    import importlib
    b3 = importlib.import_module("repro_torch.kernels.momentum_sgd")
    lib = host_lib("momentum_sgd")
    monkeypatch.setattr(native, "function",
                        lambda _lib, sym, args: entry(lib, sym, args))
    monkeypatch.setattr(native, "stream_of", lambda t: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: __import__("contextlib").nullcontext())
    rng = np.random.default_rng(3)
    shapes = [(4, 33), (4, 1031), (4, 7), (4, 2), (4, 4097)]
    dtypes = [torch.float32, torch.bfloat16, torch.bfloat16, torch.float32,
              torch.bfloat16]
    ys, vs, gs = ([torch.from_numpy(rng.normal(size=s).astype(np.float32))
                   .to(d) for s, d in zip(shapes, dtypes)]
                  for _ in range(3))
    before = native.LAUNCHES["momentum_sgd"]
    y_out, v_out = b3._launch_groups(ys, vs, gs, 0.05, 0.9,
                                     torch.device("cpu"))
    assert native.LAUNCHES["momentum_sgd"] - before == 2
    for i in range(len(shapes)):
        wy, wv = ref.momentum_sgd_ref(ys[i], vs[i], gs[i], 0.05, 0.9)
        assert y_out[i].dtype == dtypes[i] and v_out[i].dtype == dtypes[i]
        assert torch.equal(y_out[i], wy) and torch.equal(v_out[i], wv), i
    eta = torch.full((4,), 0.05)
    y_out, v_out = b3._launch_groups(ys, vs, gs, eta, 0.9,
                                     torch.device("cpu"))
    assert native.LAUNCHES["momentum_sgd_lanes"] >= 2
    for i in range(len(shapes)):
        wy, wv = momentum_sgd_lanes_ref(ys[i], vs[i], gs[i], eta, 0.9)
        assert torch.equal(y_out[i], wy) and torch.equal(v_out[i], wv), i


@pytest.mark.parametrize("sizes", [(0, 1, 3, 4097), (4097, 0, 3, 1),
                                   (4096, 4097, 8191), (0,), (5,) * 70])
def test_leaf_table_covers_every_element_once(host_lib, sizes):
    """The table B3's C entry builds (chunk prefix, one launch per 64
    leaves) serves every element of every leaf exactly once: the step runs
    in place, so an element served twice takes two steps and one never
    served keeps its input, and either differs from one plain step."""
    fn = entry(host_lib("momentum_sgd"), "momentum_sgd", B3_ARGS)
    rng = np.random.default_rng(len(sizes))
    ys, vs, gs = ([rng.normal(size=n).astype(np.float32) for n in sizes]
                  for _ in range(3))
    want = [ref.momentum_sgd_ref(*(torch.from_numpy(a[i].copy())
                                   for a in (ys, vs, gs)), 0.05, 0.9)
            for i in range(len(sizes))]
    rc, launches = b3_step(fn, ys, vs, gs, ys, vs, sizes)
    live = sum(1 for n in sizes if n)
    assert (rc, launches) == (0, -(-live // 64) if live else 0)
    for i, (wy, wv) in enumerate(want):
        assert np.array_equal(ys[i], wy.numpy()), i
        assert np.array_equal(vs[i], wv.numpy()), i


@pytest.mark.parametrize("shapes", [RAGGED, MANY], ids=["5", "66"])
@pytest.mark.parametrize("bits", [2, 4, 8, 16])
def test_b1_keyed_tensor_and_plain_noise(host_lib, bits, shapes):
    """Keyed B1 (one launch per 64 leaves) against ``noise_stacked`` +
    the plain encode; the tensor-noise and deterministic forms against the
    plain encode."""
    lib = host_lib("quantize_pack")
    keyed = entry(lib, "quantize_pack_buffer_keyed",
                  [P] * 4 + [ctypes.c_int] * 3 + [P] * 3 + [ctypes.c_int]
                  + [P] * 2)
    plain = entry(lib, "quantize_pack_buffer", [P] * 4 + [ctypes.c_int] * 4
                  + [P])
    m = 3
    rng = np.random.default_rng(bits)
    tree = convert.params_from_numpy(
        {n: (0.01 * rng.normal(size=(m,) + s)).astype(np.float32)
         for n, s in shapes.items()}, device="cpu")
    lay = WireLayout.for_tree(tree, bits, stacked=True)
    x = lay.to_planar_stacked(tree).contiguous()
    sblk = lay.block_scales(lay.leaf_scales(x, QuantConfig(bits=bits)))
    keys = _quant_leaf_keys(prng.PRNGKey(bits), lay.n_leaves, m).contiguous()
    w = lay.total_words
    noise = lay.noise_stacked(keys).contiguous()
    want = ref.quantize_pack_buffer_ref(x, sblk, bits, noise).numpy()

    table = lay.noise_table
    offs = np.array(table.word_offsets, np.int32)
    lw = np.array(table.leaf_words, np.int32)
    sizes = np.array(table.sizes, np.int64)
    launches = ctypes.c_int(-1)
    out = np.zeros((m, w), np.int32)
    assert keyed(ptr(x), ptr(keys), ptr(sblk), ptr(out), m, w, bits,
                 ptr(offs), ptr(lw), ptr(sizes), len(sizes), None,
                 ctypes.byref(launches)) == 0
    assert launches.value == -(-len(sizes) // 64)
    assert np.array_equal(out, want)
    # a table that does not end at column W is refused
    assert keyed(ptr(x), ptr(keys), ptr(sblk), ptr(out), m, w + 512, bits,
                 ptr(offs), ptr(lw), ptr(sizes), len(sizes), None,
                 ctypes.byref(launches)) != 0

    for nz in (noise, None):
        out = np.zeros((m, w), np.int32)
        assert plain(ptr(x), None if nz is None else ptr(nz), ptr(sblk),
                     ptr(out), m, w, bits, int(nz is not None), None) == 0
        assert np.array_equal(
            out, ref.quantize_pack_buffer_ref(x, sblk, bits, nz).numpy())


@pytest.mark.parametrize("stochastic", [True, False])
def test_b6_one_scale(host_lib, stochastic):
    fn = entry(host_lib("quantize_pack"), "quantize_pack",
               [P] * 4 + [ctypes.c_int] * 3 + [P])
    rng = np.random.default_rng(6)
    per, w = ref.planar_pad_len(3000, 8)
    x = torch.from_numpy((0.01 * rng.normal(size=(per, w))).astype(
        np.float32))
    s = torch.tensor([2e-4], dtype=torch.float32)
    noise = prng.uniform(prng.PRNGKey(3), (per, w)) if stochastic else None
    out = np.zeros(w, np.int32)
    assert fn(ptr(x), None if noise is None else ptr(noise), ptr(s),
              ptr(out), w, 8, int(stochastic), None) == 0
    assert np.array_equal(out, ref.quantize_pack_ref(x, s[0], 8,
                                                     noise).numpy())


def table_arrays(lay):
    t = lay.noise_table
    return (np.array(t.word_offsets, np.int32), np.array(t.leaf_words,
                                                          np.int32),
            np.array(t.sizes, np.int64))


def as_bits(t) -> np.ndarray:
    return np.asarray(t).view(np.int32)


@pytest.mark.parametrize("shapes", [RAGGED, MANY], ids=["5", "66"])
@pytest.mark.parametrize("bits,stochastic", [(8, True), (4, True),
                                             (8, False)])
def test_b4_keyed_tensor_and_plain_noise(host_lib, bits, stochastic,
                                         shapes):
    """B4 (one launch per 64 leaves when keyed) against the plain step +
    encode fed ``keyed_noise_ref``'s noise: words bitwise, y' and v' 0
    ulp, padding stepped (y, v and g are zero there) and drawing no bits.
    The tensor-noise entry, fed ``noise_stacked``, gives the same."""
    lib = host_lib("quantize_pack")
    keyed = entry(lib, "momentum_quantize_pack_buffer_keyed",
                  [P] * 9 + [ctypes.c_int] * 3 + [F32] * 2 + TABLE_ARGS)
    plain = entry(lib, "momentum_quantize_pack_buffer",
                  [P] * 9 + [ctypes.c_int] * 3 + [F32] * 2
                  + [ctypes.c_int, P])
    m = 3
    rng = np.random.default_rng(bits + 10 * stochastic + len(shapes))

    def tree(scale):
        return convert.params_from_numpy(
            {n: (scale * rng.normal(size=(m,) + s)).astype(np.float32)
             for n, s in shapes.items()}, device="cpu")

    tx = tree(0.3)
    lay = WireLayout.for_tree(tx, bits, stacked=True)
    x, y, v, g = (lay.to_planar_stacked(t).contiguous() for t in (
        tx, {n: t + 0.01 for n, t in tx.items()}, tree(0.01), tree(0.1)))
    e, th = np.float32(ETA), np.float32(THETA)
    delta = (y + (float(th) * v - float(e) * g)) - x
    sblk = lay.block_scales(lay.leaf_scales(
        delta, QuantConfig(bits=bits, stochastic=stochastic)))
    keys = _quant_leaf_keys(prng.PRNGKey(bits), lay.n_leaves,
                            m).contiguous()
    noise = (ref.keyed_noise_ref(keys, lay.noise_table, lay.per,
                                 lay.total_words) if stochastic else None)
    want = ref.momentum_quantize_pack_buffer_ref(y, v, g, x, sblk, bits,
                                                 (ETA, THETA), noise)
    w = lay.total_words

    def run(call):
        outs = [np.full(y.shape, np.nan, np.float32) for _ in range(2)]
        words = np.zeros((m, w), np.int32)
        head = (ptr(y), ptr(v), ptr(g), ptr(x))
        tail = (ptr(sblk), ptr(outs[0]), ptr(outs[1]), ptr(words), m, w,
                bits, ETA, THETA)
        assert call(head, tail) == 0
        for got, exp in zip(outs + [words], want):
            assert np.array_equal(as_bits(got), as_bits(exp))

    if stochastic:
        offs, lw, sizes = table_arrays(lay)
        launches = ctypes.c_int(-1)
        run(lambda head, tail: keyed(*head, ptr(keys), *tail, ptr(offs),
                                     ptr(lw), ptr(sizes), len(sizes), None,
                                     ctypes.byref(launches)))
        assert launches.value == -(-len(sizes) // 64)
        stacked_noise = lay.noise_stacked(keys).contiguous()
        assert torch.equal(stacked_noise, noise)
        run(lambda head, tail: plain(*head, ptr(stacked_noise), *tail, 1,
                                     None))
        # a table that does not end at column W is refused
        bad = np.zeros((m, w), np.int32)
        assert keyed(ptr(y), ptr(v), ptr(g), ptr(x), ptr(keys), ptr(sblk),
                     ptr(bad), ptr(bad), ptr(bad), m, w + 512, bits, ETA,
                     THETA, ptr(offs), ptr(lw), ptr(sizes), len(sizes),
                     None, ctypes.byref(launches)) != 0
    else:
        run(lambda head, tail: plain(*head, None, *tail, 0, None))


@pytest.mark.parametrize("momentum", [False, True], ids=["B2", "B5"])
@pytest.mark.parametrize("K", [1, 3, 5])
@pytest.mark.parametrize("bits", [2, 4, 8, 16])
def test_b2_b5_four_columns_a_thread(host_lib, bits, K, momentum):
    """B2 (and B5, which shares its body) against the plain gather +
    decode-apply, bitwise: every client's own stream first, then K - 1
    streams gathered from other clients through ``src``, over three lane
    blocks of different scales."""
    lib = host_lib("dequant_mix")
    m, per, w = 5, 32 // bits, 3 * ref.LANE_BLOCK
    rng = np.random.default_rng(100 * bits + 10 * K + momentum)
    base, v, g = (torch.from_numpy(
        (sc * rng.normal(size=(m, per, w))).astype(np.float32))
        for sc in (0.5, 0.01, 0.1))
    words = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (m, w),
                                          dtype=np.int64).astype(np.int32))
    sblk = torch.from_numpy(
        (rng.uniform(1e-4, 1e-2, (m, w // ref.LANE_BLOCK))).astype(
            np.float32))
    weights = torch.from_numpy(rng.uniform(0, 0.5, (m, K)).astype(
        np.float32))
    clients = np.arange(m)
    src = np.stack([clients] + [(clients + rng.integers(1, m, m)) % m
                                for _ in range(K - 1)]).astype(np.int32)
    assert (src[1:] != clients).all()
    src = torch.from_numpy(src)
    out = np.full((m, per, w), np.nan, np.float32)
    args = (ptr(base), ptr(words), ptr(sblk), ptr(weights), ptr(src))
    if momentum:
        fn = entry(lib, "dequant_mix_momentum_buffer",
                   [P] * 8 + [ctypes.c_int] * 5 + [F32] * 2 + [P])
        assert fn(*args, ptr(v), ptr(g), ptr(out), m, m, K, w, bits, ETA,
                  THETA, None) == 0
        want = dequant_mix_momentum_buffer_plain(
            base, words, sblk, weights, src, v, g, (ETA, THETA), bits)
        # W must be a multiple of 512
        assert fn(*args, ptr(v), ptr(g), ptr(out), m, m, K, w - 4, bits,
                  ETA, THETA, None) != 0
    else:
        fn = entry(lib, "dequant_mix_buffer",
                   [P] * 6 + [ctypes.c_int] * 5 + [P])
        assert fn(*args, ptr(out), m, m, K, w, bits, None) == 0
        want = dequant_mix_buffer_plain(base, words, sblk, weights, src,
                                        bits)
        assert fn(*args, ptr(out), m, m, K, w - 4, bits, None) != 0
    assert np.array_equal(as_bits(out), as_bits(want))



def b2_b5_entry(lib, momentum: bool):
    """B2's or B5's C entry with its argument types (the row count R
    after m)."""
    if momentum:
        return entry(lib, "dequant_mix_momentum_buffer",
                     [P] * 8 + [ctypes.c_int] * 5 + [F32] * 2 + [P])
    return entry(lib, "dequant_mix_buffer",
                 [P] * 6 + [ctypes.c_int] * 5 + [P])


@pytest.mark.parametrize("momentum", [False, True], ids=["B2", "B5"])
@pytest.mark.parametrize("bits", [4, 8])
def test_b2_b5_extended_rows(host_lib, bits, momentum):
    """A mesh shard's table: its m own rows, then R - m received rows
    (here copies of other rows, so the same result comes from the m-row
    table with ``src`` pointing at the originals) — bitwise with the plain
    version on both tables. The host side refuses R < m (entry and plain
    version) and a src entry >= R (plain version); the kernel reads no
    row past R and writes NaN for exactly the clients such an entry
    feeds."""
    lib = host_lib("dequant_mix")
    m, per, w, K = 3, 32 // bits, 2 * ref.LANE_BLOCK, 3
    rng = np.random.default_rng(7 * bits + momentum)
    base, v, g = (torch.from_numpy(
        (sc * rng.normal(size=(m, per, w))).astype(np.float32))
        for sc in (0.5, 0.01, 0.1))
    words = random_words(rng, (m, w))
    sblk = torch.from_numpy(rng.uniform(1e-4, 1e-2, (m, w // ref.LANE_BLOCK))
                            .astype(np.float32))
    weights = torch.from_numpy(rng.uniform(0, 0.5, (m, K)).astype(
        np.float32))
    picks = np.array([2, 0, 1, 2])            # received rows m .. m + 3
    words_ext = torch.cat([words, words[picks]])
    sblk_ext = torch.cat([sblk, sblk[picks]])
    R = m + len(picks)
    src_ext = torch.tensor([[0, 1, 2], [3, 4, 1], [5, 0, 6]],
                           dtype=torch.int32)
    src_m = torch.tensor([[0, 1, 2], [2, 0, 1], [1, 0, 2]],
                         dtype=torch.int32)
    fn = b2_b5_entry(lib, momentum)
    extra = (ptr(v), ptr(g)) if momentum else ()
    tail = (ETA, THETA) if momentum else ()

    def call(wd, sb, src, rows, out):
        return fn(ptr(base), ptr(wd), ptr(sb), ptr(weights), ptr(src),
                  *extra, ptr(out), m, rows, K, w, bits, *tail, None)

    def plain(wd, sb, src):
        if momentum:
            return dequant_mix_momentum_buffer_plain(
                base, wd, sb, weights, src, v, g, (ETA, THETA), bits)
        return dequant_mix_buffer_plain(base, wd, sb, weights, src, bits)

    out = np.full((m, per, w), np.nan, np.float32)
    assert call(words_ext, sblk_ext, src_ext, R, out) == 0
    want = plain(words, sblk, src_m)
    assert np.array_equal(as_bits(out), as_bits(want))
    assert torch.equal(plain(words_ext, sblk_ext, src_ext), want)
    # R < m: refused by the entry and by the plain version.
    assert call(words, sblk, src_m, m - 1, out) != 0
    with pytest.raises(ValueError, match="R >= m"):
        plain(words[:m - 1], sblk[:m - 1], src_m)
    # An entry >= R: refused on the host; the kernel feeds client 1 none
    # of it (no read past R rows) and writes NaN there only.
    bad = src_ext.clone()
    bad[2, 1] = R
    with pytest.raises(ValueError, match="src entries"):
        plain(words_ext, sblk_ext, bad)
    out = np.zeros((m, per, w), np.float32)
    assert call(words_ext, sblk_ext, bad, R, out) == 0
    assert np.isnan(out[1]).all()
    keep = [0, 2]
    assert np.array_equal(as_bits(out[keep]), as_bits(want[keep]))


def random_words(rng, shape) -> torch.Tensor:
    return torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, shape,
                                         dtype=np.int64).astype(np.int32))


def flat_xs(x: torch.Tensor):
    """x [n] twice: 16-byte aligned, and a view one float past a 16-byte
    boundary (the kernels' scalar path)."""
    spare = torch.empty(x.shape[0] + 1)
    return x.clone(), spare[1:].copy_(x)


def run_flat(call, n: int) -> torch.Tensor:
    """Call a flat entry into a fresh out of n values and a NaN guard
    past them; assert it succeeded and wrote nothing past n."""
    out = torch.full((n + 1,), float("nan"))
    assert call(ptr(out)) == 0
    assert torch.isnan(out[n])
    return out[:n]


@pytest.mark.parametrize("n", FLAT_N)
@pytest.mark.parametrize("K", [1, 3, 5, 9])
@pytest.mark.parametrize("bits", [2, 4, 8, 16])
def test_b7_flat_entry(host_lib, bits, K, n):
    """B7's C entry on a flat x [n], as ``dequant_mix_plan_flat`` calls
    it, bitwise against the plain plan decode of the zero-padded planar
    view sliced to n: K fixed at compile time (K <= 8) or in groups (9),
    x aligned and misaligned."""
    fn = entry(host_lib("dequant_mix"), "dequant_mix_plan", PLAN_ARGS)
    _, w = ref.planar_pad_len(n, bits)
    rng = np.random.default_rng(1000 * bits + 10 * K + n)
    xv = torch.from_numpy((0.5 * rng.normal(size=n)).astype(np.float32))
    streams = random_words(rng, (K, w))
    scales = torch.from_numpy(rng.uniform(1e-4, 1e-2, K).astype(np.float32))
    weights = torch.from_numpy(rng.uniform(0, 0.5, K).astype(np.float32))
    want = ref.dequant_mix_plan_ref(ref.pad_planar(xv, bits), streams,
                                    scales, weights, bits).reshape(-1)[:n]
    for x in flat_xs(xv):
        out = run_flat(lambda o: fn(ptr(x), ptr(streams), ptr(scales),
                                    ptr(weights), o, n, K, w, bits, None),
                     n)
        assert torch.equal(out.view(torch.int32), want.view(torch.int32))


def test_b7_flat_entry_checks(host_lib):
    """B7's C entry refuses bad bits, K = 0, a W that is not a multiple of
    512, an n that W does not fit as ``planar_pad_len`` sizes it, and a
    misaligned stack."""
    fn = entry(host_lib("dequant_mix"), "dequant_mix_plan", PLAN_ARGS)
    n, K, bits = 3000, 3, 8
    per, w = ref.planar_pad_len(n, bits)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    streams = random_words(rng, (K, w))
    scales, weights = torch.rand(K), torch.rand(K)
    misaligned = torch.empty(K * w + 1, dtype=torch.int32)[1:]

    def call(st=streams, n=n, K=K, w=w, bits=bits):
        out = torch.full((per * w,), float("nan"))
        return fn(ptr(x), ptr(st), ptr(scales), ptr(weights), ptr(out), n,
                  K, w, bits, None)

    assert call() == 0
    for bad in ({"bits": 3}, {"bits": 0}, {"K": 0}, {"w": w - 4},
                {"w": w + ref.LANE_BLOCK}, {"n": per * w + 1},
                {"n": per * (w - ref.LANE_BLOCK)}, {"st": misaligned}):
        assert call(**bad) != 0, bad


@pytest.mark.parametrize("w_self,w_nb", [(0.5, 0.25), (1 / 3, 1 / 3)])
@pytest.mark.parametrize("bits", [2, 4, 8, 16])
def test_b8_ring_entry(host_lib, bits, w_self, w_nb):
    """B8's own entry (three stream pointers, the weights by value) against
    the plain ring decode, bitwise, over six blocks of 256 columns of a
    full planar buffer (n = per * W, as the Pallas-shaped wrapper calls
    it)."""
    fn = entry(host_lib("dequant_mix"), "dequant_mix_ring", RING_ARGS)
    per, w = 32 // bits, 3 * ref.LANE_BLOCK
    n = per * w
    rng = np.random.default_rng(bits)
    x = torch.from_numpy((0.5 * rng.normal(size=(per, w))).astype(
        np.float32))
    q = [random_words(rng, w) for _ in range(3)]
    scales = torch.from_numpy(rng.uniform(1e-4, 1e-2, 3).astype(np.float32))
    out = np.full((per, w), np.nan, np.float32)
    ws, wn = float(np.float32(w_self)), float(np.float32(w_nb))
    assert fn(ptr(x), *(ptr(t) for t in q), ptr(scales), ws, wn, ptr(out), n,
              w, bits, None) == 0
    want = ref.dequant_mix_ref(x, *q, scales, bits, w_self, w_nb)
    assert np.array_equal(as_bits(out), as_bits(want))
    # W must be a multiple of 512, bits one of 2, 4, 8, 16
    assert fn(ptr(x), *(ptr(t) for t in q), ptr(scales), ws, wn, ptr(out),
              per * (w - 256), w - 256, bits, None) != 0
    assert fn(ptr(x), *(ptr(t) for t in q), ptr(scales), ws, wn, ptr(out), n,
              w, 3, None) != 0


@pytest.mark.parametrize("n", FLAT_N)
@pytest.mark.parametrize("bits", [2, 4, 8, 16])
def test_b8_ring_flat_entry(host_lib, bits, n):
    """B8's C entry on a flat x [n], as ``dequant_mix_flat`` calls it,
    bitwise against the plain ring decode of the zero-padded planar view
    sliced to n, x aligned and misaligned; an n that W does not fit is
    refused."""
    fn = entry(host_lib("dequant_mix"), "dequant_mix_ring", RING_ARGS)
    per, w = ref.planar_pad_len(n, bits)
    rng = np.random.default_rng(n + bits)
    xv = torch.from_numpy((0.5 * rng.normal(size=n)).astype(np.float32))
    q = [random_words(rng, w) for _ in range(3)]
    scales = torch.from_numpy(rng.uniform(1e-4, 1e-2, 3).astype(np.float32))
    ws, wn = float(np.float32(0.5)), float(np.float32(0.25))
    want = ref.dequant_mix_ref(ref.pad_planar(xv, bits), *q, scales, bits,
                               0.5, 0.25).reshape(-1)[:n]
    for x in flat_xs(xv):
        out = run_flat(lambda o: fn(ptr(x), *(ptr(t) for t in q),
                                    ptr(scales), ws, wn, o, n, w, bits,
                                    None), n)
        assert torch.equal(out.view(torch.int32), want.view(torch.int32))
    for bad_n in (per * w + 1, per * (w - ref.LANE_BLOCK)):
        assert fn(ptr(xv), *(ptr(t) for t in q), ptr(scales), ws, wn,
                  ptr(torch.empty(per * w + 1)), bad_n, w, bits, None) != 0


@pytest.mark.parametrize("form", ["host key", "device key", "tensor noise",
                                  "deterministic"])
@pytest.mark.parametrize("n", [3000, 199210])
@pytest.mark.parametrize("bits", [2, 4, 8, 16])
def test_b6_keyed_one_leaf(host_lib, bits, n, form):
    """B6 as ``encode_delta`` calls it, on a flat vector of n values padded
    to planar: keyed (the key by value, as a host key goes, or by pointer,
    as a device key goes) against ``prng.uniform(key, (per, W))`` + the
    plain encode, which is the noise of the JAX package's encode_delta;
    with tensor noise and deterministic against the plain encode."""
    lib = host_lib("quantize_pack")
    per, w = ref.planar_pad_len(n, bits)
    rng = np.random.default_rng(n + bits)
    x = torch.zeros(per * w)
    x[:n] = torch.from_numpy((0.01 * rng.normal(size=n)).astype(np.float32))
    x = x.reshape(per, w)
    s = (x.abs().amax() / (2 ** (bits - 1) - 1)).reshape(1)
    key = prng.split(prng.PRNGKey(n + bits), 2)[1].contiguous()
    noise = (None if form == "deterministic"
             else prng.uniform(key, (per, w)).contiguous())
    out = np.zeros(w, np.int32)
    if form in ("host key", "device key"):
        fn = entry(lib, "quantize_pack_keyed",
                   [P] * 2 + [ctypes.c_uint32] * 2 + [P] * 2
                   + [ctypes.c_int] * 2 + [P])
        k1, k2 = key.tolist()
        by_ptr = ptr(key) if form == "device key" else None
        if by_ptr is not None:
            k1 = k2 = 0
        assert fn(ptr(x), by_ptr, k1, k2, ptr(s), ptr(out), w, bits,
                  None) == 0
        # W must be a multiple of 512, bits one of 2, 4, 8, 16
        assert fn(ptr(x), by_ptr, k1, k2, ptr(s), ptr(out), w - 256, bits,
                  None) != 0
        assert fn(ptr(x), by_ptr, k1, k2, ptr(s), ptr(out), w, 0,
                  None) != 0
    else:
        fn = entry(lib, "quantize_pack", [P] * 4 + [ctypes.c_int] * 3 + [P])
        assert fn(ptr(x), None if noise is None else ptr(noise), ptr(s),
                  ptr(out), w, bits, int(noise is not None), None) == 0
    assert np.array_equal(out, ref.quantize_pack_ref(x, s[0], bits,
                                                     noise).numpy())


SPLIT_ARGS = [P, ctypes.c_int64, ctypes.c_int64, P, P]


def random_keys(rows: int, seed: int) -> torch.Tensor:
    """int64 [rows, 2] raw keys: both words over the whole uint32 range."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 2 ** 32, size=(rows, 2),
                                         dtype=np.int64))


@pytest.mark.parametrize("rows,num", [(1, 2), (1, 3), (16, 4), (96, 3),
                                      (7, 96), (3, 300)])
def test_t1_split_entry(host_lib, rows, num):
    """T1 (``threefry.cu``), one thread a new key, bitwise against
    ``prng.split_plain``; counts that are not positive are refused."""
    fn = entry(host_lib("threefry"), "threefry_split", SPLIT_ARGS)
    keys = random_keys(rows, rows * 1000 + num)
    out = np.full((rows, num, 2), -1, np.int64)
    assert fn(ptr(keys), rows, num, ptr(out), None) == 0
    assert np.array_equal(out, prng.split_plain(keys, num).numpy())
    for bad_rows, bad_num in ((0, num), (rows, 0), (-1, num), (rows, -2)):
        assert fn(ptr(keys), bad_rows, bad_num, ptr(out), None) != 0


@pytest.mark.parametrize("rows,n", [(1, 1), (4, 255), (16, 257), (3, 7005),
                                    (65535, 3)])
def test_t2_uniform_entry(host_lib, rows, n):
    """T2, one thread a draw over a grid of (blocks of a row, rows),
    bitwise against ``prng.uniform_plain``; counts that are not positive,
    more rows than one grid holds (65 535) or a row longer than one grid
    are refused."""
    fn = entry(host_lib("threefry"), "threefry_uniform", SPLIT_ARGS)
    keys = random_keys(rows, rows + n)
    out = np.full((rows, n), np.nan, np.float32)
    assert fn(ptr(keys), rows, n, ptr(out), None) == 0
    want = prng.uniform_plain(keys, (n,)).numpy()
    assert np.array_equal(out.view(np.int32), want.view(np.int32))
    for bad_rows, bad_n in ((0, n), (rows, 0), (-1, n), (rows, -5),
                            (65536, n), (1, 256 * 2 ** 31)):
        assert fn(ptr(keys), bad_rows, bad_n, ptr(out), None) != 0


@pytest.mark.parametrize("rows,n", [(1, 1), (1, 16), (16, 16), (96, 16),
                                    (4, 257), (65535, 3)])
def test_t3_bits_entry(host_lib, rows, n):
    """T3 (T2's kernel without the float), one thread a draw, bitwise
    against ``prng.random_bits_plain``: int64 values in [0, 2^32); the
    same refusals as T2."""
    fn = entry(host_lib("threefry"), "threefry_bits", SPLIT_ARGS)
    keys = random_keys(rows, 7 * rows + n)
    out = np.full((rows, n), -1, np.int64)
    assert fn(ptr(keys), rows, n, ptr(out), None) == 0
    assert np.array_equal(out, prng.random_bits_plain(keys, (n,)).numpy())
    for bad_rows, bad_n in ((0, n), (rows, 0), (-1, n), (rows, -5),
                            (65536, n), (1, 256 * 2 ** 31)):
        assert fn(ptr(keys), bad_rows, bad_n, ptr(out), None) != 0


@pytest.mark.parametrize("rows", [1, 5])
@pytest.mark.parametrize("data", [0, 1, 7, 0x61737963, 2 ** 32 - 1])
def test_t1_fold_in_entry(host_lib, rows, data):
    """T1's fold_in entry (one counter a key) bitwise against
    ``prng.fold_in_plain``, which is ``split(key, data + 1)[data]``; a
    data outside [0, 2^32) or no rows are refused."""
    fn = entry(host_lib("threefry"), "threefry_fold_in", SPLIT_ARGS)
    keys = random_keys(rows, rows + data % 1000)
    out = np.full((rows, 2), -1, np.int64)
    assert fn(ptr(keys), rows, data, ptr(out), None) == 0
    assert np.array_equal(out, prng.fold_in_plain(keys, data).numpy())
    if data < 1000:
        assert np.array_equal(out, prng.split_plain(keys, data + 1)[
            :, data].numpy())
    for bad_rows, bad_data in ((0, data), (rows, -1), (rows, 2 ** 32)):
        assert fn(ptr(keys), bad_rows, bad_data, ptr(out), None) != 0


@pytest.mark.parametrize("n", [1, 64, 300])
@pytest.mark.parametrize("key_rows", ["one", "each"])
def test_t1_fold_in_each_entry(host_lib, n, key_rows):
    """T1's batched fold_in (a counter a row, into one key or a key a
    row) bitwise against ``prng.fold_in_plain`` over a data tensor, and
    against the one-counter fold_in row by row; the data is taken modulo
    2^32 (negative and wide values included). No rows, or a key count
    neither 1 nor n, is refused."""
    fn = entry(host_lib("threefry"), "threefry_fold_in_each",
               [P, ctypes.c_int64, P, ctypes.c_int64, P, P])
    rows = 1 if key_rows == "one" else n
    keys = random_keys(rows, 3 * n + rows)
    rng = np.random.default_rng(n)
    data = torch.from_numpy(rng.integers(-2 ** 33, 2 ** 33, size=n,
                                         dtype=np.int64))
    data[0] = 0x61737963
    out = np.full((n, 2), -1, np.int64)
    assert fn(ptr(keys), rows, ptr(data), n, ptr(out), None) == 0
    want = prng.fold_in_plain(keys[0] if rows == 1 else keys, data)
    assert np.array_equal(out, want.numpy())
    for i in (0, n - 1):
        one = prng.fold_in_plain(keys[0 if rows == 1 else i],
                                 int(data[i]) % 2 ** 32)
        assert out[i].tolist() == one.tolist()
    for bad_rows, bad_n in ((rows, 0), (rows, -1), (2, n + 2)):
        assert fn(ptr(keys), bad_rows, ptr(data), bad_n, ptr(out),
                  None) != 0


@pytest.mark.parametrize("rows,n", [(1, 1), (1, 16), (16, 16), (4, 257),
                                    (3, 7005), (65535, 3)])
def test_t4_normal_entry(host_lib, rows, n):
    """T4 (T2's draw, then erf_inv's polynomial, times sqrt(2)), one
    thread a draw, against ``prng.normal_plain``: bitwise but where the
    host's log1pf rounds apart from torch's (T4_HOST_ULP); the same
    refusals as T2."""
    fn = entry(host_lib("threefry"), "threefry_normal", SPLIT_ARGS)
    keys = random_keys(rows, 11 * rows + n)
    out = np.full((rows, n), np.nan, np.float32)
    assert fn(ptr(keys), rows, n, ptr(out), None) == 0
    want = prng.normal_plain(keys, (n,)).numpy()
    a = out.view(np.int32).astype(np.int64)
    b = want.view(np.int32).astype(np.int64)
    assert np.abs(np.where(a < 0, -(a & 0x7FFFFFFF), a)
                  - np.where(b < 0, -(b & 0x7FFFFFFF), b)).max() <= T4_HOST_ULP
    for bad_rows, bad_n in ((0, n), (rows, 0), (-1, n), (rows, -5),
                            (65536, n), (1, 256 * 2 ** 31)):
        assert fn(ptr(keys), bad_rows, bad_n, ptr(out), None) != 0
