"""The CUDA sources of B1-B6, compiled for the host and run on the CPU
against their plain PyTorch versions.

``tests/cuda_host/cuda_runtime.h`` stands in for the CUDA runtime and the
device intrinsics these kernels use; every ``kernel<<<...>>>(args)`` launch
is rewritten into a loop over blocks and threads. So the kernels' own index
arithmetic runs here — block-to-leaf search, float4 and scalar paths, the
keyed noise's leaf lookup, counters and threefry rounds, B2's and B5's
four columns a thread and their stream gather — called through
their C entry points exactly as the wrappers call them. What it cannot show
(the device compiler, timing, memory coalescing) is left to
``chip_smoke.py`` on the card.

Contracts: words bitwise; B2-B5 float outputs bitwise.
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
from repro_torch.kernels.momentum_sgd import out_offsets  # noqa: E402

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
F32 = ctypes.c_float
TABLE_ARGS = [P] * 3 + [ctypes.c_int] + [P] * 2
ETA, THETA = 0.05, 0.9


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
                   [P] * 8 + [ctypes.c_int] * 4 + [F32] * 2 + [P])
        assert fn(*args, ptr(v), ptr(g), ptr(out), m, K, w, bits, ETA,
                  THETA, None) == 0
        want = dequant_mix_momentum_buffer_plain(
            base, words, sblk, weights, src, v, g, (ETA, THETA), bits)
        # W must be a multiple of 512
        assert fn(*args, ptr(v), ptr(g), ptr(out), m, K, w - 4, bits, ETA,
                  THETA, None) != 0
    else:
        fn = entry(lib, "dequant_mix_buffer",
                   [P] * 6 + [ctypes.c_int] * 4 + [P])
        assert fn(*args, ptr(out), m, K, w, bits, None) == 0
        want = dequant_mix_buffer_plain(base, words, sblk, weights, src,
                                        bits)
        assert fn(*args, ptr(out), m, K, w - 4, bits, None) != 0
    assert np.array_equal(as_bits(out), as_bits(want))

