"""The port's counting tools (``repro_torch.launch.cost_model``,
``launch.hlo_stats``) and the kernels' byte records against the JAX
package's ``launch/cost_model.py`` and ``launch/hlo_stats.py``, on the
CPU.

* ``_wire_bytes`` equals the reference's for every kind and group size
  1..8;
* the reference's scan-of-matmuls and grad checks
  (``tests/test_hlo_stats.py``) as Python loops: matmul FLOPs exact, a
  gradient more than twice the forward, and a checkpointed loop's
  recompute adding exactly one forward's matmuls (the reference counts
  a remat'd forward through the jaxpr of ``jax.grad``; the port sees
  ``torch.utils.checkpoint`` recompute in the backward pass);
* each kernel entry's byte record (B1-B8, the tensor-noise entries) at
  the quickstart's wire shapes against the bytes of the reference's
  ``pallas_call`` equation in ``jax.make_jaxpr`` of its Pallas function
  (trace only), exact: equal, or off by a named operand the port does
  not have or has (the (1, 2) f32 ``et`` operand B3, B4 and B5 take as
  kernel parameters by value; the ``src`` table [K, m] int32 B2 and B5
  gather their streams through); the same on ``meta`` and CPU tensors;
* ``bench.timevarying.tail_kernel_bytes`` against the reference's
  ``pallas_call``-only bytes of its ``tail_unfused`` / ``tail_fused``,
  kernel by kernel under the same named relations (and B3's rows: the
  Pallas wrapper pads [4, W] to [8, W]);
* the collective recorder: a quantized round on a 4-shard test mesh
  records exactly the mixer's ``shipped_bytes`` as permutes; a (2, 2)
  tensor-parallel 2NN round records the all-reduce, all-gather and
  reduce-scatter bytes counted from the leaf shapes and ``_wire_bytes``;
* ``apply_moe`` under ``MOE_GROUPS = (g, None)`` (g = 1, 2, 4, with
  capacity drops) and under ``MOE_SHARD_MAP`` within 1e-5 of the
  reference's;
* the meta evaluation's two memos (an op's output metadata, a shard's
  ``local_train`` call) keep every count.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch import hlo_stats as r_hlo  # noqa: E402
from repro.launch.cost_model import _eqn_bytes, _sub_jaxprs  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch import core as T  # noqa: E402
from repro_torch.core.wire_layout import WireLayout  # noqa: E402
from repro_torch.kernels import (dequant_mix, dequant_mix_buffer,  # noqa: E402
                                 dequant_mix_momentum_buffer,
                                 dequant_mix_plan,
                                 momentum_quantize_pack_buffer, momentum_sgd,
                                 native, quantize_pack, quantize_pack_buffer)
from repro_torch.launch import hlo_stats  # noqa: E402
from repro_torch.launch.cost_model import structural_costs  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# The quickstart's 2NN (784-200-200-10) at 8 bits: its wire layout.
LEAVES_2NN = {"w1": (784, 200), "b1": (200,), "w2": (200, 200),
              "b2": (200,), "w3": (200, 10), "b3": (10,)}
LAYOUT = WireLayout.for_tree(
    {n: torch.empty(s, device="meta") for n, s in LEAVES_2NN.items()}, 8)
PER, W = LAYOUT.per, LAYOUT.total_words
NB = W // 512
K = 3                     # the own stream and two ring neighbours'
ET_BYTES = 2 * 4          # the Pallas kernels' (1, 2) f32 (eta, theta)
SRC_BYTES = K * 1 * 4     # the port's src [K, m] int32, one client


def pallas_bytes(fn, *args) -> list:
    """The bytes of every ``pallas_call`` equation in the jaxpr of
    ``fn(*args)``, in program order (the reference's ``_eqn_bytes``)."""
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "pallas_call":
                found.append(_eqn_bytes(eqn))
            else:
                for sub in _sub_jaxprs(eqn):
                    walk(sub.jaxpr)
    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return found


def records(fn, *args) -> list:
    """The kernel records ``fn(*args)`` reports, in call order."""
    got = []
    native.RECORDERS.append(got.append)
    try:
        fn(*args)
    finally:
        native.RECORDERS.remove(got.append)
    return got


@pytest.mark.parametrize("kind", r_hlo._COLLECTIVES)
def test_wire_bytes_equal_the_reference(kind):
    for g in range(1, 9):
        for result in (0, 4, 1000, 12345, 2 ** 33 + 7):
            assert hlo_stats._wire_bytes(kind, result, g) == \
                r_hlo._wire_bytes(kind, result, g), (kind, g, result)


def test_loop_of_matmuls_counts_every_trip():
    """The reference's scan of 10 matmuls as a Python loop: every trip
    seen, the matmul FLOPs exact (the total within the reference's 20 %)."""
    def f(x):
        c = torch.eye(16, device=x.device)
        for _ in range(10):
            c = c @ x
        return c

    want = 10 * 2 * 16 ** 3
    costs = structural_costs(f, torch.empty(16, 16, device="meta"))
    assert costs.matmul_flops == want
    assert abs(costs.flops - want) / want < 0.2


def _loop_loss(w, x, remat=False):
    def block(h, wi):
        return torch.tanh(h @ wi)
    h = x
    for i in range(w.shape[0]):
        h = (torch.utils.checkpoint.checkpoint(block, h, w[i],
                                               use_reentrant=False)
             if remat else block(h, w[i]))
    return (h ** 2).sum()


def test_grad_counts_the_backward_and_the_recompute():
    w = torch.empty(6, 32, 32, device="meta", requires_grad=True)
    x = torch.empty(4, 32, device="meta")

    def grad(remat):
        return lambda w, x: torch.autograd.grad(_loop_loss(w, x, remat), w)

    c_fwd = structural_costs(_loop_loss, w, x)
    c_grad = structural_costs(grad(False), w, x)
    c_remat = structural_costs(grad(True), w, x)
    one = 2 * 4 * 32 * 32                        # one layer's product
    assert c_fwd.matmul_flops == 6 * one
    assert c_grad.flops > 2 * c_fwd.flops        # bwd ~ 2x fwd matmuls
    # forward, the six weight gradients, five input gradients (x needs
    # none)
    assert c_grad.matmul_flops == (6 + 6 + 5) * one
    assert c_remat.matmul_flops == c_grad.matmul_flops + c_fwd.matmul_flops


# ---------------------------------------------------------------------------
# Kernel byte records against the Pallas equations
# ---------------------------------------------------------------------------

def _sds(*shape, dtype=jnp.float32):
    return jax.ShapeDtypeStruct(shape, dtype)


def _t(*shape, dtype=torch.float32, device="meta"):
    return torch.zeros(shape, dtype=dtype, device=device)


def _kernel_cases(device):
    """name -> (the reference's call, its ShapeDtypeStructs, the port's
    call, the port's tensors, port bytes - Pallas bytes)."""
    from repro.kernels import dequant_mix as r_dm
    from repro.kernels import momentum_sgd as r_ms
    from repro.kernels import quantize_pack as r_qp

    buf, one = _sds(PER, W), _t(1, PER, W, device=device)
    flat = _t(PER, W, device=device)
    streams = _t(K, W, dtype=torch.int32, device=device)
    sblk = _t(K, NB, device=device)
    src = torch.arange(K, dtype=torch.int32,
                       device=device).reshape(K, 1)
    weights = _t(1, K, device=device)
    et = jnp.asarray([0.05, 0.9], jnp.float32)
    return {
        "B1": (lambda x, s, n: r_qp.quantize_pack_buffer_pallas(
                   x, s, n, bits=8, stochastic=True),
               (buf, _sds(1, NB), buf),
               lambda x, s, n: quantize_pack_buffer(x, s, 8, n),
               (one, _t(1, NB, device=device), one), 0),
        "B2": (lambda x, q, s, w: r_dm.dequant_mix_buffer_pallas(
                   x, q, s, w, bits=8),
               (buf, _sds(K, W, dtype=jnp.uint32), _sds(K, NB), _sds(K)),
               lambda x, q, s, w, i: dequant_mix_buffer(x, q, s, w, i, 8),
               (one, streams, sblk, weights, src), SRC_BYTES),
        # [8, W] takes no row padding in the Pallas wrapper.
        "B3": (lambda y, v, g: r_ms.momentum_sgd_pallas(
                   y, v, g, eta=0.05, theta=0.9),
               (_sds(8, W),) * 3,
               lambda y, v, g: momentum_sgd(y, v, g, 0.05, 0.9),
               (_t(8, W, device=device),) * 3, -ET_BYTES),
        "B4": (lambda y, v, g, x, s, n: (
                   r_qp.momentum_quantize_pack_buffer_pallas(
                       y, v, g, x, s, n, et, bits=8, stochastic=True)),
               (buf,) * 4 + (_sds(1, NB), buf),
               lambda y, v, g, x, s, n: momentum_quantize_pack_buffer(
                   y, v, g, x, s, 8, (0.05, 0.9), n),
               (one,) * 4 + (_t(1, NB, device=device), one), -ET_BYTES),
        "B5": (lambda x, q, s, w, v, g: (
                   r_dm.dequant_mix_momentum_buffer_pallas(
                       x, q, s, w, v, g, et, bits=8)),
               (buf, _sds(K, W, dtype=jnp.uint32), _sds(K, NB), _sds(K),
                buf, buf),
               lambda x, q, s, w, i, v, g: dequant_mix_momentum_buffer(
                   x, q, s, w, i, v, g, (0.05, 0.9), 8),
               (one, streams, sblk, weights, src, one, one),
               SRC_BYTES - ET_BYTES),
        "B6": (lambda x, s, n: r_qp.quantize_pack_pallas(
                   x, s, n, bits=8, stochastic=True),
               (buf, _sds(), buf),
               lambda x, s, n: quantize_pack(x, s, 8, n),
               (flat, _t(1, device=device), flat), 0),
        "B7": (lambda x, q, s, w: r_dm.dequant_mix_plan_pallas(
                   x, q, s, w, bits=8),
               (buf, _sds(K, W, dtype=jnp.uint32), _sds(K), _sds(K)),
               lambda x, q, s, w: dequant_mix_plan(x, q, s, w, 8),
               (flat, streams, _t(K, device=device),
                _t(K, device=device)), 0),
        "B8": (lambda x, a, b, c, s: r_dm.dequant_mix_pallas(
                   x, a, b, c, s, bits=8, w_self=0.5, w_nb=0.25),
               (buf,) + (_sds(W, dtype=jnp.uint32),) * 3 + (_sds(3),),
               lambda x, a, b, c, s: dequant_mix(x, a, b, c, s, 8, 0.5,
                                                 0.25),
               (flat,) + (_t(W, dtype=torch.int32, device=device),) * 3
               + (_t(3, device=device),), 0),
    }


@pytest.mark.parametrize("name", [f"B{i}" for i in range(1, 9)])
def test_kernel_bytes_equal_the_pallas_equation(name):
    """Trace only: one ``pallas_call`` and one record, exact under the
    named relation; the record is the same on meta and on the CPU, and
    ``structural_costs`` counts it once (no aten operation inside)."""
    ref_fn, sds, fn, args, delta = _kernel_cases("meta")[name]
    (want,) = pallas_bytes(ref_fn, *sds)
    (rec,) = records(fn, *args)
    assert rec.bytes == want + delta, (name, rec, want)
    assert rec.launches == 1
    _, _, fn_cpu, args_cpu, _ = _kernel_cases("cpu")[name]
    (rec_cpu,) = records(fn_cpu, *args_cpu)
    assert rec_cpu == rec
    costs = structural_costs(fn, *args)
    assert costs.bytes == costs.kernel_bytes == rec.bytes
    assert costs.kernels == {rec.name: {"calls": 1, "launches": 1,
                                        "bytes": rec.bytes}}


def test_tail_kernel_bytes_against_the_reference():
    """The fused tail's kernels against the unfused tail's, as the
    reference's ``bench_timevarying`` traces them, kernel by kernel: B3
    at the tail's [4, W] buffer (the Pallas wrapper pads it to [8, W] and
    takes et), B1 equal, B2 +src, B4 -et, B5 +src -et."""
    from repro.kernels.dequant_mix import (dequant_mix_buffer_pallas,
                                           dequant_mix_momentum_buffer_pallas)
    from repro.kernels.momentum_sgd import momentum_sgd_pallas
    from repro.kernels.quantize_pack import (
        momentum_quantize_pack_buffer_pallas, quantize_pack_buffer_pallas)
    from repro_torch.bench.timevarying import tail_kernel_bytes

    d = 16384
    from repro.core.wire_layout import WireLayout as RLayout
    lay = RLayout.for_tree({"w": jnp.zeros((d,), jnp.float32)}, bits=8)
    per, wd = 4, lay.total_words
    buf = _sds(per, wd)
    u32s, sb, wts = (_sds(K, wd, dtype=jnp.uint32), _sds(K, wd // 512),
                     _sds(K))

    def tail_unfused(y, v, g, x, streams, sblk, w):
        y, v = momentum_sgd_pallas(y, v, g, eta=0.05, theta=0.9)
        y, v = momentum_sgd_pallas(y, v, g, eta=0.05, theta=0.9)
        words = quantize_pack_buffer_pallas(
            y - x, sblk[:1], jnp.zeros_like(y), bits=8, stochastic=False)
        return dequant_mix_buffer_pallas(x, streams, sblk, w, bits=8), words

    def tail_fused(y, v, g, x, streams, sblk, w, et):
        y1, v1, words = momentum_quantize_pack_buffer_pallas(
            y, v, g, x, sblk[:1], jnp.zeros_like(y), et, bits=8,
            stochastic=False)
        return dequant_mix_momentum_buffer_pallas(
            x, streams, sblk, w, v1, g, et, bits=8), words

    ref_u = pallas_bytes(tail_unfused, buf, buf, buf, buf, u32s, sb, wts)
    ref_f = pallas_bytes(tail_fused, buf, buf, buf, buf, u32s, sb, wts,
                         _sds(1, 2))
    b3_pad = 5 * (8 - per) * wd * 4          # the two padded rows' passes
    want_u = [ref_u[0] - b3_pad - ET_BYTES, ref_u[1] - b3_pad - ET_BYTES,
              ref_u[2], ref_u[3] + SRC_BYTES]
    want_f = [ref_f[0] - ET_BYTES, ref_f[1] - ET_BYTES + SRC_BYTES]
    got = tail_kernel_bytes(d)
    assert got == {"unfused": sum(want_u), "fused": sum(want_f)}
    assert 1.0 - got["fused"] / got["unfused"] > 0.0


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def test_recorded_permutes_equal_the_shipped_bytes(monkeypatch):
    """A quantized quickstart round (the 2NN, ring of 8, q8 stochastic)
    on a 4-shard test mesh: one permute a payload, their sum the wire's
    ``shipped_bytes``."""
    from repro_torch.bench.common import loss_2nn, stacked_2nn
    from repro_torch.core import mixing

    wires = []
    exchange = mixing._exchange

    def spy(wire, streams):
        got = exchange(wire, streams)
        wires.append(wire.shipped_bytes)
        return got

    monkeypatch.setattr(mixing, "_exchange", spy)
    m, k_steps = 8, 2
    mesh = make_test_mesh(4, "cpu")
    cfg = T.DFedAvgMConfig(eta=0.05, theta=0.9, local_steps=k_steps,
                           quant=T.QuantConfig(bits=8))
    step = T.make_round_step(loss_2nn, cfg, T.MixingSpec.ring(m),
                             device="cpu", mesh=mesh)
    rng = np.random.default_rng(0)
    batches = {"x": torch.tensor(rng.normal(size=(m, k_steps, 4, 784)),
                                 dtype=torch.float32),
               "y": torch.tensor(rng.integers(0, 10, size=(m, k_steps, 4)))}
    st = T.init_round_state(stacked_2nn(m, 0, "cpu"), prng.PRNGKey(1),
                            mesh=mesh)
    with hlo_stats.collect_collectives() as stats:
        step(st, batches)
    assert len(wires) == 1 and wires[0] > 0
    assert stats.wire_bytes == stats.by_kind["collective-permute"] == \
        wires[0]
    assert set(stats.by_kind) == {"collective-permute"}
    assert stats.counts["collective-permute"] == 4 * 2   # 2 a shard


def test_tensor_parallel_round_records_its_column_collectives():
    """A (2, 2) tensor-parallel fp32 round of the 2NN under the hand
    specs (w1 by columns, w2 and w3 by rows, the biases cut): each local
    step of each row broadcasts x (all-gather), gathers b2 and b3
    (all-gather, their gradients reduce-scattered) and sums the two
    row-parallel layers' partials (all-reduce, their gradients
    all-gathered), each recorded as g = 2 times ``_wire_bytes``."""
    from repro_torch.models.paper_nets import init_2nn, make_2nn_loss
    from repro_torch.sharding import P

    m, k_steps, b, d_in, hid, cls = 4, 2, 4, 32, 16, 8
    specs = {"w1": P("clients", None, "model"), "b1": P("clients", "model"),
             "w2": P("clients", "model", None), "b2": P("clients", "model"),
             "w3": P("clients", "model", None), "b3": P("clients", "model")}
    mesh = make_test_mesh(2, "cpu", model_parallel=2)
    p0 = init_2nn(0, d_in=d_in, d_hidden=hid, n_classes=cls, device="cpu")
    stacked = {n: v[None].expand((m,) + tuple(v.shape)).contiguous()
               for n, v in p0.items()}
    rng = np.random.default_rng(3)
    batches = {"x": torch.tensor(rng.normal(size=(m, k_steps, b, d_in)),
                                 dtype=torch.float32),
               "y": torch.tensor(rng.integers(0, cls, size=(m, k_steps, b)))}
    step = T.make_round_step(make_2nn_loss(), T.DFedAvgMConfig(
        eta=0.05, theta=0.9, local_steps=k_steps), T.MixingSpec.ring(m),
        device="cpu", mesh=mesh, param_specs=specs)
    assert step.local_step == "tensor_parallel"
    st = T.init_round_state(stacked, prng.PRNGKey(1), mesh=mesh,
                            param_specs=specs)
    with hlo_stats.collect_collectives() as stats:
        step(st, batches)

    g, ml, f = 2, m // 2, 4
    results = {
        "all-gather": [ml * b * d_in, ml * hid, ml * cls,      # forward
                       ml * b * hid, ml * b * cls],           # backward
        "all-reduce": [ml * b * hid, ml * b * cls],
        "reduce-scatter": [ml * hid // g, ml * cls // g]}
    steps = mesh.n_shards * k_steps
    for kind, sizes in results.items():
        want = steps * sum(g * r_hlo._wire_bytes(kind, n * f, g)
                           for n in sizes)
        assert stats.by_kind[kind] == want, kind
        assert stats.counts[kind] == steps * len(sizes), kind


# ---------------------------------------------------------------------------
# MoE dispatch groups
# ---------------------------------------------------------------------------

def _moe_inputs(seed=0):
    rng = np.random.default_rng(seed)
    b, l, d, e, f = 2, 16, 32, 4, 48
    x = rng.normal(size=(b, l, d)).astype(np.float32)
    p = {"router": rng.normal(size=(d, e)).astype(np.float32),
         **{n: rng.normal(size=s).astype(np.float32) * 0.3
            for n, s in (("wg", (e, d, f)), ("wu", (e, d, f)),
                         ("wd", (e, f, d)))}}
    return x, p


@pytest.mark.parametrize("g", [1, 2, 4])
def test_moe_groups_against_the_reference(g):
    """Two clients, each routing its 32 tokens in g dispatch groups at
    capacity factor 0.5 (drops in every group): outputs within 1e-5 and
    the pooled load-balance loss within 1e-6 of the reference's."""
    from repro.models import moe as r_moe
    from repro_torch.models import moe as t_moe

    xs, ps = zip(*(_moe_inputs(seed) for seed in (0, 1)))
    want, waux = [], []
    for x, p in zip(xs, ps):
        tok = r_moe.MOE_GROUPS.set((g, None))
        try:
            o, a = r_moe.apply_moe(jax.tree.map(jnp.asarray, p),
                                   jnp.asarray(x), top_k=2,
                                   capacity_factor=0.5)
        finally:
            r_moe.MOE_GROUPS.reset(tok)
        want.append(np.asarray(o))
        waux.append(float(a))
    tok = t_moe.MOE_GROUPS.set((g, None))
    try:
        got, gaux = t_moe.apply_moe(
            {n: torch.from_numpy(np.stack([p[n] for p in ps]))
             for n in ps[0]},
            torch.from_numpy(np.stack(xs)), top_k=2, capacity_factor=0.5)
    finally:
        t_moe.MOE_GROUPS.reset(tok)
    np.testing.assert_allclose(got.numpy(), np.stack(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(gaux.numpy(), waux, rtol=1e-6)


def test_moe_shard_map_grouping_against_the_reference():
    """``MOE_SHARD_MAP`` over a (4, 2) ("data", "model") mesh: the
    reference's shard_map MoE (4 host devices' groups, d_ff over 2) and
    the port's grouping of one client's tokens in 4 groups with the mean
    of their load-balance losses, within 1e-5."""
    import subprocess
    import sys
    import textwrap
    import types

    from repro_torch.models import moe as t_moe

    x, p = _moe_inputs(2)
    code = textwrap.dedent("""
        import os, sys
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import numpy as np, jax, jax.numpy as jnp
        from repro.launch.mesh import make_test_mesh
        from repro.models import moe
        d = np.load(sys.argv[1])
        p = {n: jnp.asarray(d[n]) for n in ("router", "wg", "wu", "wd")}
        mesh = make_test_mesh((4, 2), ("data", "model"))
        tok = moe.MOE_SHARD_MAP.set((mesh, ("data",), ("model",)))
        with jax.set_mesh(mesh):
            out, aux = jax.jit(lambda p, x: moe.apply_moe(
                p, x, top_k=2, capacity_factor=0.5))(p, jnp.asarray(d["x"]))
        np.save(sys.argv[2], np.asarray(out))
        print(float(aux))
    """)
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(f"{tmp}/in.npz", x=x, **p)
        res = subprocess.run([sys.executable, "-c", code, f"{tmp}/in.npz",
                              f"{tmp}/out.npy"], capture_output=True,
                             text=True, timeout=240,
                             env={**__import__("os").environ,
                                  "JAX_PLATFORMS": "cpu"})
        assert res.returncode == 0, res.stderr[-3000:]
        want = np.load(f"{tmp}/out.npy")
        waux = float(res.stdout.strip().splitlines()[-1])
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty((4, 2)))
    tok = t_moe.MOE_SHARD_MAP.set((mesh, ("data",), ("model",)))
    try:
        got, gaux = t_moe.apply_moe(
            {n: torch.from_numpy(v)[None] for n, v in p.items()},
            torch.from_numpy(x)[None], top_k=2, capacity_factor=0.5)
    finally:
        t_moe.MOE_SHARD_MAP.reset(tok)
    np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(gaux[0]), waux, rtol=1e-5)


def test_meta_memos_keep_the_counts(monkeypatch):
    """On ``meta`` the evaluation memoizes each functional op's output
    metadata and each shard's ``local_train`` call: the reduced SmolLM's
    tensor-parallel round on a (4, 2) mesh of meta cells counts the same
    FLOPs, bytes, kernel records and collectives with both memos off."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import dfedavgm, local_sgd
    from repro_torch.launch import build, cost_model
    from repro_torch.launch.mesh import make_named_mesh

    from repro_torch.configs.base import InputShape

    def count():
        built = build.build_train_step(
            reduced(get_config("smollm-135m")),
            make_named_mesh((4, 2), ("data", "model"), device="meta"),
            InputShape("t", 64, 8, "train"))
        c = structural_costs(built.fn, *built.args)
        return (c.flops, c.matmul_flops, c.bytes, c.kernel_bytes, c.kernels,
                c.coll_bytes, c.coll_by_kind)

    memoized = count()
    plain = local_sgd.local_train.__wrapped__
    monkeypatch.setattr(local_sgd, "local_train", plain)
    monkeypatch.setattr(dfedavgm, "local_train", plain)
    monkeypatch.setattr(cost_model, "_meta_call",
                        lambda memo, func, args, kwargs: func(*args,
                                                              **kwargs))
    assert count() == memoized
