"""The tensor-parallel local step on a 2D (clients, model) mesh, on the
CPU: the column-parallel blocks against the port's unsharded blocks, the
whole dense model's column-parallel loss against the JAX package's
``loss_fn``, and the 2NN's tensor-parallel round against the reference's
dense trajectory and the port's 1D mesh.

* Blocks, forward and every gradient within rtol 1e-5 (f32) of the
  leaf's or output's largest magnitude: the MLP, attention with its
  heads cut, attention with its heads cut and its KV heads replicated
  (a uniform grouping, and one where a column's query heads read KV
  heads unevenly), the vocabulary-parallel embedding (bitwise: one
  column holds each token) and the vocabulary-parallel logits with the
  cross-column f32 log-softmax. SmolLM-135M reduced with its 9 query and
  3 KV heads at mp 3 (heads cut), OLMo-1B reduced at mp 2 and 4, and
  Qwen3-shaped reduced configs (qk-norm) whose KV heads mp does not
  divide.
* The whole model: the column-parallel loss and gradients of a mesh row
  against ``repro.models.model.loss_fn`` (vmapped ``value_and_grad``):
  loss within 1e-5, gradients within 1e-4, the tolerances of
  ``tests/test_torch_models.py``.
* The 2NN round under the reference's hand specs: on ``make_test_mesh(2,
  model_parallel=4)`` within 2e-5 of the reference's dense trajectory;
  against the port's 1D mesh within rtol 1e-5 in fp32, and at q8
  stochastic the loss and consensus within 1e-5 and the wire codes of a
  round equal but for a counted number of flipped rounding decisions,
  bounded by their expectation.
* Properties: replicated leaves stay bitwise equal across a shard's
  columns round after round (synchronous, compute-skip and async); the
  round, its metrics and an async event call neither ``join_columns``
  nor ``cut_columns``; B3 runs n_shards x mp x K times a round;
  ``local_step`` says which step a round takes.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as rcfg  # noqa: E402
from repro import core as J  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models.paper_nets import apply_2nn as j_apply_2nn  # noqa: E402
from repro.models.paper_nets import init_2nn as j_init_2nn  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch import core as T  # noqa: E402
from repro_torch.core import local_sgd  # noqa: E402
from repro_torch.core.async_gossip import init_async_state  # noqa: E402
from repro_torch.core.mixing import _column_dims  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models import attention as t_att  # noqa: E402
from repro_torch.models import layers as t_lay  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.paper_nets import (init_2nn,  # noqa: E402
                                           make_2nn_loss)
from repro_torch.sharding import RULES_A, P, specs_for_tree  # noqa: E402
from repro_torch.sharding.tensor_parallel import ColumnGroup  # noqa: E402

torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

RTOL, LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-5, 1e-4
M = 8
PS_2NN = {"w1": P("clients", None, "model"), "b1": P("clients", "model"),
          "w2": P("clients", "model", None), "b2": P("clients", "model"),
          "w3": P("clients", "model", None), "b3": P("clients", "model")}
# Reduced configs of the dense family: (arch, overrides, mp).
SMOL_9_3 = ("smollm-135m", dict(n_heads=9, n_kv_heads=3, d_ff=384,
                                vocab_size=384), 3)
OLMO_2 = ("olmo-1b", {}, 2)
OLMO_4 = ("olmo-1b", {}, 4)
QWEN_8_2 = ("qwen3-32b", dict(n_heads=8, n_kv_heads=2), 4)
QWEN_6_3 = ("qwen3-32b", dict(n_heads=6, n_kv_heads=3, d_ff=512), 2)
CASES = {"smollm-9q3kv-mp3": SMOL_9_3, "olmo-mp2": OLMO_2,
         "olmo-mp4": OLMO_4, "qwen3-8q2kv-mp4": QWEN_8_2,
         "qwen3-6q3kv-mp2": QWEN_6_3}


def cfgs(case):
    arch, over, mp = CASES[case]
    rc = dataclasses.replace(rcfg.reduced(rcfg.get_config(arch)), **over)
    tc = dataclasses.replace(tcfg.reduced(tcfg.get_config(arch)), **over)
    return rc, tc, mp


def close(got, want, rtol, what=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want.detach() if isinstance(want, torch.Tensor)
                      else want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (what, err, scale)


def group_of(mp, dims=None):
    return ColumnGroup(["cpu"] * mp, dims or {})


def parts_of(t, dim, mp):
    """A leaf's column slices along ``dim``, each a leaf of its own."""
    return [p.clone().requires_grad_(True) for p in t.chunk(mp, dim=dim)]


def leaf(t):
    return t.clone().requires_grad_(True)


def grads_match(out_tp, out_full, tp_leaves, full_leaves, what):
    """Forward within RTOL; the gradients of one random projection of the
    outputs within RTOL, a cut leaf's slices concatenated on its dim."""
    close(out_tp, out_full, RTOL, what + " forward")
    r = torch.randn(out_full.shape, generator=torch.Generator()
                    .manual_seed(5), dtype=out_full.dtype)
    g_tp = torch.autograd.grad((out_tp * r).sum(),
                               [p for ps, _ in tp_leaves.values()
                                for p in (ps if isinstance(ps, list)
                                          else [ps])])
    g_full = torch.autograd.grad((out_full * r).sum(),
                                 list(full_leaves.values()))
    it = iter(g_tp)
    for (name, (ps, dim)), gf in zip(tp_leaves.items(), g_full):
        if isinstance(ps, list):
            got = torch.cat([next(it) for _ in ps], dim=dim)
        else:
            got = next(it)
        close(got, gf, RTOL, f"{what} grad {name}")


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def block_params(tc, seed=0, m=2):
    """One layer's leaves of a dense block with a client axis, and x."""
    g = torch.Generator().manual_seed(seed)
    d, hd, H, KV, F = (tc.d_model, tc.head_dim, tc.n_heads, tc.n_kv_heads,
                       tc.d_ff)

    def w(*shape, fan):
        return torch.randn((m,) + shape, generator=g) / fan ** 0.5
    p = {"attn/wq": w(d, H, hd, fan=d), "attn/wk": w(d, KV, hd, fan=d),
         "attn/wv": w(d, KV, hd, fan=d), "attn/wo": w(H, hd, d, fan=H * hd),
         "mlp/wg": w(d, F, fan=d), "mlp/wu": w(d, F, fan=d),
         "mlp/wd": w(F, d, fan=F)}
    if tc.qk_norm:
        p["attn/q_norm"] = 1 + 0.1 * torch.randn((m, hd), generator=g)
        p["attn/k_norm"] = 1 + 0.1 * torch.randn((m, hd), generator=g)
    x = torch.randn((m, 2, 12, d), generator=g)
    return p, x


@pytest.mark.parametrize("case", ["smollm-9q3kv-mp3", "olmo-mp2",
                                  "olmo-mp4"])
def test_mlp_block_column_parallel(case):
    _, tc, mp = cfgs(case)
    p, x = block_params(tc)
    mlp = {n[4:]: t for n, t in p.items() if n.startswith("mlp/")}
    dims = {"wg": 2, "wu": 2, "wd": 1}
    cut = {n: (parts_of(t, dims[n], mp), dims[n]) for n, t in mlp.items()}
    full = {n: leaf(t) for n, t in mlp.items()}
    xt, xf = leaf(x), leaf(x)
    got = t_lay.apply_mlp(tc.mlp, {n: ps for n, (ps, _) in cut.items()},
                          xt, tp=group_of(mp))
    want = t_lay.apply_mlp(tc.mlp, full, xf)
    cut["x"], full["x"] = (xt, None), xf
    grads_match(got, want, cut, full, f"{case} mlp")


@pytest.mark.parametrize("case", list(CASES))
def test_attention_block_column_parallel(case):
    """Heads cut (KV heads with them where mp divides them, replicated
    and narrowed per column where it does not), qk-norm and RoPE on the
    columns, ``wo`` row-parallel."""
    _, tc, mp = cfgs(case)
    p, x = block_params(tc, seed=1)
    att = {n[5:]: t for n, t in p.items() if n.startswith("attn/")}
    kv_cut = tc.n_kv_heads % mp == 0
    dims = {"wq": 2, "wo": 1, "wk": 2 if kv_cut else None,
            "wv": 2 if kv_cut else None}
    cut = {n: ((parts_of(t, dims[n], mp), dims[n])
               if dims.get(n) is not None else (leaf(t), None))
           for n, t in att.items()}
    full = {n: leaf(t) for n, t in att.items()}
    xt, xf = leaf(x), leaf(x)
    pos = torch.arange(x.shape[2], dtype=torch.int32)
    kw = dict(n_heads=tc.n_heads, n_kv=tc.n_kv_heads, qk_norm=tc.qk_norm,
              rope_theta=tc.rope_theta, positions=pos)
    got, _ = t_att.apply_attention({n: ps for n, (ps, _) in cut.items()},
                                   xt, tp=group_of(mp), **kw)
    want, _ = t_att.apply_attention(full, xf, **kw)
    cut["x"], full["x"] = (xt, None), xf
    grads_match(got, want, cut, full,
                f"{case} attention (kv {'cut' if kv_cut else 'replicated'})")


def test_kv_heads_of_a_column():
    """Which KV heads a column's query heads read: uniform groups, and
    a column whose three query heads read KV heads 0, 1, 1."""
    assert t_att._kv_heads_of(1, 2, 4) == (0, 1, [0, 0])
    assert t_att._kv_heads_of(3, 2, 4) == (1, 2, [0, 0])
    assert t_att._kv_heads_of(1, 3, 2) == (1, 3, [0, 1, 1])
    assert t_att._kv_heads_of(1, 3, 4) == (0, 2, [0, 1, 1])


@pytest.mark.parametrize("mp", [2, 3, 4])
def test_vocab_parallel_embedding_is_exact(mp):
    g = torch.Generator().manual_seed(mp)
    V = 48
    table = torch.randn((2, V, 16), generator=g)
    tokens = torch.randint(0, V, (2, 3, 10), generator=g)
    parts = parts_of(table, 1, mp)
    full = leaf(table)
    got = t_lay.embed_tokens({"table": parts}, tokens, tp=group_of(mp))
    want = t_lay.embed_tokens({"table": full}, tokens)
    assert torch.equal(got, want)
    r = torch.randn(want.shape, generator=g)
    gp = torch.autograd.grad((got * r).sum(), parts)
    gf = torch.autograd.grad((want * r).sum(), [full])[0]
    assert torch.equal(torch.cat(gp, dim=1), gf)


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "lm_head"])
@pytest.mark.parametrize("mp", [2, 3, 4])
def test_vocab_parallel_logits_and_log_softmax(mp, tied):
    """Each column's logits of its vocabulary slice, then the f32
    log-softmax across the columns: the per-token NLL and every
    gradient within rtol 1e-5 of ``log_softmax`` over the whole
    vocabulary. No column holds the whole [m, b, l, vocab]."""
    g = torch.Generator().manual_seed(10 + mp)
    V, d = 96, 16
    w = torch.randn((2, V, d) if tied else (2, d, V), generator=g)
    h = torch.randn((2, 3, 7, d), generator=g) * 3
    tgt = torch.randint(0, V, (2, 3, 7), generator=g)
    parts = parts_of(w, 1 if tied else 2, mp)
    full, ht, hf = leaf(w), leaf(h), leaf(h)
    logits = t_lay.vocab_logits(group_of(mp), parts, ht, tied)
    assert all(lg.shape[-1] == V // mp for lg in logits)
    got = t_lay.vocab_parallel_nll(group_of(mp), logits, tgt)
    lf = t_lay.mm(hf, full.transpose(1, 2) if tied else full)
    logp = torch.log_softmax(lf.to(torch.float32), dim=-1)
    want = -logp.gather(-1, tgt[..., None])[..., 0]
    grads_match(got, want, {"w": (parts, 1 if tied else 2),
                            "h": (ht, None)}, {"w": full, "h": hf},
                f"logits mp {mp}")


# ---------------------------------------------------------------------------
# The whole model against the JAX package
# ---------------------------------------------------------------------------

def model_cells(tc, mp, params, m_shard=None):
    """A one-shard (1, mp) mesh's cells of ``params`` under RULES_A, the
    specs and the row's group."""
    mesh = make_test_mesh(1, model_parallel=mp, device="cpu")
    specs = specs_for_tree(TM.model_axes(tc), params, RULES_A, mesh,
                           leading_client=("clients",))
    cells = mesh.shard(params, specs)
    return mesh, specs, cells, ColumnGroup(list(mesh.devices[0]),
                                           _column_dims(mesh, specs))


@pytest.mark.parametrize("case", ["smollm-9q3kv-mp3", "olmo-mp2",
                                  "qwen3-8q2kv-mp4"])
def test_model_loss_and_grads_against_the_reference(case):
    rc, tc, mp = cfgs(case)
    jp = jax.jit(lambda k: RM.init_model(k, rc)[0])(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    tok = rng.integers(0, rc.vocab_size, (2, 2, 16)).astype(np.int32)
    tgt = rng.integers(0, rc.vocab_size, (2, 2, 16)).astype(np.int32)

    def one(p, b):
        return jax.value_and_grad(lambda q: RM.loss_fn(q, rc, b))(p)

    loss, grads = jax.jit(jax.vmap(one, in_axes=(None, 0)))(
        jp, {"tokens": jnp.asarray(tok), "targets": jnp.asarray(tgt)})
    want = dict(zip(convert.flat_names(grads), jax.tree.leaves(grads)))

    params = convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                       stack=2, device="cpu")
    mesh, specs, cells, group = model_cells(tc, mp, params)
    n_cut = sum(d is not None for d in group.dims.values())
    assert n_cut >= 7, group.dims
    batch = {"tokens": torch.from_numpy(tok), "targets": torch.from_numpy(tgt)}
    got_loss, g_cells = local_sgd.loss_and_grad_columns(
        group, TM.make_loss(tc), cells, batch, None)
    np.testing.assert_allclose(got_loss.numpy(), np.asarray(loss),
                               rtol=LOSS_RTOL)
    got = mesh.gather(g_cells, specs)
    assert list(got) == list(want)
    for name, g in got.items():
        close(g, np.asarray(want[name]), GRAD_RTOL, name)


# ---------------------------------------------------------------------------
# The 2NN round
# ---------------------------------------------------------------------------

LOSS_2NN = make_2nn_loss()


def _opaque_2nn(p, b, r):
    return LOSS_2NN(p, b, r)


def _2nn(m=M, K=2, B=4):
    p0 = init_2nn(0, d_in=32, d_hidden=16, n_classes=8, device="cpu")
    stacked = {n: v[None].expand((m,) + tuple(v.shape)).contiguous()
               for n, v in p0.items()}
    rng = np.random.default_rng(3)
    batches = {"x": torch.tensor(rng.normal(size=(m, K, B, 32)),
                                 dtype=torch.float32),
               "y": torch.tensor(rng.integers(0, 8, size=(m, K, B)))}
    return stacked, batches


def _rounds(loss_fn, spec, cfg, mesh, specs, stacked, batches, n=3, **kw):
    step = T.make_round_step(loss_fn, cfg, spec, device="cpu", mesh=mesh,
                             param_specs=specs, **kw)
    st = T.init_round_state(stacked, prng.PRNGKey(11), mesh=mesh,
                            param_specs=specs)
    mets, states = [], []
    for _ in range(n):
        st, mt = step(st, batches)
        mets.append(mt)
        states.append(st)
    params = st.params if mesh is None else mesh.gather(st.params, specs)
    return params, mets, states, step


def test_2nn_round_tracks_the_reference_dense_trajectory():
    """``test_torch_mesh2d``'s set-up with the column-parallel loss: the
    2NN (32-16-8), an edge-sampled ring of 8, K 2, 3 rounds, the
    reference's dense mixer on one device against the port's
    tensor-parallel round on (2, 4) under the hand specs: every leaf
    within 2e-5, the loss falling."""
    K, B = 2, 4
    p0 = j_init_2nn(jax.random.PRNGKey(0), d_in=32, d_hidden=16,
                    n_classes=8)
    stacked = jax.tree.map(
        lambda t: jnp.broadcast_to(t[None], (M,) + t.shape), p0)
    kx, ky = jax.random.split(jax.random.PRNGKey(3))
    jb = {"x": jax.random.normal(kx, (M, K, B, 32)),
          "y": jax.random.randint(ky, (M, K, B), 0, 8)}

    def j_loss(p, b, r):
        logp = jax.nn.log_softmax(j_apply_2nn(p, b["x"]))
        return -jnp.mean(jnp.take_along_axis(logp, b["y"][:, None],
                                             axis=-1))

    jsched = J.TopologySchedule.edge_sample(J.ring_graph(M), p_edge=0.7)
    jcfg = J.DFedAvgMConfig(eta=0.1, theta=0.9, local_steps=K,
                            mixer_impl="dense")
    jstep = jax.jit(J.make_round_step(j_loss, jcfg, jsched))
    st = J.init_round_state(stacked, jax.random.PRNGKey(11))
    for _ in range(3):
        st, _ = jstep(st, jb)
    want = {n: np.asarray(v) for n, v in st.params.items()}

    tsched = T.TopologySchedule.edge_sample(T.ring_graph(M), p_edge=0.7)
    cfg = T.DFedAvgMConfig(eta=0.1, theta=0.9, local_steps=K,
                           mixer_impl="sparse")
    tb = {"x": torch.from_numpy(np.array(jb["x"])),
          "y": torch.from_numpy(np.asarray(jb["y"]).astype(np.int64))}
    ts = {n: torch.from_numpy(np.asarray(v).copy())
          for n, v in stacked.items()}
    mesh = make_test_mesh(2, model_parallel=4, device="cpu")
    got, mets, _, step = _rounds(LOSS_2NN, tsched, cfg, mesh, PS_2NN, ts, tb)
    assert step.local_step == "tensor_parallel"
    for n in want:
        err = float(np.abs(got[n].numpy() - want[n]).max())
        assert err < 2e-5, (n, err)
    assert float(mets[-1]["loss"]) < float(mets[0]["loss"])


@pytest.mark.parametrize("kind", ["ring", "partial_exact"])
def test_2nn_round_fp32_against_the_1d_mesh(kind):
    """fp32 wire: the tensor-parallel round on (2, 4) within rtol 1e-5 of
    the 1D mesh's (leaves, loss, consensus, drift), at full width and on
    a compute-skip schedule (each shard's row gathers its active
    lanes)."""
    stacked, batches = _2nn()
    spec = (T.MixingSpec.ring(M, 0.5) if kind == "ring" else
            T.TopologySchedule.partial(T.ring_graph(M), 0.5, exact=True))
    cfg = T.DFedAvgMConfig(eta=0.1, theta=0.9, local_steps=2,
                           mixer_impl="sparse")
    one, m1, _, s1 = _rounds(LOSS_2NN, spec, cfg, make_test_mesh(2, "cpu"),
                             None, stacked, batches)
    two, m2, _, s2 = _rounds(LOSS_2NN, spec, cfg,
                             make_test_mesh(2, model_parallel=4,
                                            device="cpu"),
                             PS_2NN, stacked, batches)
    assert (s1.local_step, s2.local_step) == ("whole", "tensor_parallel")
    for n in one:
        close(two[n], one[n], RTOL, n)
    for a, b in zip(m2, m1):
        for k in ("loss", "consensus_dist", "local_drift"):
            np.testing.assert_allclose(float(a[k]), float(b[k]),
                                       rtol=RTOL, err_msg=k)


def _codes(x, z, quant, key_q):
    """The 8-bit wire's levels of every (leaf, lane) and their unrounded
    values: ``quantize_int`` of z - x per lane with the round's per-leaf
    keys, in ``jax.tree.flatten`` (sorted) order, as the wire draws
    them."""
    names = sorted(x)
    keys = T.mixing._quant_leaf_keys(key_q, len(names), M)
    out = []
    for li, n in enumerate(names):
        d = (z[n] - x[n]).reshape(M, -1).to(torch.float32)
        k, s = T.quantize_int(d, quant, keys[li])
        out.append((k, d / s[:, None]))
    return out


def test_2nn_q8_stochastic_against_the_1d_mesh():
    """q8 stochastic lemma5: three rounds' loss and consensus within 1e-5
    of the 1D mesh's; one round's wire levels equal the 1D round's but at
    the positions where the float-order difference of z moved
    ``(z - x) / s`` across a rounding threshold. Level i is ``floor(a_i
    + u_i)`` with u_i uniform, so a shift of |da_i| flips it with
    probability min(1, |da_i|): the flip count has mean E = sum
    min(1, |da_i|) and variance below E, and stays under E + 6 sqrt(E)
    + 6; a flip moves a level by exactly 1."""
    stacked, batches = _2nn()
    spec = T.MixingSpec.ring(M, 0.5)
    quant = T.QuantConfig(bits=8, stochastic=True, delta_mode="lemma5")
    cfg = T.DFedAvgMConfig(eta=0.1, theta=0.9, local_steps=2, quant=quant,
                           mixer_impl="sparse")
    mesh1 = make_test_mesh(2, "cpu")
    mesh2 = make_test_mesh(2, model_parallel=4, device="cpu")
    _, m1, _, _ = _rounds(LOSS_2NN, spec, cfg, mesh1, None, stacked,
                          batches)
    _, m2, _, _ = _rounds(LOSS_2NN, spec, cfg, mesh2, PS_2NN, stacked,
                          batches)
    for a, b in zip(m2, m1):
        for k in ("loss", "consensus_dist"):
            np.testing.assert_allclose(float(a[k]), float(b[k]), rtol=1e-5,
                                       err_msg=k)
    # One round's local step from the same x: z on each mesh, and the
    # levels the wire sends.
    key_round, key_mix, _ = prng.split(prng.PRNGKey(11), 3)
    keys = prng.split(key_round, M)
    x = {n: t + 0.01 * torch.randn(t.shape, generator=torch.Generator()
                                   .manual_seed(7)) for n, t in
         stacked.items()}
    z1 = mesh1.gather([local_sgd.local_train(
        LOSS_2NN, xs, b, k, eta=0.1, theta=0.9)[0] for xs, b, k in zip(
            mesh1.shard(x), T.split_lanes(batches, ["cpu"] * 2),
            T.split_lanes(keys, ["cpu"] * 2))])
    cells = mesh2.shard(x, PS_2NN)
    dims = _column_dims(mesh2, PS_2NN)
    rows = []
    for s, (b, k) in enumerate(zip(T.split_lanes(batches, ["cpu"] * 2),
                                   T.split_lanes(keys, ["cpu"] * 2))):
        zc, _ = local_sgd.local_train(
            LOSS_2NN, cells[4 * s:4 * s + 4], b, k, eta=0.1, theta=0.9,
            group=ColumnGroup(["cpu"] * 4, dims))
        rows += zc
    z2 = mesh2.gather(rows, PS_2NN)
    flips, expect, n = 0, 0.0, 0
    for (k1, a1), (k2, a2) in zip(_codes(x, z1, quant, key_mix),
                                  _codes(x, z2, quant, key_mix)):
        diff = (k1 - k2).abs()
        assert int(diff.max()) <= 1
        flips += int((diff != 0).sum())
        expect += float((a1 - a2).abs().clamp(max=1.0).sum())
        n += k1.numel()
    bound = expect + 6 * expect ** 0.5 + 6
    print(f"q8 stochastic: {flips} of {n} wire levels differ from the 1D "
          f"mesh's (expected {expect:.3f}, bound {bound:.1f})")
    assert flips <= bound


# ---------------------------------------------------------------------------
# Properties
# ---------------------------------------------------------------------------

def _replicated_equal(cells, dims, mp, what):
    for s in range(len(cells) // mp):
        for c in range(1, mp):
            for n, t in cells[s * mp + c].items():
                if dims.get(n) is None:
                    assert torch.equal(t, cells[s * mp][n]), (what, s, c, n)


def _lm_setup(case="qwen3-8q2kv-mp4", m=4, n_shards=2, K=2):
    _, tc, mp = cfgs(case)
    tc = dataclasses.replace(tc, n_layers=1)
    p = TM.init_model(prng.PRNGKey(0), tc, device="cpu")
    stacked = {n: t[None].expand((m,) + t.shape).contiguous()
               for n, t in p.items()}
    rng = np.random.default_rng(2)
    batches = {k: torch.from_numpy(rng.integers(0, tc.vocab_size,
                                                (m, K, 2, 8)))
               for k in ("tokens", "targets")}
    mesh = make_test_mesh(n_shards, model_parallel=mp, device="cpu")
    specs = specs_for_tree(TM.model_axes(tc), stacked, RULES_A, mesh,
                           leading_client=("clients",))
    return tc, stacked, batches, mesh, specs


@pytest.mark.parametrize("skip", [False, True], ids=["full", "skip"])
def test_replicated_leaves_stay_bitwise_equal_across_columns(skip):
    """Qwen3-shaped (8 query, 2 KV heads) at mp 4: the KV projections,
    norms and qk-norms are replicated; after every tensor-parallel round
    (full width, and a compute-skip schedule) their copies on a shard's
    columns are bitwise equal."""
    tc, stacked, batches, mesh, specs = _lm_setup()
    dims = _column_dims(mesh, specs)
    assert dims["stages/0/attn/wk"] is None and dims["stages/0/attn/wq"]
    spec = (T.TopologySchedule.partial(T.ring_graph(4), 0.5, exact=True)
            if skip else T.MixingSpec.ring(4, 0.5))
    cfg = T.DFedAvgMConfig(eta=0.05, theta=0.9, local_steps=2,
                           quant=T.QuantConfig(bits=8, stochastic=False),
                           mixer_impl="sparse")
    step = T.make_round_step(TM.make_loss(tc), cfg, spec, device="cpu",
                             mesh=mesh, param_specs=specs)
    assert step.local_step == "tensor_parallel"
    st = T.init_round_state(stacked, prng.PRNGKey(3), mesh=mesh,
                            param_specs=specs)
    for t in range(2):
        st, met = step(st, batches)
        assert np.isfinite(float(met["loss"]))
        _replicated_equal(st.params, dims, 4, f"round {t}")


def test_async_event_tensor_parallel_keeps_replicas_equal():
    """Two async events per arm (straggler clock, eta decay, full width
    and ``ready_capacity``) on the Qwen3-shaped mesh: tensor-parallel,
    replicated copies bitwise equal, within 1e-5 of the 1D mesh's
    events' losses."""
    tc, stacked, batches, mesh, specs = _lm_setup()
    dims = _column_dims(mesh, specs)
    cfg = T.DFedAvgMConfig(eta=0.05, theta=0.9, local_steps=2,
                           mixer_impl="sparse")
    ev = {k: torch.stack([b] * 2) for k, b in batches.items()}
    for cap in (None, 1):
        acfg = T.AsyncConfig(speed=T.SpeedModel.straggler(),
                             max_staleness=4, eta_staleness_decay=0.5,
                             ready_capacity=cap)
        out = {}
        for name, msh, sp in (("1d", make_test_mesh(2, "cpu"), None),
                              ("2d", mesh, specs)):
            run = T.make_async_engine(TM.make_loss(tc), cfg,
                                      T.MixingSpec.ring(4, 0.5), acfg,
                                      device="cpu", mesh=msh,
                                      param_specs=sp)
            st = init_async_state(stacked, prng.PRNGKey(4), acfg.speed,
                                  mesh=msh, param_specs=sp)
            st, met = run(st, ev)
            out[name] = (run.local_step, met, st)
        assert out["2d"][0] == "tensor_parallel" and out["1d"][0] == "whole"
        _replicated_equal(out["2d"][2].params, dims, 4, f"cap {cap}")
        np.testing.assert_allclose(out["2d"][1]["loss"].numpy(),
                                   out["1d"][1]["loss"].numpy(), rtol=1e-5)
        assert torch.equal(out["2d"][2].version, out["1d"][2].version)


def test_tensor_parallel_round_never_joins_or_cuts(monkeypatch):
    """The round, its consensus and drift metrics and an async event on
    the tensor-parallel step: ``join_columns`` and ``cut_columns`` patched
    to raise (fp32 and deterministic q8 wires, whose mixers cut
    nothing)."""
    stacked, batches = _2nn()
    mesh = make_test_mesh(2, model_parallel=4, device="cpu")
    init = {q: T.init_round_state(stacked, prng.PRNGKey(1), mesh=mesh,
                                  param_specs=PS_2NN) for q in (0, 1)}
    a_init = init_async_state(stacked, prng.PRNGKey(1),
                              T.SpeedModel.straggler(), mesh=mesh,
                              param_specs=PS_2NN)

    def refuse(*a, **k):
        raise AssertionError("the tensor-parallel round joined or cut cells")

    from repro_torch.core import dfedavgm, mixing
    for mod in (dfedavgm, mixing):
        monkeypatch.setattr(mod, "join_columns", refuse)
        monkeypatch.setattr(mod, "cut_columns", refuse)
    for q, quant in enumerate((None, T.QuantConfig(bits=8,
                                                   stochastic=False))):
        cfg = T.DFedAvgMConfig(eta=0.1, theta=0.9, local_steps=2,
                               quant=quant, mixer_impl="sparse")
        step = T.make_round_step(LOSS_2NN, cfg, T.MixingSpec.ring(M, 0.5),
                                 device="cpu", mesh=mesh,
                                 param_specs=PS_2NN)
        st, met = step(init[q], batches)
        assert np.isfinite(float(met["consensus_dist"]))
        assert np.isfinite(float(met["local_drift"]))
        ev = T.make_async_round_step(
            LOSS_2NN, cfg, T.MixingSpec.ring(M, 0.5),
            T.AsyncConfig(speed=T.SpeedModel.straggler()), device="cpu",
            mesh=mesh, param_specs=PS_2NN)
        assert ev.local_step == "tensor_parallel"
        _, met = ev(a_init, batches)
        assert np.isfinite(float(met["consensus_dist"]))


def test_b3_runs_once_a_step_a_cell(monkeypatch):
    """B3 (``momentum_sgd_leaves``, one launch a call for the 2NN's f32
    leaves) runs n_shards x mp x K times a tensor-parallel round, and
    n_shards x K times a joined one."""
    from repro_torch.kernels import ops
    calls = []
    real = ops.momentum_sgd_leaves

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(ops, "momentum_sgd_leaves", counted)
    stacked, batches = _2nn(K=3)
    cfg = T.DFedAvgMConfig(eta=0.1, theta=0.9, local_steps=3,
                           mixer_impl="sparse")
    for loss, want in ((LOSS_2NN, 2 * 4 * 3), (_opaque_2nn, 2 * 3)):
        calls.clear()
        _rounds(loss, T.MixingSpec.ring(M, 0.5), cfg,
                make_test_mesh(2, model_parallel=4, device="cpu"), PS_2NN,
                stacked, batches, n=1)
        assert len(calls) == want, (loss, len(calls))


def test_local_step_names_the_path():
    """``local_step`` on the round and the async step: tensor-parallel for
    a loss whose form covers every cut leaf (the MoE's experts cut too),
    an SSM inner dim cut without its heads too, joined for an opaque
    loss, whole off a 2D mesh."""
    mesh = make_test_mesh(2, model_parallel=2, device="cpu")
    cfg = T.DFedAvgMConfig(mixer_impl="sparse")
    spec = T.MixingSpec.ring(M, 0.5)
    acfg = T.AsyncConfig(speed=T.SpeedModel.constant())

    def kind(loss, msh=mesh, specs=PS_2NN):
        a = T.make_round_step(loss, cfg, spec, device="cpu", mesh=msh,
                              param_specs=specs).local_step
        b = T.make_async_round_step(loss, cfg, spec, acfg, device="cpu",
                                    mesh=msh, param_specs=specs).local_step
        assert a == b
        return a

    assert kind(LOSS_2NN) == "tensor_parallel"
    assert kind(_opaque_2nn) == "joined"
    assert kind(LOSS_2NN, make_test_mesh(2, "cpu"), None) == "whole"
    assert kind(LOSS_2NN, None, None) == "whole"
    moe = tcfg.reduced(tcfg.get_config("qwen3-moe-30b-a3b"))
    moe_form = TM.make_loss(moe).column_parallel
    assert moe_form.covers("stages/0/moe/wg", {})
    assert moe_form.covers("stages/0/moe/router", {})
    dense = tcfg.reduced(tcfg.get_config("smollm-135m"))
    form = TM.make_loss(dense).column_parallel
    assert form.covers("stages/0/attn/wq", {}) and form.covers("lm_head", {})
    assert not form.covers("stages/0/ln1/scale", {})
    wg_cut = {"stages/0/moe/wg": P("clients", None, "model")}
    assert kind(TM.make_loss(moe), specs=wg_cut) == "tensor_parallel"
    assert kind(lambda p, b, r: TM.loss_fn(p, moe, b, r),
                specs=wg_cut) == "joined"
    ssm = tcfg.reduced(tcfg.get_config("mamba2-780m"))
    assert kind(TM.make_loss(ssm), specs={
        "stages/0/mixer/wx": P("clients", None, None, "model")}
    ) == "tensor_parallel"


def test_lone_lane_shards_run_as_two():
    """m_local 1 (8 shards x mp 2): each shard's row runs its lone lane
    as two, as ``loss_and_grad`` does; the round within rtol 1e-5 of the
    1D mesh of 8 shards."""
    stacked, batches = _2nn()
    cfg = T.DFedAvgMConfig(eta=0.1, theta=0.9, local_steps=2,
                           mixer_impl="sparse")
    spec = T.MixingSpec.ring(M, 0.5)
    one, *_ = _rounds(LOSS_2NN, spec, cfg, make_test_mesh(8, "cpu"), None,
                      stacked, batches, n=2)
    two, *_ = _rounds(LOSS_2NN, spec, cfg,
                      make_test_mesh(8, model_parallel=2, device="cpu"),
                      PS_2NN, stacked, batches, n=2)
    for n in one:
        close(two[n], one[n], RTOL, n)


def test_apply_2nn_columns_under_other_cuts():
    """The 2NN's form under cuts other than the hand specs (w1 alone; w2
    by columns with a replicated bias; every bias replicated): the loss
    and gradients of a row within rtol 1e-5 of the whole model's."""
    stacked, batches = _2nn(m=4)
    x = {n: t + 0.05 * torch.randn(t.shape, generator=torch.Generator()
                                   .manual_seed(1)) for n, t in
         stacked.items()}
    b = {n: t[:, 0] for n, t in batches.items()}
    want_l, want_g = local_sgd.loss_and_grad(LOSS_2NN, x, b, None)
    for specs in ({"w1": P("clients", None, "model")},
                  {"w2": P("clients", None, "model"),
                   "b3": P("clients", "model")},
                  {n: s for n, s in PS_2NN.items() if n.startswith("w")}):
        mesh = make_test_mesh(1, model_parallel=4, device="cpu")
        group = ColumnGroup(["cpu"] * 4, _column_dims(mesh, specs))
        loss, g = local_sgd.loss_and_grad_columns(
            group, LOSS_2NN, mesh.shard(x, specs), b, None)
        close(loss, want_l, RTOL, str(specs))
        got = mesh.gather(g, specs)
        for n in want_g:
            close(got[n], want_g[n], RTOL, f"{specs} {n}")
