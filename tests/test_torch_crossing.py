"""The layouts the JAX package runs that the port once refused, on the
CPU at reduced sizes:

* An SSM inner dim that the model axis cuts across heads (Mamba2 reduced
  at d_model 24: inner 48, 3 heads of 16, on mp 2; at d_model 36 with
  head_dim 36: inner 72, 2 heads, on mp 3). The mixer, uncached and
  cached, on a row of columns against the joined mixer: output and every
  gradient within rtol 1e-5 of the largest value, the cached states
  within 1e-5 and every column's copy of the replicated state bitwise
  alike. The column-parallel loss on a (1, 2) row against the JAX
  package's ``loss_fn`` (loss within 1e-5, gradients within 1e-4). B2
  and B3 rounds on (4, 2) cells, and the serving prefill and decode on
  (4, 2), against the port's global program.
* The dense mix on the pod mesh (2, 2, 2): a round under B and B3,
  fp32, against the global program (loss, consensus, drift and every
  leaf within rtol 1e-5, atol 1e-6); an 8-bit round's loss and drift so
  (its consensus within 1e-3); the 8-bit mix alone, given the same x and
  z, with every dequantized delta and every scale bitwise the one
  device's ``_mix_dense_quantized`` and the output within four ulp of
  each leaf's largest value. The fused round there stays refused.
* A MoE whose ``moe_d_ff`` the model axis does not divide, under a cut
  batch (Qwen3-MoE reduced, ``moe_d_ff`` 30, B3 on (2, 4), remat off and
  on): the rows route as one group a client; a round against the global
  program (the whole batch one group).
* A round's recorded collectives on the CPU cells equal the same build's
  on ``meta`` cells, in each of these layouts.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert, prng  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.core import (DFedAvgMConfig, MixingSpec,  # noqa: E402
                              QuantConfig, RoundState, local_sgd,
                              make_round_step)
from repro_torch.core import mixing as MX  # noqa: E402
from repro_torch.core.quantize import (dequantize_int,  # noqa: E402
                                      quantize_int)
from repro_torch.launch import build as B  # noqa: E402
from repro_torch.launch import cost_model, hlo_stats  # noqa: E402
from repro_torch.launch.mesh import (Cells, make_named_mesh,  # noqa: E402
                                     make_test_mesh)
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.sharding import RULES_A, specs_for_tree  # noqa: E402
from repro_torch.sharding.tensor_parallel import (  # noqa: E402
    ColumnGroup, local_step_kind)

torch.set_num_threads(1)

RTOL, ATOL, GRAD_RTOL = 1e-5, 1e-6, 1e-4
Q8_CONSENSUS_RTOL = 1e-3
MIX_ULP = 4
SHAPE = InputShape("t", 16, 8, "train")      # seq 16, global batch 8
# (d_model, head_dim, mp): the model axis cuts the inner dim, not heads
CROSSINGS = [(24, 16, 2), (36, 36, 3)]
MIXER_CUT = {"wz": -1, "wx": -1, "conv_x": -1, "norm_scale": -1, "wo": 1}


def close(got, want, rtol=RTOL, what=""):
    """|got - want| <= rtol x max |want|."""
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want.detach() if isinstance(want, torch.Tensor)
                      else want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (what, err, scale)


def crossing_cfg():
    return dataclasses.replace(reduced(get_config("mamba2-780m")),
                               d_model=24)


def mixer_params(d, hd, seed=3):
    """A mixer's leaves for 2 clients, the init moved by noise (the per-
    head leaves differ from head to head)."""
    p = S.init_mamba2(prng.PRNGKey(seed), d, 16, expand=2, head_dim=hd)
    g = torch.Generator().manual_seed(seed + 1)
    return {n: (t.cpu()[None].expand((2,) + t.shape)
                + 0.1 * torch.randn((2,) + t.shape, generator=g)).contiguous()
            for n, t in p.items()}


def cut(params, mp):
    """The mixer's inner-dim leaves cut into mp column slices (the heads'
    leaves replicated), as a row's view holds them."""
    return {n: (list(t.chunk(mp, dim=MIXER_CUT[n])) if n in MIXER_CUT
                else t) for n, t in params.items()}


# ---------------------------------------------------------------------------
# The crossing SSM mixer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,hd,mp", CROSSINGS)
def test_crossing_mixer_forward_and_gradients(d, hd, mp):
    """The uncached mixer on mp columns whose channels cross heads
    against the joined mixer: output and every gradient (the input's,
    the cut leaves' gathered, the replicated per-head leaves' summed
    over the columns) within rtol 1e-5."""
    assert (2 * d // hd) % mp and (2 * d) % mp == 0
    full = mixer_params(d, hd)
    group = ColumnGroup(["cpu"] * mp, {n: 1 for n in MIXER_CUT})
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 2, 12, d, generator=g)
    fp = {n: t.clone().requires_grad_(True) for n, t in full.items()}
    cp = {n: ([q.clone().requires_grad_(True) for q in v]
              if isinstance(v, list) else v.clone().requires_grad_(True))
          for n, v in cut(full, mp).items()}
    xf, xc = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    want, _ = S.apply_mamba2(fp, xf, head_dim=hd, chunk=8)
    got, _ = S.apply_mamba2(cp, xc, head_dim=hd, chunk=8, tp=group)
    close(got, want, what="forward")
    r = torch.randn(want.shape, generator=g)
    gw = torch.autograd.grad((want * r).sum(), [xf] + list(fp.values()))
    flat = [xc] + [q for v in cp.values()
                   for q in (v if isinstance(v, list) else [v])]
    gc = iter(torch.autograd.grad((got * r).sum(), flat))
    close(next(gc), gw[0], what="grad x")
    for (n, v), want_g in zip(cp.items(), gw[1:]):
        got_g = (torch.cat([next(gc) for _ in v], dim=MIXER_CUT[n])
                 if isinstance(v, list) else next(gc))
        close(got_g, want_g, what=f"grad {n}")


@pytest.mark.parametrize("d,hd,mp", CROSSINGS)
def test_crossing_cached_mixer(d, hd, mp):
    """The cached mixer on mp columns whose channels cross heads: a
    5-token prompt then 3 decode steps within 1e-5 of the joined cached
    mixer; ``conv_x`` cut by channel, the state replicated, every
    column's copy bitwise alike after each step and within 1e-5 of the
    joined state."""
    params = {n: t[:1] for n, t in mixer_params(d, hd).items()}
    view = cut(params, mp)
    b = 2
    cache = S.init_mamba2_cache(b, d, 16, expand=2, head_dim=hd,
                                device="cpu")
    cols = {n: ([q.clone() for q in t.chunk(mp, dim=-1)]
                if n != "ssm" and t.shape[-1] % mp == 0
                else [t.clone() for _ in range(mp)])
            for n, t in cache.items()}
    group = ColumnGroup(["cpu"] * mp, {n: 1 for n in MIXER_CUT})
    xs = torch.randn(1, b, 8, d, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        for lo, hi in [(0, 5), (5, 6), (6, 7), (7, 8)]:
            want, cache = S.apply_mamba2(params, xs[:, :, lo:hi],
                                         head_dim=hd, cache=cache, chunk=4)
            got, _ = S.apply_mamba2(view, xs[:, :, lo:hi], head_dim=hd,
                                    cache=cols, tp=group, chunk=4)
            close(got, want, what=lo)
            assert all(torch.equal(c, cols["ssm"][0])
                       for c in cols["ssm"][1:])
    for n, t in cache.items():
        joined = (cols[n][0] if cols[n][0].shape == t.shape
                  else torch.cat(cols[n], dim=-1))
        close(joined, t, what=n)


def test_crossing_loss_against_the_reference():
    """The crossing config's column-parallel loss on a (1, 2) row (the
    form takes every cut leaf; the step is tensor-parallel) against the
    JAX package's ``loss_fn`` at the same parameters: loss within 1e-5,
    every gradient (the cut ones gathered) within 1e-4."""
    import jax
    import jax.numpy as jnp
    from repro import configs as rcfg
    from repro.models import model as RM
    tc = crossing_cfg()
    rc = dataclasses.replace(rcfg.reduced(rcfg.get_config("mamba2-780m")),
                             d_model=24)
    one = M.init_model(prng.PRNGKey(4), tc, device="cpu")
    like = jax.eval_shape(lambda k: RM.init_model(k, rc)[0],
                          jax.random.PRNGKey(0))
    jp = convert.params_to_numpy(one, like=like)
    rng = np.random.default_rng(5)
    batch = {k: rng.integers(0, rc.vocab_size, (2, 2, 16)).astype(np.int32)
             for k in ("tokens", "targets")}
    loss, grads = jax.jit(jax.vmap(
        lambda p, b: jax.value_and_grad(lambda q: RM.loss_fn(q, rc, b))(p),
        in_axes=(None, 0)))(jax.tree.map(jnp.asarray, jp), batch)
    want = dict(zip(convert.flat_names(grads),
                    (np.asarray(g) for g in jax.tree.leaves(grads))))
    params = {n: t[None].expand((2,) + t.shape).contiguous()
              for n, t in one.items()}
    mesh = make_test_mesh(1, model_parallel=2, device="cpu")
    specs = specs_for_tree(M.model_axes(tc), params, RULES_A, mesh,
                           leading_client=("clients",))
    group = ColumnGroup(list(mesh.devices[0]), MX._column_dims(mesh, specs))
    assert group.dims["stages/0/mixer/wx"] is not None
    assert group.dims["stages/0/mixer/A_log"] is None
    loss_fn = M.make_loss(tc)
    assert local_step_kind(loss_fn, group.dims) == "tensor_parallel"
    got_loss, g_cells = local_sgd.loss_and_grad_columns(
        group, loss_fn, mesh.shard(params, specs),
        {k: torch.from_numpy(v) for k, v in batch.items()}, None)
    np.testing.assert_allclose(got_loss.numpy(), np.asarray(loss),
                               rtol=RTOL)
    for name, g in mesh.gather(g_cells, specs).items():
        close(g[0], want[name][0], GRAD_RTOL, name)


def _inputs(cfg, built, seed=3):
    """One client a key's params and a numpy batch of the build's
    shape."""
    m, k, bs, seq = (built.meta[n] for n in ("m", "K", "local_bs", "seq"))
    ps = [M.init_model(prng.PRNGKey(10 + i), cfg, device="cpu")
          for i in range(m)]
    params = {n: torch.stack([p[n] for p in ps]) for n in ps[0]}
    tok = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (m, k, bs, seq + 1)).astype(np.int32))
    return params, {"tokens": tok[..., :-1].contiguous(),
                    "targets": tok[..., 1:].contiguous()}


def _against_global(cfg, mesh, strategy, dfed=None, leaves=True):
    """One round of the build on ``mesh``'s CPU cells against the port's
    global program (one device, the whole batch, the dense mix):
    ``loss``, ``consensus_dist`` and ``local_drift`` within rtol 1e-5 and
    (``leaves``) every leaf within rtol 1e-5, atol 1e-6. Returns the
    build, the metrics and the global ones."""
    built = B.build_train_step(cfg, mesh, SHAPE, strategy=strategy,
                               dfed=dfed)
    params, batches = _inputs(cfg, built)
    gdfed = dfed or DFedAvgMConfig(eta=1e-3, theta=0.9, local_steps=2)
    gstep = make_round_step(M.make_loss(cfg),
                            dataclasses.replace(gdfed, mixer_impl="dense"),
                            MixingSpec.ring(built.meta["m"]), device="cpu")
    gstate, gmet = gstep(RoundState(
        params={n: t.clone() for n, t in params.items()},
        rng=prng.PRNGKey(1), round=0), batches)
    state, met = built.fn(RoundState(params=params, rng=prng.PRNGKey(1),
                                     round=0), batches)
    for k in ("loss", "local_drift") + (("consensus_dist",) if leaves
                                        else ()):
        np.testing.assert_allclose(float(met[k]), float(gmet[k]),
                                   rtol=RTOL, err_msg=k)
    if leaves:
        got = built.mesh.gather(state.params, built.specs[0][0].params)
        for n, t in gstate.params.items():
            np.testing.assert_allclose(got[n].numpy(), t.numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=n)
    return built, met, gmet


@pytest.mark.parametrize("strategy", ["B2", "B3"])
def test_crossing_cells_round_against_the_global_program(strategy):
    """B2 (the inner dim cut over ("data", "model"), re-cut to each
    column's contiguous 24 channels) and B3 on (4, 2) cells of the
    crossing config: one round within rtol 1e-5 of the global
    program."""
    _against_global(crossing_cfg(), make_named_mesh((4, 2), device="cpu"),
                    strategy)


def test_crossing_serving_on_the_mesh():
    """The crossing config's prefill and 3 greedy decode steps on (4, 2)
    cells (the ssm state replicated, ``conv_x`` cut by channel): the
    built prefill, the filling prefill and every step's logits within
    1e-5 of the one program's largest logit."""
    cfg = crossing_cfg()
    params = M.init_model(prng.PRNGKey(2), cfg, device="cpu")
    mesh = make_named_mesh((4, 2), device="cpu")
    b, lp, s_alloc = 4, 6, 16
    tokens = torch.randint(0, cfg.vocab_size, (b, lp), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(9))
    pre = B.build_prefill_step(cfg, mesh, InputShape("p", lp, b, "prefill"))
    dec = B.build_decode_step(cfg, mesh,
                              InputShape("d", s_alloc, b, "decode"))
    cspecs = dec.specs[0][3]
    assert "model" not in cspecs[0]["ssm"].names(2)
    assert "model" in cspecs[0]["conv_x"].names(3)
    with torch.no_grad():
        want, _, _ = M.forward(params, cfg, tokens, last_only=True)
        close(pre.fn(params, tokens), want[:, 0], what="prefill")
        caches = M.init_decode_caches(cfg, b, s_alloc, device="cpu")
        wl, caches = M.prefill(params, cfg, tokens, caches)
        gl, cells = dec.prefill(params, tokens, M.init_decode_caches(
            cfg, b, s_alloc, device="cpu"))
        close(gl, wl, what="fill")
        pcells = dec.mesh.shard(params, dec.specs[0][0])
        for i in range(3):
            tok = torch.argmax(wl, -1).to(torch.int32)
            pos = torch.tensor(lp + i, dtype=torch.int32)
            wl, caches = M.decode_step(params, cfg, tok, pos, caches)
            gl, cells = dec.fn(pcells, tok, pos, cells)
            close(gl, wl, what=("decode", i))


# ---------------------------------------------------------------------------
# The dense mix on the pod mesh
# ---------------------------------------------------------------------------

def _pods():
    return make_named_mesh((2, 2, 2), ("pod", "data", "model"),
                           device="cpu")


@pytest.mark.parametrize("strategy", ["B", "B3"])
def test_dense_mix_on_pods_round(strategy):
    """``mixer_impl="dense"`` on (2, 2, 2): ``meta["mixer"]`` is the
    reference's "dense", and one fp32 round matches the global
    program."""
    dfed = DFedAvgMConfig(eta=1e-3, theta=0.9, local_steps=2,
                          mixer_impl="dense")
    built, _, _ = _against_global(reduced(get_config("smollm-135m")),
                                  _pods(), strategy, dfed)
    assert built.meta["mixer"] == "dense"
    assert built.meta["client_axes"] == ("pod",)


def test_dense_mix_on_pods_8bit_round():
    """An 8-bit (``lemma5``) round of the dense mix on (2, 2, 2) under
    B3: loss and local drift within rtol 1e-5 of the global program,
    consensus within 1e-3 (a rounding that flips moves a value a
    step)."""
    dfed = DFedAvgMConfig(eta=1e-3, theta=0.9, local_steps=2,
                          mixer_impl="dense", quant=QuantConfig(bits=8))
    _, met, gmet = _against_global(reduced(get_config("smollm-135m")),
                                   _pods(), "B3", dfed, leaves=False)
    np.testing.assert_allclose(float(met["consensus_dist"]),
                               float(gmet["consensus_dist"]),
                               rtol=Q8_CONSENSUS_RTOL)


@pytest.mark.parametrize("mode", ["lemma5", "eq7"])
def test_dense_mix_on_pods_8bit_given_the_same_z(monkeypatch, mode):
    """The 8-bit dense mix alone on (2, 2, 2) cells under B2's specs
    (a dim cut over ("data", "model"), clients over "pod"), given x and z
    from a seed: every dequantized delta and every client's per-leaf
    scale bitwise the one device's ``_mix_dense_quantized`` (the same
    keys), the output within four ulp of each leaf's largest value."""
    from repro_torch.sharding.rules import (ShardingStrategy,
                                            shapes_and_axes, stack_shapes)
    cfg = reduced(get_config("smollm-135m"))
    mesh = _pods()
    strat = ShardingStrategy.for_arch(cfg.name, mesh, strategy="B2")
    m = strat.num_clients
    shapes, axes = shapes_and_axes(
        lambda k: (M.init_model(k, cfg, device="meta"), M.model_axes(cfg)))
    specs = specs_for_tree(axes, stack_shapes(shapes, m), strat.rules, mesh,
                           leading_client=strat.client_axes)
    g = torch.Generator().manual_seed(11)
    x = {n: 0.02 * torch.randn((m,) + tuple(t.shape), generator=g)
         for n, t in shapes.items()}
    z = {n: t + 1e-3 * torch.randn(t.shape, generator=g)
         for n, t in x.items()}
    quant = QuantConfig(bits=8, delta_mode=mode)
    spec = MixingSpec.ring(m)
    names = sorted(x)
    want = MX._mix_dense_quantized(spec.W, x, z, quant, prng.PRNGKey(5))
    keys = MX._quant_leaf_keys(prng.PRNGKey(5), len(names), m)
    q_want, s_want = {}, {}
    for li, n in enumerate(names):
        d = (z[n] - x[n]).to(torch.float32)
        code, s_want[n] = quantize_int(d.reshape(m, -1), quant, keys[li])
        q_want[n] = dequantize_int(code, s_want[n]).reshape(d.shape)
    real = MX.quantize_levels
    seen = []

    def spy(d, s, quant, u=None):
        k = real(d, s, quant, u)
        seen.append((k * s, s))
        return k

    monkeypatch.setattr(MX, "quantize_levels", spy)
    xs, zs = mesh.shard(x, specs), mesh.shard(z, specs)
    out = MX.make_cells_mixer(spec, mesh, specs, quant)(
        xs, zs, prng.PRNGKey(5))
    per, cells_a_pod = len(names), len(xs) // m
    assert len(seen) == per * len(xs)
    q = mesh.gather(Cells(
        dict(zip(names, (k for k, _ in seen[i * per:(i + 1) * per])))
        for i in range(len(xs))), specs)
    for i in range(len(xs)):          # cell i holds pod i // cells_a_pod
        pod = i // cells_a_pod
        for j, n in enumerate(names):
            assert torch.equal(seen[i * per + j][1].reshape(-1),
                               s_want[n][pod:pod + 1]), n
    got = mesh.gather(Cells(out), specs)
    for n in names:
        assert torch.equal(q[n], q_want[n]), n
        scale = float(want[n].abs().max())
        ulp = float(np.spacing(np.float32(scale)))
        assert float((got[n] - want[n]).abs().max()) <= MIX_ULP * ulp, n


def test_fused_round_on_pods_stays_refused():
    """The fused round on the pod mesh raises the reference's reason,
    with the dense mix as with the ring."""
    for impl in ("dense", "ring"):
        fused = DFedAvgMConfig(eta=1e-3, theta=0.9, local_steps=2,
                               fuse_round=True, mixer_impl=impl)
        with pytest.raises(ValueError, match="model-sharded params"):
            B.build_train_step(reduced(get_config("smollm-135m")), _pods(),
                               SHAPE, strategy="B3", dfed=fused)


# ---------------------------------------------------------------------------
# A MoE routed as one group over a cut batch
# ---------------------------------------------------------------------------

def _odd_moe(remat=False):
    return dataclasses.replace(reduced(get_config("qwen3-moe-30b-a3b")),
                               moe_d_ff=30, remat=remat)


@pytest.mark.parametrize("remat", [False, True])
def test_moe_one_group_round_against_the_global_program(remat):
    """Qwen3-MoE reduced with moe_d_ff 30 under B3 on (2, 4) (4 does not
    divide 30): the two data rows route their blocks as one group a
    client, the whole batch's capacity and top-1 fractions, the second
    block's ranks after the first's; a round within rtol 1e-5 of the
    global program, whose whole batch is one group. With remat each
    block's recomputation routes at its own layer."""
    _against_global(_odd_moe(remat), make_named_mesh((2, 4), device="cpu"),
                    "B3")


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

LAYOUTS = {
    "crossing-B2": (crossing_cfg, (4, 2), ("data", "model"), "B2", None),
    "pods-dense-q8": (lambda: reduced(get_config("smollm-135m")), (2, 2, 2),
                      ("pod", "data", "model"), "B3",
                      DFedAvgMConfig(eta=1e-3, theta=0.9, local_steps=2,
                                     mixer_impl="dense",
                                     quant=QuantConfig(bits=8))),
    "moe-one-group": (_odd_moe, (2, 4), ("data", "model"), "B3", None),
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_collectives_on_cells_equal_the_meta_count(layout):
    """A round's recorded collectives (kinds, counts and bytes) on the
    CPU cells equal the same build's counted on ``meta`` cells; the dense
    mix's pod gathers and the one group's count gathers among them."""
    mk, shape, axes, strategy, dfed = LAYOUTS[layout]
    cfg = mk()
    cpu = B.build_train_step(cfg, make_named_mesh(shape, axes, device="cpu"),
                             SHAPE, strategy=strategy, dfed=dfed)
    params, batches = _inputs(cfg, cpu)
    with hlo_stats.collect_collectives() as real:
        cpu.fn(RoundState(params=params, rng=prng.PRNGKey(1), round=0),
               batches)
    meta = B.build_train_step(cfg, make_named_mesh(shape, axes,
                                                   device="meta"),
                              SHAPE, strategy=strategy, dfed=dfed)
    with hlo_stats.collect_collectives() as counted:
        cost_model.structural_costs(meta.fn, *meta.args)
    assert dict(real.counts) == dict(counted.counts)
    assert dict(real.by_kind) == pytest.approx(dict(counted.by_kind))
    assert real.counts["all-gather"] > 0
