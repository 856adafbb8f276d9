"""The port's production models (``repro_torch.models``) against the JAX
package's, at the reduced size in f32 (batch 2, 16 tokens), on the same
parameters and inputs.

Contracts, for every registered architecture (one case each):
  * ``init_model``: the flat leaf names sorted are ``jax.tree.flatten``'s
    order (``convert.params_from_numpy`` of the reference's tree gives
    the same names), each leaf within 4 ulp of the reference's (3 of the
    normal draw, 1 of the scaling);
  * ``forward`` logits and ``loss_fn`` within rtol 1e-5 (the logits'
    tolerance is relative to their largest magnitude, since a logit near
    zero keeps the absolute error of the sum that made it);
  * the gradients of two clients (a leading client axis, two batches, one
    backward) within rtol 1e-4 of each leaf's largest magnitude, against
    the reference's ``vmap`` of ``jax.grad``.
Then the parts that a short input does not reach: streaming attention
over several KV chunks with a sliding window (both packages' chunk
constants patched), ``ssd_chunked`` across chunk boundaries, MoE capacity
drops and exact router ties, and prefill + cached decode against the
reference's for the dense, ssm, hybrid, whisper and vlm families. The
leaf order also holds at the registered widths, zamba2's 13 stages
included (``jax.eval_shape``, no memory).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as rcfg  # noqa: E402
from repro.models import attention as r_att  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import moe as r_moe  # noqa: E402
from repro.models import ssm as r_ssm  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch.models import attention as t_att  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models import ssm as t_ssm  # noqa: E402

torch.set_num_threads(2)

ARCHS = rcfg.list_archs()
B, L = 2, 16
LOGIT_RTOL, GRAD_RTOL, INIT_ULP = 1e-5, 1e-4, 4
DECODE_ARCHS = ("smollm-135m", "mamba2-780m", "zamba2-1.2b",
                "whisper-tiny", "llama-3.2-vision-11b")


def cfgs(arch):
    return rcfg.reduced(rcfg.get_config(arch)), \
        tcfg.reduced(tcfg.get_config(arch))


def inputs(cfg, seed=0, b=B, length=L, m=None):
    rng = np.random.default_rng(seed)
    lead = (b,) if m is None else (m, b)
    tok = rng.integers(0, cfg.vocab_size, lead + (length,)).astype(np.int32)
    tgt = rng.integers(0, cfg.vocab_size, lead + (length,)).astype(np.int32)
    fe = None
    if cfg.frontend:
        fe = rng.normal(size=lead + (cfg.frontend_tokens, cfg.d_model)
                        ).astype(np.float32)
    return tok, tgt, fe


def batch_of(tok, tgt, fe, to):
    out = {"tokens": to(tok), "targets": to(tgt)}
    if fe is not None:
        out["frontend"] = to(fe)
    return out


def ulps(a: np.ndarray, b: np.ndarray) -> int:
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int(np.abs(ia - ib).max()) if a.size else 0


def close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, scale)


@pytest.fixture(scope="module", params=ARCHS)
def arch_case(request):
    """One architecture's parameters and the reference's logits, loss and
    per-client gradients (one jitted call)."""
    arch = request.param
    rc, tc = cfgs(arch)
    jp = jax.jit(lambda k: RM.init_model(k, rc)[0])(jax.random.PRNGKey(0))
    tok, tgt, fe = inputs(rc, m=2)

    def loss_and_logits(p, batch):
        # loss_fn's own arithmetic, its logits kept (one forward).
        logits, _, aux = RM.forward(p, rc, batch["tokens"],
                                    frontend_embeds=batch.get("frontend"))
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        nll = -jnp.take_along_axis(logp, batch["targets"][..., None],
                                   axis=-1)[..., 0]
        return nll.mean() + RM.MOE_AUX_WEIGHT * aux, logits

    def one(p, batch):
        (loss, logits), g = jax.value_and_grad(loss_and_logits,
                                               has_aux=True)(p, batch)
        return logits, loss, g

    logits, loss, grads = jax.jit(jax.vmap(one, in_axes=(None, 0)))(
        jp, batch_of(tok, tgt, fe, jnp.asarray))
    return dict(arch=arch, rc=rc, tc=tc, jp=jp, tok=tok, tgt=tgt, fe=fe,
                logits=np.asarray(logits), loss=np.asarray(loss),
                grads=jax.tree.map(np.asarray, grads))


def test_init_leaves_in_flatten_order_within_4_ulp(arch_case):
    c = arch_case
    leaves = jax.tree.leaves(c["jp"])
    carried = convert.params_from_numpy(jax.tree.map(np.asarray, c["jp"]),
                                        device="cpu")
    mine = TM.init_model(prng.PRNGKey(0), c["tc"], device="cpu")
    assert list(mine) == list(carried)
    for (name, t), ref in zip(mine.items(), leaves):
        assert tuple(t.shape) == ref.shape and str(t.dtype)[6:] == \
            str(ref.dtype), name
        assert torch.equal(carried[name], torch.from_numpy(np.array(ref)))
        assert ulps(t.numpy(), np.asarray(ref)) <= INIT_ULP, name
    back = convert.params_to_numpy(carried, like=c["jp"])
    assert jax.tree.structure(back) == jax.tree.structure(c["jp"])


def test_forward_loss_and_grads(arch_case):
    c = arch_case
    params = convert.params_from_numpy(jax.tree.map(np.asarray, c["jp"]),
                                       stack=2, device="cpu")
    batch = batch_of(c["tok"], c["tgt"], c["fe"], torch.from_numpy)
    logits, _, _ = TM.forward(params, c["tc"], batch["tokens"],
                              frontend_embeds=batch.get("frontend"))
    close(logits.detach().numpy(), c["logits"], LOGIT_RTOL)
    from repro_torch.core.local_sgd import loss_and_grad
    loss, grads = loss_and_grad(lambda p, b, r: TM.loss_fn(p, c["tc"], b),
                                params, batch, None)
    np.testing.assert_allclose(loss.numpy(), c["loss"], rtol=LOGIT_RTOL)
    want = dict(zip(convert.flat_names(c["grads"]),
                    jax.tree.leaves(c["grads"])))
    assert list(grads) == list(want)
    for name, g in grads.items():
        close(g.numpy(), want[name], GRAD_RTOL)


def test_leaf_order_at_registered_width():
    """At the registered widths (shapes only): the port's stage prefixes
    and ``convert``'s flat names sort in ``jax.tree.flatten``'s order —
    zamba2-1.2b has 13 stages, so ``stages/10`` must follow
    ``stages/09``."""
    for arch in ARCHS:
        cfg = rcfg.get_config(arch)
        shapes = jax.eval_shape(lambda k: RM.init_model(k, cfg)[0],
                                jax.random.PRNGKey(0))
        paths = [jax.tree_util.keystr(p, simple=True, separator="/")
                 for p, _ in jax.tree_util.tree_flatten_with_path(shapes)[0]]
        names = convert.flat_names(shapes)
        n = len(cfg.stages())
        fixed = [p.replace(f"stages/{i}/", f"{TM.stage_name(cfg, i)}/")
                 for p in paths for i in range(n)
                 if p.startswith(f"stages/{i}/")]
        assert [p for p in paths if p.startswith("stages/")] and \
            fixed == [q for q in names if q.startswith("stages/")], arch
        assert len(names) == len(paths)
    assert len(rcfg.get_config("zamba2-1.2b").stages()) > 10


@pytest.mark.parametrize("window", [0, 24])
def test_streaming_attention_over_chunks(monkeypatch, window):
    """l = 40 over KV chunks of 8 and query blocks of 16 (both packages'
    constants patched): several chunks with a padded tail, a sliding
    window across chunk edges, within rtol 1e-5."""
    for mod in (r_att, t_att):
        monkeypatch.setattr(mod, "KV_CHUNK", 8)
        monkeypatch.setattr(mod, "Q_CHUNK", 16)
    rng = np.random.default_rng(window)
    q = rng.normal(size=(2, 40, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 40, 2, 16)).astype(np.float32)
            for _ in range(2))
    pos = np.arange(40, dtype=np.int32)
    want = r_att.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(pos), jnp.asarray(pos), causal=True,
                        window=window)
    got = t_att.attend(*(torch.from_numpy(a) for a in (q, k, v, pos, pos)),
                       causal=True, window=window)
    close(got.numpy(), want, 1e-5)


def test_ssd_chunked_across_chunk_boundaries():
    rng = np.random.default_rng(5)
    b, l, h, p, n = 2, 37, 3, 4, 5
    x = rng.normal(size=(b, l, h, p)).astype(np.float32)
    dA = -np.abs(rng.normal(size=(b, l, h))).astype(np.float32) * 0.3
    Bm, Cm = (rng.normal(size=(b, l, n)).astype(np.float32)
              for _ in range(2))
    s0 = rng.normal(size=(b, h, n, p)).astype(np.float32)
    want_y, want_s = r_ssm.ssd_chunked(*(jnp.asarray(a) for a in
                                         (x, dA, Bm, Cm)), chunk=8,
                                       init_state=jnp.asarray(s0))
    got_y, got_s = t_ssm.ssd_chunked(*(torch.from_numpy(a) for a in
                                       (x, dA, Bm, Cm)), chunk=8,
                                     init_state=torch.from_numpy(s0))
    close(got_y.numpy(), want_y, 1e-5)
    close(got_s.numpy(), want_s, 1e-5)


def _moe_case(router, x, top_k=2, cf=1.25, seed=0):
    rng = np.random.default_rng(seed)
    d, e = router.shape
    f = 8
    p = {"router": router,
         **{n: rng.normal(size=s).astype(np.float32) * 0.3
            for n, s in (("wg", (e, d, f)), ("wu", (e, d, f)),
                         ("wd", (e, f, d)))}}
    want, aux = r_moe._moe_grouped(jax.tree.map(jnp.asarray, p),
                                   jnp.asarray(x)[None], top_k=top_k,
                                   capacity_factor=cf)
    got, gaux = t_moe.moe_grouped(
        {n: torch.from_numpy(a)[None] for n, a in p.items()},
        torch.from_numpy(x)[None], top_k=top_k, capacity_factor=cf)
    close(got.numpy(), want, 1e-5)
    np.testing.assert_allclose(gaux.numpy(), np.asarray(aux)[None],
                               rtol=1e-6)
    return got


def test_moe_capacity_drops():
    """A router that sends most tokens to expert 0: capacity 2 at cf 0.5
    drops the overflow, as the reference does (rank order = token
    order)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(12, 6)).astype(np.float32)
    router = np.zeros((6, 4), np.float32)
    router[:, 0] = 5.0 * np.sign(x.sum(0))
    router += rng.normal(size=(6, 4)).astype(np.float32) * 0.1
    got = _moe_case(router, x, cf=0.5)
    assert (got.abs().sum(-1) == 0).any()     # some token lost every slot


def test_moe_router_ties_pick_the_lower_expert():
    """A zero router gives every expert the same probability: top-k picks
    experts 0 and 1 (the lower indices), as ``jax.lax.top_k`` does."""
    x = np.random.default_rng(2).normal(size=(8, 6)).astype(np.float32)
    router = np.zeros((6, 4), np.float32)
    probs = torch.full((3, 4), 0.25)
    vals, idx = t_moe.router_top_k(probs, 2)
    assert idx.tolist() == [[0, 1]] * 3
    _moe_case(router, x, cf=4.0)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_prefill_and_decode_match_the_reference(arch):
    """Prefill 8 tokens into caches of 12, then 3 cached decode steps:
    each step's logits within rtol 1e-5 of the reference's."""
    rc, tc = cfgs(arch)
    jp, _ = RM.init_model(jax.random.PRNGKey(3), rc)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    tok, _, fe = inputs(rc, seed=3, length=11)
    jc = RM.init_decode_caches(rc, B, 12)
    tcache = TM.init_decode_caches(tc, B, 12, device="cpu")
    jcross = tcross = None
    if fe is not None:
        jcross = (RM.encode(jp, rc, jnp.asarray(fe)) if rc.is_encoder_decoder
                  else jnp.asarray(fe) @ jp["vis_proj"])
        tcross = TM.cross_states(tp, tc, torch.from_numpy(fe))
        close(tcross.numpy(), jcross, 1e-5)
    prefill = jax.jit(lambda p, t, c, cs: RM.prefill(p, rc, t, c,
                                                     cross_states=cs))
    step = jax.jit(lambda p, t, i, c, cs: RM.decode_step(p, rc, t, i, c,
                                                         cross_states=cs))
    jl, jc = prefill(jp, jnp.asarray(tok[:, :8]), jc, jcross)
    with torch.no_grad():
        tl, tcache = TM.prefill(tp, tc, torch.from_numpy(tok[:, :8]),
                                tcache, cross_states=tcross)
        close(tl.numpy(), jl, 1e-5)
        for i in range(8, 11):
            jl, jc = step(jp, jnp.asarray(tok[:, i]), jnp.int32(i), jc,
                          jcross)
            tl, tcache = TM.decode_step(tp, tc, torch.from_numpy(tok[:, i]),
                                        torch.tensor(i), tcache,
                                        cross_states=tcross)
            close(tl.numpy(), jl, 1e-5)


def test_cached_decode_equals_a_full_forward():
    """The port against itself: the cached decode's logits are a full
    no-cache forward's at the same positions (within 1e-5)."""
    _, tc = cfgs("smollm-135m")
    tp = TM.init_model(prng.PRNGKey(4), tc, device="cpu")
    tok = torch.from_numpy(inputs(tc, seed=4, length=10)[0])
    with torch.no_grad():
        full, _, _ = TM.forward(tp, tc, tok)
        caches = TM.init_decode_caches(tc, B, 10, device="cpu")
        last, caches = TM.prefill(tp, tc, tok[:, :6], caches)
        close(last.numpy(), full[:, 5].numpy(), 1e-5)
        for i in range(6, 10):
            step, caches = TM.decode_step(tp, tc, tok[:, i], i, caches)
            close(step.numpy(), full[:, i].numpy(), 1e-5)


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, tc = cfgs("smollm-135m")
    with pytest.raises(RuntimeError):
        TM.init_model(prng.PRNGKey(0), tc)
    assert dataclasses.replace(tc, remat=True).remat


def test_remat_changes_no_number():
    """``cfg.remat`` (``torch.utils.checkpoint``, recomputing each block
    in the backward) gives the same loss and gradients bitwise."""
    _, tc = cfgs("smollm-135m")
    params = {n: t.unsqueeze(0).expand((2,) + tuple(t.shape)).contiguous()
              for n, t in TM.init_model(prng.PRNGKey(8), tc,
                                        device="cpu").items()}
    tok, tgt, _ = inputs(tc, seed=8, m=2)
    batch = {"tokens": torch.from_numpy(tok), "targets": torch.from_numpy(tgt)}
    from repro_torch.core.local_sgd import loss_and_grad
    out = [loss_and_grad(lambda p, b, r, c=c: TM.loss_fn(p, c, b), params,
                         batch, None)
           for c in (tc, dataclasses.replace(tc, remat=True))]
    assert torch.equal(out[0][0], out[1][0])
    for n in params:
        assert torch.equal(out[0][1][n], out[1][1][n]), n


def test_convert_lists_keep_their_order():
    """A list of 12 entries flattens as ``s/00`` ... ``s/11`` (sorted
    names in list order, ``jax.tree.flatten``'s), and comes back with its
    empty entries when ``like`` is given."""
    tree = {"s": [{"w": np.full((2,), i, np.float32)} if i != 4 else {}
                  for i in range(12)], "e": {}}
    names = convert.flat_names(tree)
    assert names == [f"s/{i:02d}/w" for i in range(12) if i != 4]
    flat = convert.params_from_numpy(tree, device="cpu")
    assert [int(t[0]) for t in flat.values()] == [i for i in range(12)
                                                 if i != 4]
    back = convert.params_to_numpy(flat, like=tree)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    assert back["s"][4] == {} and back["e"] == {}
    assert convert.params_to_numpy(
        {"s/0/w": torch.zeros(1), "s/1/w": torch.ones(1)})["s"][1]["w"] == 1


def test_resident_lane_capacity():
    from repro_torch.launch.mesh import resident_lane_capacity
    assert resident_lane_capacity(1 << 20, budget_bytes=64 << 20) == 16
    assert resident_lane_capacity(1 << 30, device="cpu") == 1
    assert resident_lane_capacity(1 << 20, device="cpu") == 512
    # A 2D mesh's device holds 1/model_parallel of a lane at rest (the
    # reference's ceil(bytes / model_parallel)).
    assert resident_lane_capacity(1 << 20, budget_bytes=1 << 30,
                                  model_parallel=2) == 512
    assert resident_lane_capacity(3, budget_bytes=64,
                                  model_parallel=2) == 8
    with pytest.raises(ValueError, match="model_parallel"):
        resident_lane_capacity(1 << 20, budget_bytes=1 << 30,
                               model_parallel=0)
