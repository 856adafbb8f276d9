"""The tensor-parallel local step of the other families on a 2D (clients,
model) mesh, on the CPU: the MoE, SSM, hybrid, encoder-decoder and VLM
blocks' column-parallel forms against the port's unsharded blocks, each
family's column-parallel loss against the JAX package's ``loss_fn``, and
one driver round a family against the 1D mesh.

Each family runs a reduced config at two values of mp, chosen so that
both of the strategy-A rules' cuts fire where a family has two:

* MoE (Qwen3-MoE reduced, ``moe_d_ff`` 192, 6 query / 3 KV heads): mp 2
  cuts the 4 experts (and the heads; the KV heads stay replicated), mp 3
  does not divide them and cuts every expert's ``moe_d_ff`` instead (the
  heads too). The routing decisions of the form equal the unsharded
  block's at every seed (zero flips).
* SSM (Mamba2 reduced, 32 heads of 16) at mp 2 and 4, ``ssm_inner`` and
  ``ssm_heads`` cut together. At d_model 24 (3 heads of 16) mp 2 divides
  the inner dim but not the heads: the form reads each column's
  channels as sub-heads and the step stays tensor-parallel.
* Hybrid (Zamba2 reduced): the Mamba2 stages, and the shared block's
  attention, MLP and ``down`` (row-parallel over ``concat(x, x_first)``),
  re-entered twice, at mp 2 and 4.
* Encoder-decoder (Whisper reduced, 6 heads, d_ff 384, vocab 384): the
  encoder's blocks, the decoder's self- and cross-attention, at mp 2 and
  3; the frontend's 16 frames through the encoder under the group.
* VLM (Llama-3.2-Vision reduced, 6 query / 2 KV heads, d_ff 384, vocab
  384): the gated cross-attention and MLP at mp 2 (KV heads cut) and 3
  (KV heads replicated, narrowed per column).

Tolerances: a block's forward and every gradient within rtol 1e-5 (f32,
of the output's or leaf's largest magnitude); the model's loss within
1e-5 and its gradients within 1e-4 of the reference's (the tolerances of
``tests/test_torch_models.py``); a driver round's loss and consensus
within rtol 1e-5 of the 1D mesh's (an 8-bit stochastic wire).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as rcfg  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch.core import local_sgd  # noqa: E402
from repro_torch.core.mixing import _column_dims  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models import transformer as t_tr  # noqa: E402
from repro_torch.sharding import RULES_A, specs_for_tree  # noqa: E402
from repro_torch.sharding.tensor_parallel import (  # noqa: E402
    ColumnGroup, local_step_kind)

torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

RTOL, LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-5, 1e-4
M = 2
# family -> (arch, overrides of its reduced config, the two mp values)
FAMILIES = {
    "moe": ("qwen3-moe-30b-a3b", dict(moe_d_ff=192, n_heads=6,
                                      n_kv_heads=3), (2, 3)),
    "ssm": ("mamba2-780m", {}, (2, 4)),
    "hybrid": ("zamba2-1.2b", {}, (2, 4)),
    "encdec": ("whisper-tiny", dict(n_heads=6, n_kv_heads=6, d_ff=384,
                                    vocab_size=384), (2, 3)),
    "vlm": ("llama-3.2-vision-11b", dict(n_heads=6, n_kv_heads=2,
                                         d_ff=384, vocab_size=384), (2, 3)),
}
# Mamba2 at d_model 24: d_inner 48 divides by 2, its 3 heads do not.
SSM_CROSSING = ("mamba2-780m", dict(d_model=24), 2)


def cfgs(arch, over):
    rc = dataclasses.replace(rcfg.reduced(rcfg.get_config(arch)), **over)
    tc = dataclasses.replace(tcfg.reduced(tcfg.get_config(arch)), **over)
    return rc, tc


def close(got, want, rtol, what=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want.detach() if isinstance(want, torch.Tensor)
                      else want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (what, err, scale)


def params_of(tc, seed=0):
    """The port's init of ``tc`` stacked for M clients, each leaf moved by
    a little noise (the clients differ, the VLM's gates are not zero)."""
    p = TM.init_model(prng.PRNGKey(seed), tc, device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    return {n: t[None].expand((M,) + t.shape)
            + 0.02 * torch.randn((M,) + t.shape, generator=g).to(t.dtype)
            for n, t in p.items()}


def row_of(tc, mp, params):
    """A one-shard (1, mp) CPU mesh under RULES_A: its specs, the row's
    cells and its column group."""
    mesh = make_test_mesh(1, model_parallel=mp, device="cpu")
    specs = specs_for_tree(TM.model_axes(tc), params, RULES_A, mesh,
                           leading_client=("clients",))
    return mesh, specs, mesh.shard(params, specs), ColumnGroup(
        list(mesh.devices[0]), _column_dims(mesh, specs))


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def block_leaves(params, dims, prefix, mp, stacked):
    """Block ``prefix``'s first layer (``stacked``: a stage's leaves carry
    the layer axis) as (full leaves, cut leaves): a cut leaf the list of
    its column slices, each a leaf of its own."""
    full, cut = {}, {}
    for n, t in params.items():
        if not n.startswith(prefix + "/"):
            continue
        inner = n[len(prefix) + 1:]
        one = t[:, 0] if stacked else t
        full[inner] = one.clone().requires_grad_(True)
        d = dims.get(n)
        if d is None:
            cut[inner] = one.clone().requires_grad_(True)
        else:
            d -= 1 if stacked else 0
            cut[inner] = [p.clone().requires_grad_(True)
                          for p in one.chunk(mp, dim=d)]
    return full, cut


def block_matches(tc, mp, kind, prefix, *, stacked=True, cross=False,
                  seed=0):
    """Block ``kind`` (its leaves under ``prefix``) with its column group
    against the unsharded block: output, aux loss and every gradient
    (the inputs' too) within RTOL, for one random projection of the
    outputs."""
    params = params_of(tc, seed)
    _, _, _, group = row_of(tc, mp, params)
    full, cut = block_leaves(params, group.dims, prefix, mp, stacked)
    assert any(isinstance(v, list) for v in cut.values()), prefix
    g = torch.Generator().manual_seed(seed + 7)
    x = torch.randn((M, 2, 12, tc.d_model), generator=g)
    extra = {}
    if kind == "shared":
        extra["x_first"] = torch.randn(x.shape, generator=g)
    if cross:
        extra["cross_kv"] = torch.randn((M, 2, 10, tc.d_model), generator=g)
    pos = torch.arange(x.shape[2], dtype=torch.int32)
    ins = {}
    for arm in ("full", "cut"):
        ins[arm] = {k: v.clone().requires_grad_(True)
                    for k, v in dict(x=x, **extra).items()}
    want, _, aux_w = t_tr.apply_block(full, cfg=tc, kind=kind,
                                      positions=pos, **ins["full"])
    got, _, aux_g = t_tr.apply_block(cut, cfg=tc, kind=kind, positions=pos,
                                     tp=group, **ins["cut"])
    close(got, want, RTOL, f"{prefix} forward")
    close(aux_g, aux_w, RTOL, f"{prefix} aux")
    r = torch.randn(want.shape, generator=g)
    gf = torch.autograd.grad((want * r).sum() + aux_w.sum(),
                             list(ins["full"].values()) + list(full.values()),
                             allow_unused=True, materialize_grads=True)
    gc = torch.autograd.grad((got * r).sum() + aux_g.sum(),
                             list(ins["cut"].values())
                             + [p for v in cut.values()
                                for p in (v if isinstance(v, list) else [v])],
                             allow_unused=True, materialize_grads=True)
    it = iter(gc)
    for (name, v), want_g in zip(list(ins["cut"].items()) + list(cut.items()),
                                 gf):
        if isinstance(v, list):
            d = group.dims[f"{prefix}/{name}"] - (1 if stacked else 0)
            got_g = torch.cat([next(it) for _ in v], dim=d)
        else:
            got_g = next(it)
        close(got_g, want_g, RTOL, f"{prefix} grad {name}")
    return group


def _record_routing(monkeypatch):
    """Every ``router_top_k`` call's expert indices, in call order."""
    seen = []
    real = t_moe.router_top_k

    def recorded(probs, k):
        vals, idx = real(probs, k)
        seen.append(idx.detach().clone())
        return vals, idx

    monkeypatch.setattr(t_moe, "router_top_k", recorded)
    return seen


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mp", FAMILIES["moe"][2])
def test_moe_block_column_parallel(mp, seed, monkeypatch):
    """The MoE block (attention, then the experts) cut on its experts at
    mp 2 and on every expert's ``moe_d_ff`` at mp 3: output, the balance
    loss and every gradient within rtol 1e-5, and no routing decision
    that differs from the unsharded block's."""
    arch, over, _ = FAMILIES["moe"]
    _, tc = cfgs(arch, over)
    seen = _record_routing(monkeypatch)
    group = block_matches(tc, mp, "moe", "stages/0", seed=seed)
    cut = {n.split("/")[-1]: d for n, d in group.dims.items()
           if "/moe/" in n and n.startswith("stages/0")}
    assert cut == ({"router": 3, "wg": 2, "wu": 2, "wd": 2} if mp == 2 else
                   {"router": None, "wg": 4, "wu": 4, "wd": 3}), cut
    want, got = seen
    flips = int((want != got).any(dim=-1).sum())
    assert flips == 0, f"{flips} tokens routed otherwise"


@pytest.mark.parametrize("mp", FAMILIES["ssm"][2])
def test_ssm_block_column_parallel(mp):
    """The Mamba2 block with ``ssm_inner`` and ``ssm_heads`` cut: each
    column's heads through ``ssd_chunked`` with the shared B and C, the
    gated norm's mean over the whole inner dim, ``wo`` row-parallel."""
    arch, over, _ = FAMILIES["ssm"]
    _, tc = cfgs(arch, over)
    group = block_matches(tc, mp, "ssm", "stages/0")
    assert group.dims["stages/0/mixer/A_log"] is not None
    assert group.dims["stages/0/mixer/wB"] is None


@pytest.mark.parametrize("mp", FAMILIES["hybrid"][2])
def test_hybrid_shared_block_column_parallel(mp):
    """Zamba2's shared block over ``concat(x, x_first)``: its attention
    and MLP cut as in the dense block, ``down`` row-parallel over the
    concatenation sliced across the columns (no layer axis)."""
    arch, over, _ = FAMILIES["hybrid"]
    _, tc = cfgs(arch, over)
    group = block_matches(tc, mp, "shared", "shared_attn", stacked=False)
    assert group.dims["shared_attn/down"] == 1


@pytest.mark.parametrize("kind", ["enc", "cross"])
@pytest.mark.parametrize("mp", FAMILIES["encdec"][2])
def test_encdec_blocks_column_parallel(mp, kind):
    """Whisper's encoder block (non-causal, the dense form) and decoder
    block: self-attention, cross-attention over the home's encoder states
    through each column's ``wk``/``wv`` slice, the ReLU MLP."""
    arch, over, _ = FAMILIES["encdec"]
    _, tc = cfgs(arch, over)
    block_matches(tc, mp, kind, "enc_stage" if kind == "enc" else
                  "stages/0", cross=(kind == "cross"))


@pytest.mark.parametrize("mp", FAMILIES["vlm"][2])
def test_vlm_xattn_block_column_parallel(mp):
    """The gated cross-attention block: KV heads cut at mp 2, replicated
    and narrowed per column at mp 3; the gates replicated scalars."""
    arch, over, _ = FAMILIES["vlm"]
    _, tc = cfgs(arch, over)
    group = block_matches(tc, mp, "xattn", "stages/1", cross=True)
    assert (group.dims["stages/1/xattn/wk"] is None) == (mp == 3)
    assert group.dims["stages/1/gate_attn"] is None


# ---------------------------------------------------------------------------
# The whole model against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=list(FAMILIES))
def family_ref(request):
    """A family's reduced config, one model's parameters (the port's init
    moved by a little noise, handed to the reference as numpy) stacked
    for M clients, and the reference's loss and per-client gradients at
    them (one jitted ``vmap`` of ``value_and_grad`` over two batches)."""
    arch, over, mps = FAMILIES[request.param]
    rc, tc = cfgs(arch, over)
    one = {n: t[0] for n, t in params_of(tc).items()}
    like = jax.eval_shape(lambda k: RM.init_model(k, rc)[0],
                          jax.random.PRNGKey(0))
    jp = convert.params_to_numpy(one, like=like)
    rng = np.random.default_rng(5)
    tok = rng.integers(0, rc.vocab_size, (M, 2, 16)).astype(np.int32)
    tgt = rng.integers(0, rc.vocab_size, (M, 2, 16)).astype(np.int32)
    batch = {"tokens": tok, "targets": tgt}
    if rc.frontend:
        batch["frontend"] = rng.normal(size=(M, 2, rc.frontend_tokens,
                                             rc.d_model)).astype(np.float32)

    def one_client(p, b):
        return jax.value_and_grad(lambda q: RM.loss_fn(q, rc, b))(p)

    loss, grads = jax.jit(jax.vmap(one_client, in_axes=(None, 0)))(
        jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, batch))
    want = dict(zip(convert.flat_names(grads),
                    (np.asarray(g) for g in jax.tree.leaves(grads))))
    params = {n: t[None].expand((M,) + t.shape).contiguous()
              for n, t in one.items()}
    return dict(family=request.param, tc=tc, mps=mps, params=params,
                batch={k: torch.from_numpy(v) for k, v in batch.items()},
                loss=np.asarray(loss), grads=want)


def test_model_loss_and_grads_against_the_reference(family_ref, monkeypatch):
    """``make_loss(cfg)``'s column-parallel form on a mesh row at both mp
    values against ``repro.models.model.loss_fn``: loss within 1e-5,
    every gradient (the cut ones gathered) within 1e-4; the step the
    round would take is tensor-parallel. For the MoE, the form routes
    every token as the unsharded port does at the same parameters."""
    c = family_ref
    tc = c["tc"]
    loss_fn = TM.make_loss(tc)
    for mp in c["mps"]:
        mesh, specs, cells, group = row_of(tc, mp, c["params"])
        n_cut = sum(d is not None for d in group.dims.values())
        assert n_cut >= 4, (mp, group.dims)
        assert local_step_kind(loss_fn, group.dims) == "tensor_parallel"
        seen = _record_routing(monkeypatch)
        got_loss, g_cells = local_sgd.loss_and_grad_columns(
            group, loss_fn, cells, c["batch"], None)
        np.testing.assert_allclose(got_loss.numpy(), c["loss"],
                                   rtol=LOSS_RTOL)
        got = mesh.gather(g_cells, specs)
        assert list(got) == list(c["grads"])
        for name, g in got.items():
            close(g, c["grads"][name], GRAD_RTOL, f"mp {mp} {name}")
        if c["family"] == "moe":
            n_tp = len(seen)
            local_sgd.loss_and_grad(loss_fn, c["params"], c["batch"], None)
            for a, b in zip(seen[:n_tp], seen[n_tp:]):
                assert torch.equal(a, b), f"mp {mp}: a routing flip"
        monkeypatch.undo()


@pytest.mark.parametrize("arch", tcfg.list_archs())
def test_every_arch_carries_a_form(arch):
    """``make_loss`` carries a column-parallel form for every registered
    arch, and at mp 2 over its full-width specs the form takes every cut
    leaf (the registered widths divide where a form needs them to)."""
    cfg = tcfg.get_config(arch)
    loss = TM.make_loss(cfg)
    meta = TM.init_model(torch.zeros(2, dtype=torch.int64, device="meta"),
                         cfg, device="meta")
    from repro_torch.sharding import stack_shapes
    mesh = make_test_mesh(1, model_parallel=2, device="cpu")
    specs = specs_for_tree(TM.model_axes(cfg), stack_shapes(meta, 2),
                           RULES_A, mesh, leading_client=("clients",))
    dims = _column_dims(mesh, specs)
    assert any(d is not None for d in dims.values())
    assert local_step_kind(loss, dims) == "tensor_parallel"


def test_ssm_cut_across_heads_declines():
    """Mamba2 at d_model 24 on mp 2: ``ssm_inner`` (48) is cut, its 3
    heads are not, so a column's 24 channels cross a head boundary. The
    form, which once declined those leaves, now takes every cut leaf
    (the step is tensor-parallel), the heads' leaves stay replicated,
    and the mixer block (sub-heads of 8) matches the unsharded one:
    forward and every gradient within rtol 1e-5."""
    arch, over, mp = SSM_CROSSING
    _, tc = cfgs(arch, over)
    params = params_of(tc)
    _, _, _, group = row_of(tc, mp, params)
    dims = group.dims
    form = TM.make_loss(tc).column_parallel
    assert dims["stages/0/mixer/wx"] is not None
    assert dims["stages/0/mixer/A_log"] is None
    declined = sorted(n for n, d in dims.items()
                      if d is not None and not form.covers(n, dims))
    assert declined == [], declined
    assert local_step_kind(TM.make_loss(tc), dims) == "tensor_parallel"
    block_matches(tc, mp, "ssm", "stages/0")


# ---------------------------------------------------------------------------
# One driver round a family against the 1D mesh
# ---------------------------------------------------------------------------

def _driver(tc, arch, mp, capsys):
    """One 8-bit round of ``tc`` through ``run_resident`` (4 clients on
    the ring, K 2, batch 1, seq 8) on a (2, mp) CPU test mesh (or the 1D
    mesh of its 2 shards, mp 1): the metrics and the console."""
    from repro_torch.launch import train as TT
    from repro_torch.telemetry import RunLog, Tracer
    argv = ["--arch", arch, "--clients", "4", "--rounds", "1", "--bits",
            "8", "--local-steps", "2", "--batch", "1", "--seq", "8",
            "--device", "cpu"]
    mesh = make_test_mesh(2, "cpu")
    if mp > 1:
        argv += ["--model-parallel", str(mp)]
        mesh = make_test_mesh(2, model_parallel=mp, device="cpu")
    args = TT.build_parser().parse_args(argv)
    log = RunLog(jsonl=None)
    _, met = TT.run_resident(args, tc, log, Tracer(False), mesh=mesh)
    log.close()
    return met, capsys.readouterr().out


@pytest.mark.parametrize("family", list(FAMILIES) + ["ssm-crossing"])
def test_driver_round_against_the_1d_mesh(family, capsys):
    """The driver's round on a (2, 2) mesh against the 1D mesh of its 2
    shards: the "local step:" line (tensor-parallel, the SSM's inner dim
    cut across its heads too), loss and consensus within rtol 1e-5."""
    if family == "ssm-crossing":
        arch, over, mp = SSM_CROSSING
        _, tc = cfgs(arch, over)
    else:
        arch, over, _ = FAMILIES[family]
        mp = 2
        _, tc = cfgs(arch, over)
        # Narrower than the other tests (the wire's noise is drawn by the
        # plain threefry here, a value at a time): every cut still fires.
        tc = dataclasses.replace(tc, d_model=64, vocab_size=128,
                                 d_ff=min(tc.d_ff, 128),
                                 moe_d_ff=min(tc.moe_d_ff, 64))
    one, _ = _driver(tc, arch, 1, capsys)
    two, out = _driver(tc, arch, mp, capsys)
    line = next(ln for ln in out.splitlines() if "local step:" in ln)
    assert f"local step: tensor_parallel ({tc.arch_type} family" in line, \
        line
    for k in ("loss", "consensus_dist"):
        np.testing.assert_allclose(float(two[k]), float(one[k]), rtol=RTOL,
                                   err_msg=k)


def test_ssd_gradients_stay_finite_over_a_long_chunk():
    """The reduced Mamba2 mixer over 128 tokens in one chunk (the
    driver's sequence): the intra-chunk decay above the diagonal would
    overflow f32 and the reference's ``where(tri, exp(diff), 0)`` turns
    every gradient into NaN there; the port masks before the exp. Its
    output and gradients are finite and within rtol 1e-5 of the same
    mixer run in chunks of 16, where no entry overflows."""
    from repro_torch.models import ssm as t_ssm
    _, tc = cfgs(*FAMILIES["ssm"][:2])
    params = params_of(tc)
    mixer = {n.split("/")[-1]: t[:, 0] for n, t in params.items()
             if n.startswith("stages/0/mixer/")}
    x = torch.randn((M, 1, 128, tc.d_model),
                    generator=torch.Generator().manual_seed(3))
    r = torch.randn((M, 1, 128, tc.d_model),
                    generator=torch.Generator().manual_seed(4))
    outs = []
    for chunk in (128, 16):
        p = {n: t.clone().requires_grad_(True) for n, t in mixer.items()}
        y, _ = t_ssm.apply_mamba2(p, x, head_dim=tc.ssm_head_dim,
                                  chunk=chunk)
        outs.append((y, torch.autograd.grad((y * r).sum(),
                                            list(p.values()))))
    (y1, g1), (y2, g2) = outs
    assert all(bool(g.isfinite().all()) for g in g1)
    close(y1, y2, RTOL, "output")
    for n, a, b in zip(mixer, g1, g2):
        close(a, b, RTOL, n)
