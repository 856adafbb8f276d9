"""Model-sharded serving on a ("data", "model") mesh of real cells
(``repro_torch.launch.build``'s prefill and decode on a
``launch.mesh.ServeMesh``) against the JAX package's one-device
functions and the port's own unsharded blocks, on the CPU.

* Every registered family, reduced, in f32, from the reference's
  parameters: the built prefill (the last position's logits), the
  cache-filling prefill on the decode's layout and 3 built decode steps
  on a (2, 2) mesh and on (1, 3), whose model axis divides nothing of
  the reduced configs, against ``repro.models.model.forward(...,
  last_only=True)``, ``prefill`` and ``decode_step`` jitted on one
  device, within rtol 1e-5 (atol = 1e-5 x the largest |logit| of the
  reference's step), the greedy tokens equal (decoded teacher-forced
  on the reference's greedy tokens). A MoE routes the whole batch as
  one dispatch group, as the reference's serving does, however many
  data rows serve it. The reference runs in subprocesses started with
  the module, beside the port's block-level cases.
* Block-level cases against the port's unsharded cached block, within
  1e-5: attention's KV-heads cut, head_dim cut (with the decode hint's
  partial scores, and the gathered cache without it) and replicated
  caches, each also as a sliding-window ring; Zamba2's shared block with
  its own cache; the Mamba2 mixer's conv and state cuts and its
  replicated form, and the refusal of an inner dim cut across heads;
  Whisper's and the VLM's cross states.
* The data axis: reduced Mixtral under ``RULES_SERVE_2D`` (weights cut
  over "data" and "model") equals its one program within 1e-5, and each
  data-cut weight's gather is recorded as that row's share of an
  all-gather over its data column.
* The dry run: a serving step built on ``meta`` cells records the same
  collective bytes as the same build on CPU cells.
"""
import contextlib
import dataclasses
import os
import shutil
import subprocess
import sys
import tempfile
import textwrap
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import prng  # noqa: E402
from repro_torch.configs import get_config, list_archs, reduced  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import build as B  # noqa: E402
from repro_torch.launch import hlo_stats  # noqa: E402
from repro_torch.launch.cost_model import structural_costs  # noqa: E402
from repro_torch.launch.mesh import make_named_mesh  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.moe import MOE_GROUPS  # noqa: E402
from repro_torch.sharding import (P, RULES_SERVE, RULES_SERVE_2D,  # noqa: E402
                                  model_sharded_dims, specs_for_tree)

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = list_archs()
MESHES = {"2x2": (2, 2), "1x3": (1, 3)}
BATCH, PROMPT, STEPS, S_ALLOC = 4, 8, 3, 16
RTOL = 1e-5
N_REFERENCE_PROCS = 4

_REFERENCE = textwrap.dedent("""
    import os, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config, reduced
    from repro.models import model as RM

    def flat(tree, prefix=""):
        # repro_torch.convert's names: keys joined by "/", a list index
        # zero-padded to the width of the list's last index
        if isinstance(tree, dict):
            items = tree.items()
        elif isinstance(tree, (list, tuple)):
            w = len(str(max(len(tree) - 1, 0)))
            items = ((f"{i:0{w}d}", t) for i, t in enumerate(tree))
        else:
            return {prefix[:-1]: np.asarray(tree)}
        out = {}
        for k, t in items:
            out.update(flat(t, f"{prefix}{k}/"))
        return out

    archs, out = sys.argv[1].split(","), sys.argv[2]
    b, lp, steps, s_alloc = (int(v) for v in sys.argv[3:7])
    for arch in archs:
        rc = reduced(get_config(arch))
        jp = jax.jit(lambda k: RM.init_model(k, rc)[0])(jax.random.PRNGKey(3))
        rng = np.random.default_rng(3)
        tok = rng.integers(0, rc.vocab_size, (b, lp)).astype(np.int32)
        fe = cs = None
        res = {"tokens": tok}
        if rc.frontend:
            fe = rng.normal(size=(b, rc.frontend_tokens, rc.d_model)
                            ).astype(np.float32)
            cs = (RM.encode(jp, rc, jnp.asarray(fe)) if rc.is_encoder_decoder
                  else jnp.asarray(fe) @ jp["vis_proj"])
            res["fe"], res["cross"] = fe, np.asarray(cs)
        res.update({"p:" + n.replace("/", "|"): a
                    for n, a in flat(jp).items()})
        fwd = jax.jit(lambda p, t, f: RM.forward(
            p, rc, t, frontend_embeds=f, last_only=True)[0][:, 0])
        pre = jax.jit(lambda p, t, c, x: RM.prefill(p, rc, t, c,
                                                    cross_states=x))
        dec = jax.jit(lambda p, t, i, c, x: RM.decode_step(
            p, rc, t, i, c, cross_states=x))
        res["forward"] = np.asarray(fwd(
            jp, jnp.asarray(tok), None if fe is None else jnp.asarray(fe)))
        logits, c = pre(jp, jnp.asarray(tok),
                        RM.init_decode_caches(rc, b, s_alloc), cs)
        res["prefill"] = np.asarray(logits)
        greedy = [np.asarray(jnp.argmax(logits, -1))]
        for i in range(steps):
            logits, c = dec(jp, jnp.asarray(greedy[-1]), jnp.int32(lp + i),
                            c, cs)
            res[f"decode{i}"] = np.asarray(logits)
            greedy.append(np.asarray(jnp.argmax(logits, -1)))
        res["greedy"] = np.stack(greedy, 1)
        with open(f"{out}/{arch}.part", "wb") as f:
            np.savez(f, **res)
        os.replace(f"{out}/{arch}.part", f"{out}/{arch}.npz")
""")


@pytest.fixture(scope="module", autouse=True)
def reference():
    """The reference's outputs of every family, computed by
    N_REFERENCE_PROCS subprocesses started with the module (the port's
    block-level cases run meanwhile); ``reference(arch)`` waits for
    ``arch``'s file."""
    out = tempfile.mkdtemp(prefix="serve_mesh_ref_")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")])}
    procs = {}
    for k in range(N_REFERENCE_PROCS):
        archs = ARCHS[k::N_REFERENCE_PROCS]
        log = open(os.path.join(out, f"ref{k}.log"), "w")
        p = subprocess.Popen(
            [sys.executable, "-c", _REFERENCE, ",".join(archs), out,
             str(BATCH), str(PROMPT), str(STEPS), str(S_ALLOC)],
            stdout=subprocess.DEVNULL, stderr=log, env=env, cwd=ROOT)
        log.close()
        for a in archs:
            procs[a] = (p, k)

    def get(arch):
        p, k = procs[arch]
        path = os.path.join(out, f"{arch}.npz")
        deadline = time.monotonic() + 600
        while not os.path.exists(path):
            if p.poll() is not None or time.monotonic() > deadline:
                with open(os.path.join(out, f"ref{k}.log")) as f:
                    raise AssertionError(f"no reference for {arch} "
                                         f"(rc {p.poll()}):\n"
                                         f"{f.read()[-4000:]}")
            time.sleep(0.1)
        with np.load(path) as z:
            return dict(z)

    yield get
    for p, _ in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()
    shutil.rmtree(out, ignore_errors=True)


def close(got, want, rtol=RTOL, what=""):
    """|got - want| <= rtol x max |want| (the stated atol)."""
    got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want.detach().cpu() if isinstance(want, torch.Tensor)
                      else want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (what, err, scale)


@contextlib.contextmanager
def moe_groups(g):
    tok = MOE_GROUPS.set((g, None)) if g > 1 else None
    try:
        yield
    finally:
        if tok is not None:
            MOE_GROUPS.reset(tok)


# ---------------------------------------------------------------------------
# Block-level cases (the port's sharded blocks against its unsharded ones)
# ---------------------------------------------------------------------------

def _axis(view):
    """A row's view with the client axis of 1 the blocks take."""
    return {n: [t.unsqueeze(0) for t in v] if isinstance(v, list)
            else v.unsqueeze(0) for n, v in view.items()}


def _laid(mesh, params, axes, cache, *, headdim=True, rules=RULES_SERVE):
    """A block's params and cache laid out on ``mesh`` by the serving
    rules and ``_cache_specs``; row 0's group, view and cache view."""
    pspecs = specs_for_tree({n: axes[n] for n in params}, params, rules,
                            mesh)
    cspecs = B._cache_specs([cache], mesh, (), kv_fallback_headdim=headdim)
    pcells, ccells = mesh.shard(params, pspecs), mesh.shard([cache], cspecs)
    group = mesh.row_group((0,), model_sharded_dims(pspecs, "model"))
    view = _axis(mesh.row_view(pcells, pspecs, (0,)))
    cview = mesh.row_view(ccells, cspecs, (0,), every_column=True)[0]
    return group, view, cview, ccells, cspecs, pspecs


ATTN_AXES = {n: a for n, a in M._ATTN.items()}
# name -> (n_heads, n_kv, head_dim, head_dim fallback, layout on mp 2)
LAYOUTS = {"kv_cut": (4, 2, 16, True), "hd_cut_q_cut": (6, 3, 16, True),
           "hd_cut_q_replicated": (3, 3, 16, True),
           "replicated_q_cut": (6, 3, 16, False),
           "replicated_q_replicated": (3, 3, 16, False)}


@pytest.mark.parametrize("window", [0, 4])
@pytest.mark.parametrize("hint", [True, False])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_cached_attention_layouts(layout, hint, window):
    """A 3-token prompt then 5 one-token steps through the cached
    attention on a (1, 2) mesh, in each layout ``_cache_specs`` gives,
    against the unsharded cached block: outputs and the gathered cache
    within 1e-5. ``hint``: the decode steps under the builder's
    ``DECODE_Q_SPEC`` (a head_dim-cut cache then sums partial scores;
    without it its slices are gathered). ``window`` 4 with 4 slots: a
    sliding-window ring that wraps."""
    h, kv, hd, fallback = LAYOUTS[layout]
    d, b, s_alloc = 32, 2, (4 if window else 12)
    key = prng.PRNGKey(5)
    params = A.init_attention(key, d, h, kv, hd, qk_norm=True,
                              dtype=torch.float32)
    params = {n: t.to("cpu") for n, t in params.items()}
    cache = A.init_kv_cache(b, s_alloc, kv, hd, torch.float32, device="cpu")
    mesh = make_named_mesh((1, 2), device="cpu")
    group, view, cview, ccells, cspecs, _ = _laid(
        mesh, params, ATTN_AXES, cache, headdim=fallback)
    kspec = cspecs[0]["k"]
    want = {"kv_cut": "model" in kspec.names(3),
            "hd": "model" in kspec.names(4)}
    assert want["kv_cut"] == (layout == "kv_cut")
    assert want["hd"] == layout.startswith("hd_cut")
    assert isinstance(view["wq"], list) == (layout == "kv_cut"
                                            or layout.endswith("q_cut"))
    full = {n: t.unsqueeze(0) for n, t in params.items()}
    g = torch.Generator().manual_seed(2)
    xs = torch.randn(1, b, 8, d, generator=g)
    kw = dict(n_heads=h, n_kv=kv, qk_norm=True, rope_theta=1e4,
              causal=True, window=window)
    hint_spec = P(None, None, None, None)
    with torch.no_grad():
        steps = [(0, 3)] + [(i, i + 1) for i in range(3, 8)]
        for lo, hi in steps:
            pos = torch.arange(lo, hi, dtype=torch.int32)
            x = xs[:, :, lo:hi]
            y_want, cache = A.apply_attention(full, x, positions=pos,
                                              cache=cache, **kw)
            tok = A.DECODE_Q_SPEC.set(hint_spec if hint and hi - lo == 1
                                      else None)
            try:
                y, _ = A.apply_attention(view, x, positions=pos,
                                         cache=cview, tp=group, **kw)
            finally:
                A.DECODE_Q_SPEC.reset(tok)
            close(y, y_want, what=(lo, hi))
    got = mesh.gather(ccells, cspecs)[0]
    for n in ("k", "v"):
        close(got[n], cache[n], what=n)
    assert torch.equal(got["kpos"], cache["kpos"])


def test_head_dim_hint_sums_partial_scores():
    """Under the decode hint a head_dim-cut cache's one-token step sums
    one partial score block a KV chunk across the columns (an
    all-reduce each) and gathers no cache; without it the step gathers
    the cache's slices instead."""
    h, kv, hd, _ = LAYOUTS["hd_cut_q_cut"]
    params = {n: t.to("cpu") for n, t in A.init_attention(
        prng.PRNGKey(1), 32, h, kv, hd, qk_norm=False,
        dtype=torch.float32).items()}
    mesh = make_named_mesh((1, 2), device="cpu")
    kinds, gathered = {}, {}
    for hint in (True, False):
        cache = A.init_kv_cache(2, 12, kv, hd, torch.float32, device="cpu")
        group, view, cview, *_ = _laid(mesh, params, ATTN_AXES, cache)
        x = torch.randn(1, 2, 1, 32)
        tok = A.DECODE_Q_SPEC.set(P(None, None, None, None) if hint
                                  else None)
        try:
            with hlo_stats.collect_collectives() as coll, torch.no_grad():
                A.apply_attention(view, x, n_heads=h, n_kv=kv,
                                  qk_norm=False, rope_theta=1e4,
                                  positions=torch.tensor([0]), cache=cview,
                                  tp=group)
        finally:
            A.DECODE_Q_SPEC.reset(tok)
        kinds[hint] = [k for k, _ in coll.per_op]
        gathered[hint] = coll.by_kind["all-gather"]
    # the hint: the score sum of the one chunk (12 slots) and wo's
    # partials summed; q and the output's slices gathered, not the cache
    assert kinds[True].count("all-reduce") == 2
    assert kinds[False].count("all-reduce") == 1
    assert gathered[False] > gathered[True]
    with pytest.raises(ValueError, match="DECODE_Q_SPEC"):
        tok = A.DECODE_Q_SPEC.set(P(None, None, "model", None))
        try:
            A.apply_attention(view, x, n_heads=h, n_kv=kv, qk_norm=False,
                              rope_theta=1e4, positions=torch.tensor([1]),
                              cache=cview, tp=group)
        finally:
            A.DECODE_Q_SPEC.reset(tok)


def _block_case(arch, kind, mp):
    cfg = reduced(get_config(arch))
    params = {n: t.to("cpu") for n, t in T.init_block(
        prng.PRNGKey(4), cfg, kind).items()}
    axes = {n: M._BLOCK_AXES[n] for n in params}
    return cfg, params, axes, make_named_mesh((1, mp), device="cpu")


@pytest.mark.parametrize("kind,arch", [("shared", "zamba2-1.2b"),
                                       ("cross", "whisper-tiny")])
def test_shared_and_cross_blocks_cached(kind, arch):
    """Zamba2's shared block with its own unstacked cache, and Whisper's
    decoder block (cached self-attention, cross-attention over the
    encoder states through each column's ``wk``/``wv``), on (1, 2):
    a 4-token prompt and 3 steps within 1e-5 of the unsharded block."""
    cfg, params, axes, mesh = _block_case(arch, kind, 2)
    b = 2
    cache = T.init_stage_cache(cfg, kind, 1, b, 8, torch.float32, m=1,
                               device="cpu")
    if kind != "shared":                      # one layer of the stage
        cache = {n: t[0] for n, t in cache.items()}
    group, view, cview, ccells, cspecs, _ = _laid(mesh, params, axes, cache)
    full = {n: t.unsqueeze(0) for n, t in params.items()}
    g = torch.Generator().manual_seed(3)
    xs = torch.randn(1, b, 7, cfg.d_model, generator=g)
    first = torch.randn(1, b, 7, cfg.d_model, generator=g)
    cross = torch.randn(1, b, 5, cfg.d_model, generator=g) \
        if kind == "cross" else None
    with torch.no_grad():
        for lo, hi in [(0, 4), (4, 5), (5, 6), (6, 7)]:
            pos = torch.arange(lo, hi, dtype=torch.int32)
            kw = dict(cfg=cfg, kind=kind, positions=pos, cross_kv=cross,
                      x_first=first[:, :, lo:hi])
            y_want, cache, _ = T.apply_block(full, xs[:, :, lo:hi],
                                             cache=cache, **kw)
            y, _, _ = T.apply_block(view, xs[:, :, lo:hi], cache=cview,
                                    tp=group, **kw)
            close(y, y_want, what=(kind, lo))
    got = mesh.gather(ccells, cspecs)[0]
    close(got["k"], cache["k"])


def test_vlm_cross_states_block():
    """The VLM's gated cross-attention block (no cache) over projected
    patch states, column-parallel on (1, 2), within 1e-5."""
    cfg, params, axes, mesh = _block_case("llama-3.2-vision-11b", "xattn",
                                          2)
    params["gate_attn"] = torch.full((1,), 0.3)
    params["gate_mlp"] = torch.full((1,), -0.2)
    pspecs = specs_for_tree(axes, params, RULES_SERVE, mesh)
    cells = mesh.shard(params, pspecs)
    group = mesh.row_group((0,), model_sharded_dims(pspecs, "model"))
    view = _axis(mesh.row_view(cells, pspecs, (0,)))
    assert isinstance(view["xattn/wk"], list)
    g = torch.Generator().manual_seed(6)
    x = torch.randn(1, 2, 3, cfg.d_model, generator=g)
    cross = torch.randn(1, 2, 6, cfg.d_model, generator=g)
    kw = dict(cfg=cfg, kind="xattn", positions=torch.arange(3),
              cross_kv=cross)
    with torch.no_grad():
        want, _, _ = T.apply_block({n: t.unsqueeze(0)
                                    for n, t in params.items()}, x, **kw)
        got, _, _ = T.apply_block(view, x, tp=group, **kw)
    close(got, want)


MIXER_AXES = {n[len("mixer/"):]: a for n, a in M._BLOCK_AXES.items()
              if n.startswith("mixer/")}


@pytest.mark.parametrize("mp", [2, 3])
def test_cached_mixer_cuts(mp):
    """The Mamba2 mixer with its cache on (1, mp): at mp 2 the inner dim
    and heads cut (``conv_x`` by channel, the state by heads, ``conv_B``
    / ``conv_C`` by channel too: d_state 16), at mp 3 replicated (every
    column's copy takes the home's new state); a 5-token prompt then 3
    steps within 1e-5 of the unsharded mixer, its states too."""
    d, b = 64, 2
    params = {n: t.to("cpu") for n, t in S.init_mamba2(
        prng.PRNGKey(7), d, 16, expand=2, head_dim=16).items()}
    cache = S.init_mamba2_cache(b, d, 16, expand=2, head_dim=16,
                                device="cpu")
    mesh = make_named_mesh((1, mp), device="cpu")
    group, view, cview, ccells, cspecs, _ = _laid(mesh, params, MIXER_AXES,
                                                  cache)
    assert isinstance(view["wx"], list) == (mp == 2)
    assert ("model" in cspecs[0]["ssm"].names(2)) == (mp == 2)
    assert ("model" in cspecs[0]["conv_B"].names(3)) == (mp == 2)
    full = {n: t.unsqueeze(0) for n, t in params.items()}
    xs = torch.randn(1, b, 8, d, generator=torch.Generator().manual_seed(8))
    with torch.no_grad():
        for lo, hi in [(0, 5), (5, 6), (6, 7), (7, 8)]:
            want, cache = S.apply_mamba2(full, xs[:, :, lo:hi], head_dim=16,
                                         cache=cache)
            got, _ = S.apply_mamba2(view, xs[:, :, lo:hi], head_dim=16,
                                    cache=cview, tp=group)
            close(got, want, what=lo)
    got = mesh.gather(ccells, cspecs)[0]
    for n in cache:
        close(got[n], cache[n], what=n)


def test_cached_mixer_refuses_an_inner_dim_cut_across_heads():
    """d_inner 96 over 3 heads of 32: mp 2 cuts the inner dim but not
    the heads (a column's 48 channels cross a head boundary), which the
    cached mixer once refused; it now runs the column's sub-heads of 16
    against its copy of the replicated state and all-gathers the new
    state: a 5-token prompt then 3 steps within 1e-5 of the unsharded
    mixer, every column's state copy bitwise alike and equal to its
    state within 1e-5."""
    d, b = 48, 2
    params = {n: t.to("cpu") for n, t in S.init_mamba2(
        prng.PRNGKey(7), d, 16, expand=2, head_dim=32).items()}
    cache = S.init_mamba2_cache(b, d, 16, expand=2, head_dim=32,
                                device="cpu")
    mesh = make_named_mesh((1, 2), device="cpu")
    group, view, cview, ccells, cspecs, _ = _laid(mesh, params, MIXER_AXES,
                                                  cache)
    assert isinstance(view["wx"], list) and \
        not isinstance(view["A_log"], list)
    assert "model" not in cspecs[0]["ssm"].names(2)
    full = {n: t.unsqueeze(0) for n, t in params.items()}
    xs = torch.randn(1, b, 8, d, generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        for lo, hi in [(0, 5), (5, 6), (6, 7), (7, 8)]:
            want, cache = S.apply_mamba2(full, xs[:, :, lo:hi], head_dim=32,
                                         cache=cache)
            got, _ = S.apply_mamba2(view, xs[:, :, lo:hi], head_dim=32,
                                    cache=cview, tp=group)
            close(got, want, what=lo)
    copies = cview["ssm"]
    assert all(torch.equal(c, copies[0]) for c in copies[1:])
    got = mesh.gather(ccells, cspecs)[0]
    for n in cache:
        close(got[n], cache[n], what=n)


# ---------------------------------------------------------------------------
# The mesh, the data axis and the dry run
# ---------------------------------------------------------------------------

def _mixtral():
    cfg = reduced(get_config("mixtral-8x22b"))
    return cfg, M.init_model(prng.PRNGKey(2), cfg, device="cpu")


def test_serve_mesh_lays_out_and_gathers():
    """A pod x data x model mesh lays Mixtral's params out by
    ``RULES_SERVE_2D`` and a cache tree by ``_cache_specs`` (the batch
    over pod and data) and gathers both back exactly; rows see their
    batch rows; the card is the default device."""
    cfg, params = _mixtral()
    mesh = make_named_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    shapes, axes = B._model_shapes(cfg)
    pspecs = B._serve_param_specs(cfg, mesh, shapes, axes)
    assert pspecs["stages/0/moe/wg"] == P(None, "model", "data", None)
    cells = mesh.shard(params, pspecs)
    assert len(cells) == 8
    assert cells[3]["stages/0/moe/wg"].shape == (2, 2, 128, 256)
    back = mesh.gather(cells, pspecs)
    assert all(torch.equal(back[n], params[n]) for n in params)
    caches = M.init_decode_caches(cfg, 4, 8, device="cpu")
    for c in caches:
        for n, t in c.items():
            t.copy_(torch.randn(t.shape).to(t.dtype))
    dp = B._dp_axes(mesh, 4)
    cspecs = B._cache_specs(caches, mesh, dp)
    ccells = mesh.shard(caches, cspecs)
    assert ccells[5][0]["k"].shape[1] == 1           # 4 rows over 2 x 2
    back = mesh.gather(ccells, cspecs)
    assert all(torch.equal(back[0][n], caches[0][n]) for n in caches[0])
    assert [mesh.batch_rows(r, dp, 4) for r in mesh.rows()] == [
        slice(0, 1), slice(1, 2), slice(2, 3), slice(3, 4)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_named_mesh((1, 2))


def _serve_all(cfg, params, mesh, tokens, steps, cross=None, fe=None):
    """The built prefill, the filling prefill and ``steps`` decode steps
    on ``mesh`` against the one program, fed the one program's greedy
    tokens."""
    b, lp = tokens.shape
    pre = B.build_prefill_step(cfg, mesh, InputShape("p", lp, b, "prefill"))
    dec = B.build_decode_step(cfg, mesh,
                              InputShape("d", S_ALLOC, b, "decode"))
    with torch.no_grad():
        want, _, _ = M.forward(params, cfg, tokens, frontend_embeds=fe,
                               last_only=True)
        close(pre.fn(params, tokens, fe), want[:, 0], what="prefill")
        caches = M.init_decode_caches(cfg, b, S_ALLOC, device="cpu")
        wl, caches = M.prefill(params, cfg, tokens, caches,
                               cross_states=cross)
        gl, cells = dec.prefill(params, tokens,
                                M.init_decode_caches(cfg, b, S_ALLOC,
                                                     device="cpu"), cross)
        close(gl, wl, what="fill")
        pcells = dec.mesh.shard(params, dec.specs[0][0])
        for i in range(steps):
            tok = torch.argmax(wl, -1).to(torch.int32)
            pos = torch.tensor(lp + i, dtype=torch.int32)
            wl, caches = M.decode_step(params, cfg, tok, pos, caches,
                                       cross_states=cross)
            gl, cells = dec.fn(pcells, tok, pos, cells, cross)
            close(gl, wl, what=("decode", i))
    return dec, pcells, cells


def test_data_axis_mixtral_serve_2d():
    """Reduced Mixtral on (2, 2) under ``RULES_SERVE_2D``: its weights'
    "embed" dim cut over "data" (the experts over "model"), gathered
    layer by layer; the built and filling prefills and 3 decode steps
    within 1e-5 of the one program. A decode step's data-axis gathers:
    every data-cut leaf once a row, each row recording its cell's share,
    (g - 1) / g of the leaf's bytes, and at each MoE layer the two
    blocks' per-expert counts (int64)."""
    cfg, params = _mixtral()
    mesh = make_named_mesh((2, 2), device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                           generator=torch.Generator().manual_seed(9),
                           dtype=torch.int32)
    dec, pcells, cells = _serve_all(cfg, params, mesh, tokens, STEPS)
    pspecs = dec.specs[0][0]
    cut = [n for n, s in pspecs.items()
           if any("data" in s.names(i) for i in range(len(s)))]
    assert "stages/0/moe/wg" in cut and "embed/table" in cut
    shares = []
    real = hlo_stats.record

    def record(kind, nbytes, g, senders=None):
        if senders == 1:
            shares.append((kind, nbytes, g))
        real(kind, nbytes, g, senders)

    hlo_stats.record = record
    try:
        with hlo_stats.collect_collectives() as coll, torch.no_grad():
            dec.fn(pcells, torch.zeros(BATCH, dtype=torch.int32),
                   torch.tensor(PROMPT + STEPS, dtype=torch.int32), cells)
    finally:
        hlo_stats.record = real
    whole = sum(params[n].numel() * 4 for n in cut)
    assert {k for k, _, _ in shares} == {"all-gather"}
    counts = cfg.n_layers * 2 * 8 * cfg.n_experts
    assert sum(b for _, b, _ in shares) == 2 * (whole + counts)  # 2 rows
    gathered = sum(b * (g - 1) / g for _, b, g in shares)
    assert coll.by_kind["all-gather"] >= gathered > 0


@pytest.mark.parametrize("factor", [1.25, 0.5])
def test_moe_rows_route_the_batch_as_one_group(factor):
    """Reduced Mixtral on (2, 2), where capacity binds (its registered
    capacity factor, and a lower one): routing each data row's tokens as
    a group of their own (the one program under ``MOE_GROUPS = (2,
    None)``) moves the logits, and the sharded built prefill, filling
    prefill and 3 decode steps equal the whole batch routed as one
    group within 1e-5. Each row records, at each MoE layer, its share
    of an all-gather of the two blocks' per-expert counts."""
    cfg, params = _mixtral()
    cfg = dataclasses.replace(cfg, moe_capacity_factor=factor)
    mesh = make_named_mesh((2, 2), device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                           generator=torch.Generator().manual_seed(11),
                           dtype=torch.int32)
    with torch.no_grad():
        whole = M.forward(params, cfg, tokens, last_only=True)[0]
        with moe_groups(2):
            rows = M.forward(params, cfg, tokens, last_only=True)[0]
    assert float((rows - whole).abs().max()) > 1e-3 * float(
        whole.abs().max())
    dec, pcells, cells = _serve_all(cfg, params, mesh, tokens, STEPS)
    counts = []
    real = hlo_stats.record

    def record(kind, nbytes, g, senders=None):
        if kind == "all-gather" and senders == 1 and nbytes == 2 * 8 * \
                cfg.n_experts:
            counts.append(nbytes)
        real(kind, nbytes, g, senders)

    hlo_stats.record = record
    try:
        with torch.no_grad():
            dec.fn(pcells, torch.zeros(BATCH, dtype=torch.int32),
                   torch.tensor(PROMPT + STEPS, dtype=torch.int32), cells)
    finally:
        hlo_stats.record = real
    assert len(counts) == 2 * cfg.n_layers          # 2 rows x MoE layers


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_meta_build_records_the_cpu_cells_collectives(kind):
    """A serving step built on (2, 2) ``meta`` cells (the dry run's: the
    second row replayed from the first's counts) records a non-null
    collective term equal to the same build's on CPU cells, for SmolLM
    (KV heads cut) and Mixtral (weights over data and model)."""
    for arch in ("smollm-135m", "mixtral-8x22b"):
        cfg = reduced(get_config(arch))
        shape = InputShape("s", 8 if kind == "prefill" else S_ALLOC, BATCH,
                           kind)
        build = B.build_prefill_step if kind == "prefill" \
            else B.build_decode_step
        meta = build(cfg, make_named_mesh((2, 2), device="meta"), shape)
        cpu = build(cfg, make_named_mesh((2, 2), device="cpu"), shape)
        args = [M.init_model(prng.PRNGKey(0), cfg, device="cpu"),
                torch.zeros(cpu.args[1].shape, dtype=torch.int32)]
        if kind == "decode":
            args += [torch.tensor(3, dtype=torch.int32),
                     M.init_decode_caches(cfg, BATCH, S_ALLOC, device="cpu")]
        on_meta = structural_costs(meta.fn, *meta.args)
        on_cpu = structural_costs(cpu.fn, *args)
        assert on_meta.coll_bytes > 0
        assert on_meta.coll_by_kind == on_cpu.coll_by_kind, arch
        assert on_meta.matmul_flops == on_cpu.matmul_flops, arch


# ---------------------------------------------------------------------------
# Every family against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_family_against_the_reference(reference, arch, mesh_name):
    """The port's sharded built prefill, filling prefill and 3 decode
    steps on ``mesh_name`` against the reference's one-device
    ``forward(last_only=True)``, ``prefill`` and ``decode_step``: logits
    within rtol 1e-5, the greedy tokens equal."""
    ref = reference(arch)
    cfg = reduced(get_config(arch))
    shape = MESHES[mesh_name]
    params = {k[2:].replace("|", "/"): torch.from_numpy(v)
              for k, v in ref.items() if k.startswith("p:")}
    assert sorted(params) == sorted(M.model_axes(cfg))
    tokens = torch.from_numpy(ref["tokens"])
    fe = torch.from_numpy(ref["fe"]) if "fe" in ref else None
    cross = torch.from_numpy(ref["cross"]) if "cross" in ref else None
    mesh = make_named_mesh(shape, device="cpu")
    b, lp = tokens.shape
    pre = B.build_prefill_step(cfg, mesh, InputShape("p", lp, b, "prefill"))
    dec = B.build_decode_step(cfg, mesh,
                              InputShape("d", S_ALLOC, b, "decode"))
    greedy = ref["greedy"]
    with torch.no_grad():
        close(pre.fn(params, tokens, fe), ref["forward"],
              what="prefill")
        logits, cells = dec.prefill(params, tokens, M.init_decode_caches(
            cfg, b, S_ALLOC, device="cpu"), cross)
        close(logits, ref["prefill"], what="fill")
        got = [torch.argmax(logits, -1)]
        pcells = dec.mesh.shard(params, dec.specs[0][0])
        for i in range(STEPS):
            logits, cells = dec.fn(
                pcells, torch.from_numpy(greedy[:, i]),
                torch.tensor(lp + i, dtype=torch.int32), cells, cross)
            close(logits, ref[f"decode{i}"], what=("decode", i))
            got.append(torch.argmax(logits, -1))
    assert np.array_equal(torch.stack(got, 1).numpy(), greedy)
