"""The train step of strategies B, B2 and B3 on ("data", "model") cells
(``repro_torch.launch.build.build_train_step`` on a
``launch.mesh.ServeMesh``) against the JAX package's own
``build_train_step(..., strategy=s)`` and the port's global program, on
the CPU.

* Reduced SmolLM-135M and reduced Mixtral-8x22B (f32), one round under
  each strategy on the (4, 2) mesh of CPU cells, from the reference's
  parameters (two clients, each from its own key) and a numpy batch:
  the loss, ``consensus_dist``, ``local_drift`` and every leaf within
  rtol 1e-5, atol 1e-6 of the reference's step, run on
  ``make_test_mesh((4, 2), ("data", "model"))`` of 8 forced host devices
  (in subprocesses started with the module), and of the port's global
  program (``make_round_step`` with no mesh; for a MoE under B2 and B3
  with ``MOE_SHARD_MAP``'s grouping, one dispatch group a data shard).
* Every registered family reduced on (2, 2) against the global program
  (with its frontend embeddings),
  two rounds of the two models above and one of the others, and every
  block that a cut does not tell apart bitwise across the rows and
  columns that hold it; a cut batch the data rows do not divide is
  refused.
* B2's recorded data-axis collectives of one local step (the weight
  gathers, their backward's reduce-scatters, the all-reduces of the
  other gradients) equal a count made from the specs, and B's gradient
  on a data-cut leaf is the global program's, not dp times it.
* ``ServeMesh.row_cells`` of a dim cut over ("data", "model"): column
  c's blocks at positions d * mp + c, in data order; the MoE rows route
  their own tokens under B2 and B3 and the whole batch under B; the
  layouts that ran the global program or were refused before (a
  quantized wire, the multi-pod mesh, B2 on Mamba2, the fused round on
  one pod, a MoE's moe_d_ff the model axis does not divide under a cut
  batch) build on the cells, and the refusal that remains (the fused
  round on the pod mesh). ``tests/test_torch_pods.py`` holds those
  layouts' rounds against the reference.
"""
import contextlib
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
from repro_torch.core import (DFedAvgMConfig, MixingSpec,  # noqa: E402
                              QuantConfig, RoundState, make_round_step)
from repro_torch.core import local_sgd  # noqa: E402
from repro_torch.launch import build as B  # noqa: E402
from repro_torch.launch import hlo_stats  # noqa: E402
from repro_torch.launch.mesh import Cells, make_named_mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.sharding import P  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("smollm-135m", "mixtral-8x22b")
STRATEGIES = ("B", "B2", "B3")
SHAPE = ("t", 16, 8, "train")          # seq 16, global batch 8
RTOL, ATOL = 1e-5, 1e-6
N_REFERENCE_PROCS = 3

_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config, reduced
    from repro.configs.base import InputShape
    from repro.core import RoundState
    from repro.launch import build as B
    from repro.launch.mesh import make_test_mesh
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

    cases, out = sys.argv[1].split(","), sys.argv[2]
    shape = InputShape(sys.argv[3], int(sys.argv[4]), int(sys.argv[5]),
                       sys.argv[6])
    mesh = make_test_mesh((4, 2), ("data", "model"))
    for case in cases:
        arch, s = case.split(":")
        rc = reduced(get_config(arch))
        b = B.build_train_step(rc, mesh, shape, strategy=s)
        m, k, bs, seq = (b.meta[n] for n in ("m", "K", "local_bs", "seq"))
        ps = [RM.init_model(jax.random.PRNGKey(10 + i), rc)[0]
              for i in range(m)]
        stacked = jax.tree.map(lambda *a: jnp.stack(a), *ps)
        tok = np.random.default_rng(7).integers(
            0, rc.vocab_size, (m, k, bs, seq + 1)).astype(np.int32)
        state = RoundState(params=stacked, rng=jax.random.PRNGKey(1),
                           round=jnp.int32(0))
        new, met = b.fn(state, {"tokens": tok[..., :-1],
                                "targets": tok[..., 1:]})
        res = {"tokens": tok, **{f"m:{n}": np.asarray(v)
                                 for n, v in met.items()}}
        res.update({"in:" + n.replace("/", "|"): a
                    for n, a in flat(stacked).items()})
        res.update({"out:" + n.replace("/", "|"): a
                    for n, a in flat(new.params).items()})
        name = case.replace(":", "_")
        with open(f"{out}/{name}.part", "wb") as f:
            np.savez(f, **res)
        os.replace(f"{out}/{name}.part", f"{out}/{name}.npz")
""")

CASES = [(a, s) for a in ARCHS for s in STRATEGIES]
# Every registered family on (2, 2) cells (B2 cuts the SSMs' inner dim
# over ("data", "model"), re-cut on head boundaries at the row's gather).
FAMILY_CASES = [(a, s) for a in list_archs() for s in STRATEGIES]


@pytest.fixture(scope="module", autouse=True)
def reference():
    """The reference's round of every (arch, strategy), computed by
    N_REFERENCE_PROCS subprocesses started with the module (the port's
    other cases run meanwhile); ``reference(arch, s)`` waits for its
    file."""
    out = tempfile.mkdtemp(prefix="strategies_ref_")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")])}
    procs = {}
    for k in range(N_REFERENCE_PROCS):
        cases = CASES[k::N_REFERENCE_PROCS]
        log = open(os.path.join(out, f"ref{k}.log"), "w")
        p = subprocess.Popen(
            [sys.executable, "-c", _REFERENCE,
             ",".join(f"{a}:{s}" for a, s in cases), out,
             *map(str, SHAPE)],
            stdout=subprocess.DEVNULL, stderr=log, env=env, cwd=ROOT)
        log.close()
        for c in cases:
            procs[c] = (p, k)

    def get(arch, s):
        p, k = procs[arch, s]
        path = os.path.join(out, f"{arch}_{s}.npz")
        deadline = time.monotonic() + 600
        while not os.path.exists(path):
            if p.poll() is not None or time.monotonic() > deadline:
                with open(os.path.join(out, f"ref{k}.log")) as f:
                    raise AssertionError(f"no reference for {arch} {s} "
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


def _cfg(arch):
    return reduced(get_config(arch))


def _batches(tok):
    tok = torch.as_tensor(tok)
    return {"tokens": tok[..., :-1].contiguous(),
            "targets": tok[..., 1:].contiguous()}


def _inputs(arch, built, seed=7):
    """Two clients' params, each from its own port key, and a numpy
    batch of the build's shape (with a family's frontend embeddings)."""
    cfg = _cfg(arch)
    meta = built.meta
    m, k, bs, seq = meta["m"], meta["K"], meta["local_bs"], meta["seq"]
    ps = [M.init_model(prng.PRNGKey(10 + i), cfg, device="cpu")
          for i in range(m)]
    params = {n: torch.stack([p[n] for p in ps]) for n in ps[0]}
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (m, k, bs, seq + 1)
                       ).astype(np.int32)
    batches = _batches(tok)
    if cfg.frontend is not None:
        batches["frontend"] = torch.as_tensor(rng.standard_normal(
            (m, k, bs, cfg.frontend_tokens, cfg.d_model)).astype(np.float32))
    return params, batches


@contextlib.contextmanager
def _global_grouping(cfg, mesh, strategy):
    """The reference's MoE grouping for a data-sharded batch (B2, B3) on
    the global program: one dispatch group a data shard."""
    tok = None
    if cfg.n_experts and strategy != "B":
        tok = MOE.MOE_SHARD_MAP.set((mesh, ("data",), ("model",)))
    try:
        yield
    finally:
        if tok is not None:
            MOE.MOE_SHARD_MAP.reset(tok)


def _global_round(cfg, mesh, strategy, params, batches, local_steps=2):
    dfed = DFedAvgMConfig(eta=1e-3, theta=0.9, local_steps=local_steps,
                          mixer_impl="dense")
    step = make_round_step(M.make_loss(cfg), dfed, MixingSpec.ring(2),
                           device="cpu")
    with _global_grouping(cfg, mesh, strategy):
        return step(RoundState(params={n: t.clone() for n, t in
                                       params.items()},
                               rng=prng.PRNGKey(1), round=0), batches)


def _close(got, want, what):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=what)


def _replicas_bitwise(built, cells):
    """Every block that no cut tells apart (a leaf the data axis, or the
    model axis, does not cut) equal bitwise on every cell that holds
    it. Some leaf has replicas unless every leaf is cut over every axis
    (OLMo under B: no norm scales, each matrix cut over both)."""
    mesh, specs = built.mesh, built.specs[0][0].params
    coords = list(np.ndindex(mesh.devices.shape))
    checked, replicated = 0, False
    for n, spec in specs.items():
        used = {a for i in range(len(spec)) for a in spec.names(i)}
        replicated |= used != set(mesh.axis_names)
        groups = {}
        for coord, cell in zip(coords, cells):
            key = tuple(v for a, v in zip(mesh.axis_names, coord)
                        if a in used)
            groups.setdefault(key, []).append(cell[n])
        for blocks in groups.values():
            for b in blocks[1:]:
                assert torch.equal(b, blocks[0]), n
                checked += 1
    assert checked > 0 or not replicated


@pytest.mark.parametrize("arch,strategy", FAMILY_CASES)
def test_cells_on_2x2_match_the_global_program(arch, strategy):
    """Rounds of every registered family on (2, 2) CPU cells (two of the
    two models above, one of the others) against as many of the global
    program; the replicated blocks bitwise after each."""
    cfg = _cfg(arch)
    mesh = make_named_mesh((2, 2), device="cpu")
    built = B.build_train_step(cfg, mesh, InputShape(*SHAPE),
                               strategy=strategy)
    params, batches = _inputs(arch, built, seed=3)
    dfed = DFedAvgMConfig(eta=1e-3, theta=0.9, local_steps=2,
                          mixer_impl="dense")
    gstep = make_round_step(M.make_loss(cfg), dfed, MixingSpec.ring(2),
                            device="cpu")
    gstate = RoundState(params={n: t.clone() for n, t in params.items()},
                        rng=prng.PRNGKey(1), round=0)
    state = RoundState(params=params, rng=prng.PRNGKey(1), round=0)
    rounds = 2 if arch in ARCHS else 1
    for _ in range(rounds):
        state, met = built.fn(state, batches)
        with _global_grouping(cfg, mesh, strategy):
            gstate, gmet = gstep(gstate, batches)
        for k in ("loss", "consensus_dist", "local_drift"):
            _close(met[k], gmet[k].numpy(), k)
        _replicas_bitwise(built, state.params)
    got = mesh.gather(state.params, built.specs[0][0].params)
    for n, t in gstate.params.items():
        _close(got[n], t.numpy(), n)
    assert torch.equal(state.rng, gstate.rng) and state.round == rounds


@pytest.mark.parametrize("strategy", ("B2", "B3"))
def test_a_batch_the_rows_do_not_divide_is_refused(strategy):
    """A cut batch whose dim 2 the data rows do not divide raises rather
    than train on part of it."""
    cfg = _cfg("smollm-135m")
    mesh = make_named_mesh((4, 2), device="cpu")
    built = B.build_train_step(cfg, mesh, InputShape(*SHAPE),
                               strategy=strategy)
    params, batches = _inputs("smollm-135m", built)
    batches = {n: torch.cat([t, t[:, :, :2]], dim=2)
               for n, t in batches.items()}
    with pytest.raises(ValueError, match="does not divide"):
        built.fn(RoundState(params=params, rng=prng.PRNGKey(1), round=0),
                 batches)


def test_masked_batch_weights_each_row_by_its_tokens():
    """Under B3 on (4, 2) with a mask that keeps few of one row's tokens
    and all of another's, each row's loss is weighted by its share of
    the batch's kept tokens (not 1/dp): the round equals the global
    program's masked mean."""
    cfg = _cfg("smollm-135m")
    mesh = make_named_mesh((4, 2), device="cpu")
    built = B.build_train_step(cfg, mesh, InputShape(*SHAPE),
                               strategy="B3")
    params, batches = _inputs("smollm-135m", built, seed=5)
    mask = torch.ones(batches["tokens"].shape, dtype=torch.bool)
    mask[:, :, 0, 3:] = False                 # row 0: 3 tokens a client
    mask[1, :, 2] = False                     # row 2 of client 1: none
    batches["mask"] = mask
    state, met = built.fn(RoundState(params=params, rng=prng.PRNGKey(1),
                                     round=0), batches)
    glob, gmet = _global_round(cfg, mesh, "B3", params, batches)
    for k in ("loss", "consensus_dist", "local_drift"):
        _close(met[k], gmet[k].numpy(), k)
    got = mesh.gather(state.params, built.specs[0][0].params)
    for n, t in glob.params.items():
        _close(got[n], t.numpy(), n)


def test_remat_recomputes_in_the_forward_context():
    """A remat'd MoE block under ``MOE_SHARD_MAP``'s grouping whose
    backward runs on another thread (as autograd's device thread runs a
    card's): the recomputation sees the forward's grouping, and the
    gradients equal those of a backward on the calling thread."""
    import dataclasses
    import threading

    cfg = dataclasses.replace(_cfg("mixtral-8x22b"), remat=True)
    mesh = make_named_mesh((2, 2), device="cpu")
    ps = [M.init_model(prng.PRNGKey(10 + i), cfg, device="cpu")
          for i in range(2)]
    params = {n: torch.stack([p[n] for p in ps]) for n in ps[0]}
    tok = torch.as_tensor(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 4, 17)), dtype=torch.int32)
    batch = {"tokens": tok[..., :-1], "targets": tok[..., 1:]}
    loss_fn = M.make_loss(cfg)

    def grads(other_thread):
        p = {n: t.detach().requires_grad_(True) for n, t in params.items()}
        out = {}

        def back():
            try:
                out["g"] = torch.autograd.grad(loss.sum(), list(p.values()),
                                               allow_unused=True)
            except Exception as e:      # noqa: BLE001 - asserted below
                out["error"] = e

        with _global_grouping(cfg, mesh, "B2"):
            loss = loss_fn(p, batch, None)
            if not other_thread:
                back()
        if other_thread:
            t = threading.Thread(target=back)
            t.start()
            t.join(timeout=120)
            assert not t.is_alive()
        assert "error" not in out, out.get("error")
        return out["g"]

    for a, b in zip(grads(False), grads(True)):
        assert (a is None) == (b is None)
        assert a is None or torch.equal(a, b)


def _record_calls(monkeypatch):
    calls = []
    real = hlo_stats.record

    def record(kind, result_bytes, g, senders=None):
        calls.append((kind, result_bytes, g, senders))
        return real(kind, result_bytes, g, senders)

    monkeypatch.setattr(hlo_stats, "record", record)
    return calls


def test_b2_data_collectives_equal_the_count_from_the_specs(monkeypatch):
    """One local step of reduced SmolLM-135M under B2 on (4, 2): the
    collectives over the data column (group size dp = 4; the column
    groups' are of mp = 2) are, from the specs, an all-gather of each
    data-cut leaf's column block a layer, a row and a column (the row's
    share), its backward's reduce-scatter of a cell's block, and an
    all-reduce of each other leaf's block a column."""
    cfg = _cfg("smollm-135m")
    mesh = make_named_mesh((4, 2), device="cpu")
    dp, mp = 4, 2
    dfed = DFedAvgMConfig(eta=1e-3, theta=0.9, local_steps=1)
    built = B.build_train_step(cfg, mesh, InputShape(*SHAPE),
                               strategy="B2", dfed=dfed)
    specs = built.specs[0][0].params
    params, batches = _inputs("smollm-135m", built)
    calls = _record_calls(monkeypatch)
    with hlo_stats.collect_collectives() as stats:
        built.fn(RoundState(params=params, rng=prng.PRNGKey(1), round=0),
                 batches)
    got = {}
    for kind, result, g, senders in calls:
        if g == dp:
            got.setdefault(kind, []).append((result, senders))
    want = {"all-gather": [], "reduce-scatter": [], "all-reduce": []}
    cut_leaves = 0
    for n, spec in specs.items():
        t = params[n]
        data_cut = any("data" in spec.names(i) for i in range(len(spec)))
        cell = t.numel() * t.element_size() // int(np.prod(
            [dp if "data" in spec.names(i) else 1 for i in range(len(spec))]
            + [mp if "model" in spec.names(i) else 1
               for i in range(len(spec))]))
        if data_cut:
            cut_leaves += 1
            layers = t.shape[1]
            assert any(("data", "model") == spec.names(i)
                       for i in range(len(spec))), (n, spec)
            for _ in range(dp * mp * layers):
                want["all-gather"].append((dp * cell // layers, 1))
                want["reduce-scatter"].append((cell // layers, 1))
        else:
            want["all-reduce"] += [(cell, None)] * mp
    assert cut_leaves == 3                       # the MLP's wg, wu, wd
    for kind in want:
        assert sorted(got.get(kind, [])) == sorted(want[kind]), kind
    wire = {"all-gather": sum(r * (dp - 1) / dp for r, _ in
                              want["all-gather"]),
            "reduce-scatter": sum(r * (dp - 1) for r, _ in
                                  want["reduce-scatter"]),
            "all-reduce": sum(dp * 2.0 * r * (dp - 1) / dp for r, _ in
                              want["all-reduce"])}
    data_wire = {k: 0.0 for k in wire}
    for (kind, result, g, senders) in calls:
        if g == dp:
            s = senders if senders is not None else g
            data_wire[kind] += s * hlo_stats._wire_bytes(kind, result, g)
    assert data_wire == wire
    assert stats.by_kind["reduce-scatter"] == wire["reduce-scatter"]


def test_b_gradient_on_a_data_cut_leaf_is_the_global_one():
    """Under B every row runs the whole batch and keeps its own slice of
    a data-cut leaf's gradient: one local step's update (theta's term is
    zero from v = 0) gives the global program's gradient on every cell's
    block, not dp times it."""
    cfg = _cfg("smollm-135m")
    mesh = make_named_mesh((4, 2), device="cpu")
    built = B.build_train_step(cfg, mesh, InputShape(*SHAPE), strategy="B")
    specs = built.specs[0][0].params
    params, batches = _inputs("smollm-135m", built)
    step0 = {n: b[:, :1] for n, b in batches.items()}
    keys = prng.split(prng.PRNGKey(5), 2)
    eta = 0.5
    cells = mesh.shard(params, specs)
    z, _ = local_sgd.local_train_rows(M.make_loss(cfg), mesh, cells, specs,
                                      step0, keys, eta=eta, theta=0.9)
    got = mesh.gather(z, specs)
    _, want = local_sgd.loss_and_grad(M.make_loss(cfg), params,
                                      {n: b[:, 0] for n, b in step0.items()},
                                      prng.split(keys, 1)[:, 0])
    name = "stages/0/mlp/wd"
    assert "data" in specs[name].names(3)        # its "embed" dim
    g = (params[name] - got[name]) / eta
    scale = float(want[name].abs().max())
    assert float((g - want[name]).abs().max()) <= 1e-4 * scale
    assert float((g - 4 * want[name]).abs().max()) > 0.5 * scale
    for n in want:
        # (y - y') / eta loses the bits of y that eta * g does not carry
        floor = 4e-7 * float(params[n].abs().max()) / eta
        err = float(((params[n] - got[n]) / eta - want[n]).abs().max())
        assert err <= 1e-4 * float(want[n].abs().max()) + floor, n


def test_row_cells_of_a_dim_cut_over_data_and_model():
    """A dim cut over ("data", "model") is cut data-major: column c's
    entry is a DataCut of the sub-blocks at positions d * mp + c, in data
    order, own set to the row's block unless the rows scatter; a dim cut
    over data alone gives each column its data column's blocks."""
    mesh = make_named_mesh((4, 2), device="cpu")
    x = torch.arange(2 * 3 * 16, dtype=torch.float32).reshape(2, 3, 16)
    y = torch.arange(2 * 8 * 6, dtype=torch.float32).reshape(2, 8, 6)
    specs = {"x": P(None, None, ("data", "model")),
             "y": P(None, "data", "model")}
    cells = mesh.shard({"x": x, "y": y}, specs)
    for row in mesh.rows():
        (d,) = row
        entries = mesh.row_cells(cells, specs, row)
        for c, e in enumerate(entries):
            cut = e["x"]
            assert cut.axis == 2 and cut.own == d
            for k, part in enumerate(cut.parts):
                assert torch.equal(part, x[:, :, (k * 2 + c) * 2:
                                           (k * 2 + c + 1) * 2])
            joined = torch.cat(cut.parts, dim=2)
            want = torch.cat([x[:, :, (k * 2 + c) * 2:(k * 2 + c + 1) * 2]
                              for k in range(4)], dim=2)
            assert torch.equal(joined, want)
            assert torch.equal(torch.cat(e["y"].parts, dim=1),
                               y[:, :, 3 * c:3 * (c + 1)])
        scat = mesh.row_cells(cells, specs, row, scatter=True)
        assert all(e["x"].own is None for e in scat)


def test_moe_rows_route_their_own_tokens(monkeypatch):
    """Reduced Mixtral on (4, 2): under B2 and B3 every MoE call routes
    one row's tokens (batch / dp x seq) as one group a client; under B
    every row routes the whole batch."""
    cfg = _cfg("mixtral-8x22b")
    mesh = make_named_mesh((4, 2), device="cpu")
    seen = []
    real = MOE.moe_grouped

    def spy(params, xg, **kw):
        seen.append(tuple(xg.shape[:2]))
        return real(params, xg, **kw)

    monkeypatch.setattr(MOE, "moe_grouped", spy)
    for s, tokens in (("B", 4 * 16), ("B2", 16), ("B3", 16)):
        built = B.build_train_step(cfg, mesh, InputShape(*SHAPE),
                                   strategy=s)
        params, batches = _inputs("mixtral-8x22b", built)
        seen.clear()
        built.fn(RoundState(params=params, rng=prng.PRNGKey(1), round=0),
                 batches)
        # 2 local steps x 4 rows x 2 layers, each client one group
        assert seen and set(seen) == {(2, tokens)}, (s, set(seen))
        assert len(seen) == 2 * 4 * cfg.n_layers


def test_refusals_and_the_global_program_of_a21c():
    """The layouts that ran the one global program (a quantized wire, the
    multi-pod mesh) and those that were refused (B2 on Mamba2, the fused
    round on one pod) now build on the mesh's own cells, and so does a
    MoE whose moe_d_ff the model axis does not divide under a cut batch
    (its rows routed as one group, ``tests/test_torch_crossing.py``);
    what stays refused: the fused round on the pod mesh (the reference's
    reason) and an MLP whose weights cut their hidden dim unalike."""
    import dataclasses
    mesh = make_named_mesh((4, 2), device="cpu")
    for cfg, s, dfed in (
            (_cfg("mamba2-780m"), "B2", None),
            (_cfg("smollm-135m"), "B", DFedAvgMConfig(
                eta=1e-3, theta=0.9, local_steps=2, fuse_round=True)),
            (_cfg("smollm-135m"), "B3", DFedAvgMConfig(
                eta=1e-3, theta=0.9, local_steps=2,
                quant=QuantConfig(bits=8)))):
        built = B.build_train_step(cfg, mesh, InputShape(*SHAPE),
                                   strategy=s, dfed=dfed)
        assert built.mesh is mesh and built.meta["mixer"] == "dense"
    pods = make_named_mesh((2, 2, 2), ("pod", "data", "model"),
                           device="meta")
    built = B.build_train_step(_cfg("mixtral-8x22b"), pods,
                               InputShape(*SHAPE))
    assert built.mesh is pods and built.meta["client_axes"] == ("pod",)
    assert built.meta["mixer"] == "ring"
    fused = DFedAvgMConfig(eta=1e-3, theta=0.9, local_steps=2,
                           fuse_round=True)
    with pytest.raises(ValueError, match="model-sharded params"):
        B.build_train_step(_cfg("smollm-135m"), pods, InputShape(*SHAPE),
                           strategy="B", dfed=fused)
    odd = dataclasses.replace(_cfg("mixtral-8x22b"), moe_d_ff=33)
    built = B.build_train_step(odd, mesh, InputShape(*SHAPE), strategy="B3")
    assert built.mesh is mesh and built.meta["mixer"] == "dense"
    axes = {"stages/0/mlp/wg": ("layers", "embed", "mlp"),
            "stages/0/mlp/wd": ("layers", "mlp", "embed")}
    unalike = {"stages/0/mlp/wg": P(None, None, None, ("data", "model")),
               "stages/0/mlp/wd": P(None, None, "model", None)}
    with pytest.raises(ValueError, match="unalike"):
        B._check_cells_layout(unalike, axes)


@pytest.mark.parametrize("arch,strategy", CASES)
def test_round_matches_the_reference(reference, arch, strategy):
    """One round on the (4, 2) CPU cells against the reference's step on
    8 host devices and the port's global program."""
    ref = reference(arch, strategy)
    cfg = _cfg(arch)
    mesh = make_named_mesh((4, 2), device="cpu")
    built = B.build_train_step(cfg, mesh, InputShape(*SHAPE),
                               strategy=strategy)
    assert built.mesh is mesh and built.fn.step.local_step == "cells"
    params = {n[3:].replace("|", "/"): torch.from_numpy(a)
              for n, a in ref.items() if n.startswith("in:")}
    batches = _batches(ref["tokens"])
    state = RoundState(params=params, rng=prng.PRNGKey(1), round=0)
    new, met = built.fn(state, batches)
    assert isinstance(new.params, Cells) and len(new.params) == 8
    got = mesh.gather(new.params, built.specs[0][0].params)
    glob, gmet = _global_round(cfg, mesh, strategy, params, batches)
    for k in ("loss", "consensus_dist", "local_drift"):
        _close(met[k], ref[f"m:{k}"], k)
        _close(gmet[k], ref[f"m:{k}"], f"global {k}")
    want = {n[4:].replace("|", "/"): a for n, a in ref.items()
            if n.startswith("out:")}
    assert sorted(want) == sorted(got)
    for n in want:
        _close(got[n], want[n], n)
        _close(glob.params[n], want[n], f"global {n}")
    _replicas_bitwise(built, new.params)
