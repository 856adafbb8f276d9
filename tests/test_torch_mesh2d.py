"""The 2D (clients, model) mesh on the CPU: the port's cells, 2D mixer,
rounds, async events, telemetry and LM driver, against the JAX package's
own 2D mixer, its dense trajectory, and the port's 1D mesh and one device.

* One subprocess runs the reference's ``make_plan_mixer`` on a (2, 4)
  mesh of 8 host devices (its ``tests/test_mesh2d.py`` tree: ``w`` and
  ``b`` cut over the 4 model columns, ``s`` replicated; both of its
  wires) in fp32, q8 ``lemma5``, q8 ``eq7`` and q8 stochastic: the
  port's mixer on ``make_test_mesh(2, model_parallel=4, device="cpu")``
  is bitwise equal.
* Port against port, bitwise: the 2D mixer against the 1D mesh and one
  device (static ring, a placed ER plan, edge-sampled and cycle
  schedules); three unfused rounds of the 2NN under the reference's hand
  specs (static ring and ``edge_sample``, fp32 and q8 stochastic, with
  telemetry: every field equal but ``wire_bits``, the per-column bill,
  exactly 1/mp); the reference's elementwise-loss round; async events
  (full width and ``ready_capacity``).
* The reference's ``test_2d_paper_net_trains_sparse_equals_dense``
  set-up: the port's 2D run within 2e-5 of the reference's dense run.
* The refusals (the fused tail with model-sharded specs; the driver's
  ``--pool``, ``--mixer-impl dense``, ``--fuse-round`` and
  ``--model-parallel 0``), the gemma-7b reduced driver run on a CPU test
  mesh of 2 shards x 4 columns (the reference's three log lines, losses
  falling; its tensor-parallel step within rtol 1e-5 of the 1D mesh run,
  its joined step with an opaque loss bitwise with it; both within 1e-5
  of one device), and the ``mesh2d_compare`` smoke's byte gates.
"""
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import core as J  # noqa: E402
from repro.models.paper_nets import apply_2nn as j_apply_2nn  # noqa: E402
from repro.models.paper_nets import init_2nn as j_init_2nn  # noqa: E402
from repro_torch import core as T  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core.async_gossip import init_async_state  # noqa: E402
from repro_torch.launch.mesh import (ClientMesh, make_client_mesh,  # noqa
                                     make_test_mesh)
from repro_torch.models.paper_nets import apply_2nn  # noqa: E402
from repro_torch.sharding import P  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
M = 8
QUANTS = {"fp32": None,
          "q8_lemma5": dict(bits=8, stochastic=False, delta_mode="lemma5"),
          "q8_eq7": dict(bits=8, stochastic=False, delta_mode="eq7"),
          "q8_stoch": dict(bits=8, stochastic=True, delta_mode="lemma5")}
# The reference's tests/test_mesh2d.py _PRELUDE tree and specs.
SHAPES = {"w": (4, 16), "b": (12,), "s": (3,)}
PS2 = {"w": P("clients", None, "model"), "b": P("clients", "model"),
       "s": P("clients", None)}
# The reference's 2NN hand specs (tests/test_mesh2d.py).
PS_2NN = {"w1": P("clients", None, "model"), "b1": P("clients", "model"),
          "w2": P("clients", "model", None), "b2": P("clients", "model"),
          "w3": P("clients", "model", None), "b3": P("clients", "model")}


def quant(name):
    q = QUANTS[name]
    return None if q is None else T.QuantConfig(**q)


def inputs(seed: int, m: int = M, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    x = {n: rng.normal(size=(m,) + s).astype(np.float32)
         for n, s in shapes.items()}
    z = {n: (v + 0.1 * rng.normal(size=v.shape)).astype(np.float32)
         for n, v in x.items()}
    return x, z


def tree(d):
    return {n: torch.from_numpy(np.ascontiguousarray(v)) for n, v in d.items()}


def equal(a, b, what=""):
    for n in a:
        assert torch.equal(a[n], b[n]), (what, n,
                                          float((a[n] - b[n]).abs().max()))


# ---------------------------------------------------------------------------
# The mesh and its cells
# ---------------------------------------------------------------------------

def test_cells_cut_and_join():
    mesh = make_test_mesh(2, model_parallel=4, device="cpu")
    assert mesh.devices.shape == (2, 4) and mesh.axis_names == (
        "clients", "model")
    assert mesh.n_shards == 2 and mesh.model_parallel == 4 and mesh.shared
    assert mesh.m_local(M) == 4
    x, _ = inputs(0)
    tx = tree(x)
    cells = mesh.shard(tx, PS2)
    assert len(cells) == 8
    # Cell (1, 2): lanes 4..8, w's last dim 8..12, b's 6..9, s whole.
    c = cells[1 * 4 + 2]
    assert torch.equal(c["w"], tx["w"][4:8, :, 8:12])
    assert torch.equal(c["b"], tx["b"][4:8, 6:9])
    assert torch.equal(c["s"], tx["s"][4:8])
    for cell in cells:
        for n, t in cell.items():
            assert t.is_contiguous()
            assert t.untyped_storage().data_ptr() != \
                tx[n].untyped_storage().data_ptr()
    back = mesh.gather(cells, PS2)
    equal(back, tx)
    rows = T.join_columns(cells, {"w": 2, "b": 1, "s": None},
                          mesh.devices)
    assert len(rows) == 2
    equal(rows[1], {n: t[4:] for n, t in tx.items()})
    recut = T.cut_columns(rows, {"w": 2, "b": 1, "s": None}, mesh.devices)
    for a, b in zip(recut, cells):
        equal(a, b)
    # No specs: every leaf whole on every column.
    whole = mesh.shard(tx)
    assert torch.equal(whole[3]["w"], tx["w"][:4])
    # The 1D mesh and its positional device stay as they were.
    one = make_test_mesh(4, "cpu")
    assert one.devices.shape == (4,) and one.model_parallel == 1
    sharded = one.shard(tx, PS2)   # specs cut nothing on a 1D mesh
    equal(sharded[1], {n: t[2:4] for n, t in tx.items()})
    with pytest.raises(ValueError, match="model_parallel"):
        make_test_mesh(2, model_parallel=0, device="cpu")
    with pytest.raises(ValueError, match="2D one"):
        ClientMesh(devices=np.empty((2, 2, 2), dtype=object),
                   axis_names=("clients", "model", "x"))


def test_client_mesh_of_cards_is_row_major():
    """``make_client_mesh`` lays n_shards x model_parallel distinct cards
    out row-major, as the reference's ``reshape``; too few warn and give
    None; a repeated card is refused (the shared-card mesh is
    ``make_test_mesh``). Device objects only: nothing is allocated."""
    cards = [torch.device("cuda", i) for i in range(4)]
    mesh = make_client_mesh(16, clients_per_shard=8, model_parallel=2,
                            devices=cards)
    assert mesh.devices.shape == (2, 2)
    assert [str(d) for d in mesh.devices.flat] == [str(c) for c in cards]
    assert not mesh.shared and mesh.m_local(16) == 8
    with pytest.warns(UserWarning, match="needs 8 devices"):
        assert make_client_mesh(16, clients_per_shard=4, model_parallel=2,
                                devices=cards) is None
    with pytest.raises(ValueError, match="distinct"):
        make_client_mesh(16, clients_per_shard=8, model_parallel=2,
                         devices=[cards[0]] * 4)
    with pytest.raises(ValueError, match="CUDA device"):
        T.capture_step(lambda st, b: (st, {}), T.init_round_state(
            tree(inputs(0)[0]), prng.PRNGKey(0),
            mesh=make_test_mesh(2, model_parallel=4, device="cpu"),
            param_specs=PS2), None)


# ---------------------------------------------------------------------------
# The mixer: against the reference's own 2D mixer, and port against port
# ---------------------------------------------------------------------------

_JAX_2D_SCRIPT = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.core import MixingSpec, QuantConfig
from repro.core.mixing import make_plan_mixer
mesh2 = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("clients", "model"))
ps2 = {"w": P("clients", None, "model"), "b": P("clients", "model"),
       "s": P("clients", None)}
d = np.load(sys.argv[1])
x = {n[2:]: jnp.asarray(d[n]) for n in d.files if n.startswith("x_")}
z = {n[2:]: jnp.asarray(d[n]) for n in d.files if n.startswith("z_")}
put = lambda t: jax.device_put(t, {k: NamedSharding(mesh2, s)
                                   for k, s in ps2.items()})
quants = {"fp32": None,
          "q8_lemma5": QuantConfig(bits=8, stochastic=False,
                                   delta_mode="lemma5"),
          "q8_eq7": QuantConfig(bits=8, stochastic=False, delta_mode="eq7"),
          "q8_stoch": QuantConfig(bits=8, stochastic=True,
                                  delta_mode="lemma5")}
plan = MixingSpec.ring(int(d["m"]), self_weight=0.5).gossip_plan()
out = {}
for wire in ("seq", "planar"):
    for name, q in quants.items():
        mix = make_plan_mixer(plan, mesh2, param_specs=ps2, quant=q,
                              wire=wire)
        o = jax.jit(mix)(put(x), put(z), jax.random.PRNGKey(int(d["seed"])))
        for n, v in o.items():
            out[f"{wire}/{name}/{n}"] = np.asarray(v)
np.savez(sys.argv[2], **out)
"""


def test_2d_mixer_bitwise_with_the_reference_2d_mixer(tmp_path):
    x, z = inputs(7)
    np.savez(tmp_path / "in.npz", m=M, seed=5,
             **{f"x_{n}": v for n, v in x.items()},
             **{f"z_{n}": v for n, v in z.items()})
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", _JAX_2D_SCRIPT,
                    str(tmp_path / "in.npz"), str(tmp_path / "out.npz")],
                   check=True, env=env, timeout=600)
    want = np.load(tmp_path / "out.npz")
    mesh = make_test_mesh(2, model_parallel=4, device="cpu")
    plan = T.MixingSpec.ring(M, 0.5).gossip_plan()
    for name in QUANTS:
        mix = T.make_plan_mixer(plan, quant(name), mesh=mesh,
                                param_specs=PS2)
        got = mesh.gather(mix(mesh.shard(tree(x), PS2),
                              mesh.shard(tree(z), PS2), prng.PRNGKey(5)),
                          PS2)
        for wire in ("seq", "planar"):
            for n in SHAPES:
                assert np.array_equal(got[n].numpy(),
                                      want[f"{wire}/{name}/{n}"]), (
                    wire, name, n)


def _mixers(kind: str, q, mesh, specs, m: int = 32):
    """(mix(x, z, key, t) -> x', lanes perm or None) of ``kind`` on
    ``mesh`` (None: one device)."""
    dev = "cpu"
    if kind == "ring":
        mx = T.make_mixer(T.MixingSpec.ring(m, 0.5), T.MixerConfig(
            impl="sparse", quant=q), device=dev, mesh=mesh,
            param_specs=specs)
        return (lambda x, z, k, t: mx(x, z, k, t)), None
    if kind == "placed_er":
        g = T.erdos_renyi_graph(m, 0.15, seed=1)
        pl = T.compute_placement(g, 4)
        if mesh is None:
            mx = T.make_mixer(T.MixingSpec.dense(g), T.MixerConfig(
                impl="sparse", quant=q), device=dev)
            return (lambda x, z, k, t: mx(x, z, k, t)), None
        mx = T.make_mixer(T.MixingSpec.dense(g), T.MixerConfig(quant=q),
                          mesh=mesh, placement=pl, param_specs=specs)
        return (lambda x, z, k, t: mx(x, z, k, t)), pl.perm
    sched = {"edge_sample": lambda: T.TopologySchedule.edge_sample(
                 T.erdos_renyi_graph(m, 0.15, seed=1), 0.6),
             "cycle": lambda: T.TopologySchedule.cycle(
                 [T.MixingSpec.ring(m, 0.5), T.MixingSpec.torus(4, m // 4)]),
             }[kind]()
    mx = T.make_mixer(sched, T.MixerConfig(impl="sparse", quant=q),
                      device=dev, mesh=mesh, param_specs=specs)
    return (lambda x, z, k, t: mx(x, z, k, t)[0]), None


@pytest.mark.parametrize("kind", ["ring", "placed_er", "edge_sample",
                                  "cycle"])
@pytest.mark.parametrize("qname", list(QUANTS))
def test_2d_mixer_bitwise_with_1d_and_one_device(kind, qname):
    """m 32 on 4 shards x 2 columns against 4 shards and one device; a
    placed plan's lanes in lane order (placed runs equal unplaced ones
    with their lanes permuted)."""
    m = 32
    q = quant(qname)
    x, z = inputs(3, m)
    specs = {"w": P("clients", None, "model"), "b": P("clients", "model"),
             "s": P("clients", None)}
    x["b"], z["b"] = (np.concatenate([v, v[:, :4]], axis=1)
                      for v in (x["b"], z["b"]))     # 16 divides by 2
    mesh1 = make_test_mesh(4, "cpu")
    mesh2 = make_test_mesh(4, model_parallel=2, device="cpu")
    key = prng.PRNGKey(11)
    one, _ = _mixers(kind, q, None, None, m)
    m1, perm = _mixers(kind, q, mesh1, None, m)
    m2, _ = _mixers(kind, q, mesh2, specs, m)
    for t in (0, 1):
        want = one(tree(x), tree(z), key, t)
        tx, tz = tree(x), tree(z)
        if perm is not None:
            tx = {n: v[perm] for n, v in tx.items()}
            tz = {n: v[perm] for n, v in tz.items()}
        got1 = mesh1.gather(m1(mesh1.shard(tx), mesh1.shard(tz), key, t))
        got2 = mesh2.gather(m2(mesh2.shard(tx, specs),
                               mesh2.shard(tz, specs), key, t), specs)
        equal(got2, got1, (kind, qname, t))
        if perm is not None:
            inv = np.argsort(perm)
            got2 = {n: v[inv] for n, v in got2.items()}
        equal(got2, want, (kind, qname, t, "one device"))


# ---------------------------------------------------------------------------
# Rounds, async events and telemetry
# ---------------------------------------------------------------------------

def _2nn(m: int = M, K: int = 2, B: int = 4):
    from repro_torch.models.paper_nets import init_2nn
    p0 = init_2nn(0, d_in=32, d_hidden=16, n_classes=8, device="cpu")
    stacked = {n: v[None].expand((m,) + tuple(v.shape)).contiguous()
               for n, v in p0.items()}
    rng = np.random.default_rng(3)
    batches = {"x": torch.tensor(rng.normal(size=(m, K, B, 32)),
                                 dtype=torch.float32),
               "y": torch.tensor(rng.integers(0, 8, size=(m, K, B)))}
    return stacked, batches


def _loss_2nn(p, b, r):
    logits = apply_2nn(p, b["x"])
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, b["y"][..., None].long())[..., 0].mean(dim=-1)


def _run_rounds(spec, cfg, mesh, specs, stacked, batches, n=3, **kw):
    step = T.make_round_step(_loss_2nn, cfg, spec, device="cpu", mesh=mesh,
                             param_specs=specs, **kw)
    st = T.init_round_state(stacked, prng.PRNGKey(11), mesh=mesh,
                            param_specs=specs)
    mets = []
    for _ in range(n):
        st, mt = step(st, batches)
        mets.append(mt)
    params = (st.params if mesh is None else mesh.gather(st.params, specs))
    return params, mets


@pytest.mark.parametrize("qname", ["fp32", "q8_stoch"])
@pytest.mark.parametrize("kind", ["ring", "edge_sample"])
def test_2d_rounds_bitwise_with_1d_and_one_device(kind, qname):
    stacked, batches = _2nn()
    spec = (T.MixingSpec.ring(M, 0.5) if kind == "ring" else
            T.TopologySchedule.edge_sample(T.ring_graph(M), 0.7))
    cfg = T.DFedAvgMConfig(eta=0.1, theta=0.9, local_steps=2,
                           quant=quant(qname), mixer_impl="sparse")
    runs = {name: _run_rounds(spec, cfg, mesh, specs, stacked, batches,
                              with_telemetry=True)
            for name, mesh, specs in (
                ("one", None, None), ("1d", make_test_mesh(2, "cpu"), None),
                ("2d", make_test_mesh(2, model_parallel=4, device="cpu"),
                 PS_2NN))}
    equal(runs["2d"][0], runs["1d"][0], "2d vs 1d")
    equal(runs["2d"][0], runs["one"][0], "2d vs one device")
    for r in range(3):
        a, b = runs["2d"][1][r], runs["1d"][1][r]
        for k in a:
            if k != "telemetry":
                assert torch.equal(a[k], b[k]), (r, k)
        ta, tb = a["telemetry"]._asdict(), b["telemetry"]._asdict()
        for f, v in tb.items():
            if v is None:
                assert ta[f] is None, f
            elif f == "wire_bits":   # the per-column bill: 1/mp
                assert torch.equal(ta[f], v / torch.full_like(v, 4.0)), f
            else:
                assert torch.equal(ta[f], v), (r, f)
    assert float(runs["2d"][1][-1]["loss"]) < float(runs["2d"][1][0]["loss"])


@pytest.mark.parametrize("qname", ["fp32", "q8_stoch"])
def test_reference_elementwise_round_bitwise_with_1d(qname):
    """The reference's ``test_2d_round_step_bitwise_equal_to_1d`` set-up:
    w [8, 4, 16] cut on its last dim, an elementwise loss, a partial ring
    schedule, 3 rounds; the port's 2D round is bitwise its 1D round (the
    reference holds its own to 1e-6) and its sampled participation the
    same."""
    c = np.random.default_rng(9).normal(size=(M, 4, 16)).astype(np.float32)
    batches = {"c": torch.from_numpy(np.broadcast_to(
        c[:, None], (M, 4, 4, 16)).copy())}
    sched = T.TopologySchedule.partial(T.ring_graph(M), 0.6)
    cfg = T.DFedAvgMConfig(eta=0.05, theta=0.5, local_steps=4,
                           quant=quant(qname), mixer_impl="sparse")

    def loss_fn(p, b, r):
        return 0.5 * ((p["w"] - b["c"]) ** 2).sum(dim=(-2, -1))

    out = {}
    for name, mesh, specs in (
            ("1d", make_test_mesh(2, "cpu"), None),
            ("2d", make_test_mesh(2, model_parallel=4, device="cpu"),
             {"w": P("clients", None, "model")})):
        step = T.make_round_step(loss_fn, cfg, sched, device="cpu",
                                 mesh=mesh, param_specs=specs)
        st = T.init_round_state({"w": torch.zeros(M, 4, 16)},
                                prng.PRNGKey(7), mesh=mesh,
                                param_specs=specs)
        for _ in range(3):
            st, mt = step(st, batches)
        out[name] = (mesh.gather(st.params, specs)["w"],
                     float(mt["active_frac"]))
    assert torch.equal(out["2d"][0], out["1d"][0])
    assert out["2d"][1] == out["1d"][1]


@pytest.mark.parametrize("cap", [None, 3])
def test_2d_async_events_bitwise_with_1d(cap):
    stacked, batches = _2nn()
    spec = T.MixingSpec.ring(M, 0.5)
    cfg = T.DFedAvgMConfig(eta=0.1, theta=0.9, local_steps=2,
                           quant=quant("q8_stoch"), mixer_impl="sparse")
    acfg = T.AsyncConfig(speed=T.SpeedModel.straggler(),
                         max_staleness=4, ready_capacity=cap)
    n_ev = 6
    ev_batches = {k: torch.stack([b] * n_ev) for k, b in batches.items()}
    out = {}
    for name, mesh, specs in (
            ("1d", make_test_mesh(2, "cpu"), None),
            ("2d", make_test_mesh(2, model_parallel=4, device="cpu"),
             PS_2NN)):
        run = T.make_async_engine(_loss_2nn, cfg, spec, acfg, device="cpu",
                                  with_telemetry=True, mesh=mesh,
                                  param_specs=specs)
        st = init_async_state(stacked, prng.PRNGKey(4), acfg.speed,
                              mesh=mesh, param_specs=specs)
        st, met = run(st, ev_batches)
        out[name] = (mesh.gather(st.params, specs), met, st)
    equal(out["2d"][0], out["1d"][0], "async")
    assert torch.equal(out["2d"][2].version, out["1d"][2].version)
    for k, v in out["1d"][1].items():
        if k == "telemetry":
            ta = out["2d"][1][k]._asdict()
            for f, tv in v._asdict().items():
                if tv is None:
                    continue
                want = tv / torch.full_like(tv, 4.0) \
                    if f == "wire_bits" else tv
                assert torch.equal(ta[f], want), f
        else:
            assert torch.equal(out["2d"][1][k], v), k


def test_2d_paper_net_tracks_the_reference_dense_trajectory():
    """The reference's ``test_2d_paper_net_trains_sparse_equals_dense``:
    the 2NN (32-16-8) on an edge-sampled ring of 8, K 2, 3 rounds; the
    reference's dense mixer on one device against the port on the (2, 4)
    mesh under the hand specs: every leaf within 2e-5, the loss falling.
    """
    Mr, B, K = 8, 4, 2
    p0 = j_init_2nn(jax.random.PRNGKey(0), d_in=32, d_hidden=16,
                    n_classes=8)
    stacked = jax.tree.map(
        lambda t: jnp.broadcast_to(t[None], (Mr,) + t.shape), p0)
    kx, ky = jax.random.split(jax.random.PRNGKey(3))
    jb = {"x": jax.random.normal(kx, (Mr, K, B, 32)),
          "y": jax.random.randint(ky, (Mr, K, B), 0, 8)}

    def j_loss(p, b, r):
        logp = jax.nn.log_softmax(j_apply_2nn(p, b["x"]))
        return -jnp.mean(jnp.take_along_axis(logp, b["y"][:, None],
                                             axis=-1))

    jsched = J.TopologySchedule.edge_sample(J.ring_graph(Mr), p_edge=0.7)
    jcfg = J.DFedAvgMConfig(eta=0.1, theta=0.9, local_steps=K,
                            mixer_impl="dense")
    jstep = jax.jit(J.make_round_step(j_loss, jcfg, jsched))
    st = J.init_round_state(stacked, jax.random.PRNGKey(11))
    for _ in range(3):
        st, _ = jstep(st, jb)
    want = {n: np.asarray(v) for n, v in st.params.items()}

    tsched = T.TopologySchedule.edge_sample(T.ring_graph(Mr), p_edge=0.7)
    cfg = T.DFedAvgMConfig(eta=0.1, theta=0.9, local_steps=K,
                           mixer_impl="sparse")
    tb = {"x": torch.from_numpy(np.array(jb["x"])),
          "y": torch.from_numpy(np.asarray(jb["y"]).astype(np.int64))}
    ts = {n: torch.from_numpy(np.asarray(v).copy())
          for n, v in stacked.items()}
    mesh = make_test_mesh(2, model_parallel=4, device="cpu")
    got, mets = _run_rounds(tsched, cfg, mesh, PS_2NN, ts, tb)
    for n in want:
        err = float(np.abs(got[n].numpy() - want[n]).max())
        assert err < 2e-5, (n, err)
    assert float(mets[-1]["loss"]) < float(mets[0]["loss"])


# ---------------------------------------------------------------------------
# Refusals, the driver, the wire bytes
# ---------------------------------------------------------------------------

def test_fused_tail_refuses_model_sharded_specs():
    mesh = make_test_mesh(2, model_parallel=4, device="cpu")
    sched = T.TopologySchedule.constant(T.MixingSpec.ring(M, 0.5))
    cfg = T.DFedAvgMConfig(eta=0.05, theta=0.5, local_steps=4,
                           mixer_impl="sparse", fuse_round=True)

    def loss_fn(p, b, r):
        return 0.5 * ((p["w"] - b["c"]) ** 2).sum(dim=(-2, -1))

    with pytest.raises(ValueError, match="model-sharded"):
        T.make_round_step(loss_fn, cfg, sched, device="cpu", mesh=mesh,
                          param_specs={"w": P("clients", None, "model")})
    with pytest.raises(ValueError, match="model-sharded"):
        T.make_fused_tail(loss_fn, M, eta=0.05, theta=0.5,
                          plan=sched.gossip_plan(), mesh=mesh,
                          param_specs={"w": P("clients", None, "model")})
    # Specs that cut no leaf: every column holds the whole model and runs
    # the 1D fused tail (test_fused_2d_mesh_without_a_cut_is_the_1d_round).
    tail = T.make_fused_tail(loss_fn, M, eta=0.05, theta=0.5,
                             plan=sched.gossip_plan(), mesh=mesh)
    assert tail.tables.mp == 4 and len(tail.tables.src) == 8


@pytest.mark.parametrize("kind, qname, specs", [
    ("ring", "q8_stoch", None), ("ring", "fp32", None),
    ("edge_sample", "q8_stoch", {"w1": P("clients", None, None)}),
    ("cycle", "q8_stoch", None)],
    ids=["ring-q8", "ring-fp32", "edge_sample-q8-replicated-spec",
         "cycle-q8-dense-tail"])
def test_fused_2d_mesh_without_a_cut_is_the_1d_round(kind, qname, specs):
    """Three fused rounds on a (2, 4) mesh whose specs cut no leaf (none,
    or replicated only) are bitwise the 1D mesh's fused rounds, which
    ``tests/test_torch_mesh.py`` holds against the reference; every
    column's cells hold the same values, and the metrics are the 1D
    mesh's. A cycle takes the dense tail (column 0's lanes gathered)."""
    stacked, batches = _2nn()
    spec = {"ring": T.MixingSpec.ring(M, 0.5),
            "edge_sample": T.TopologySchedule.edge_sample(T.ring_graph(M),
                                                          0.7),
            "cycle": T.TopologySchedule.cycle([T.MixingSpec.ring(M, 0.5),
                                               T.MixingSpec.ring(M, 1 / 3)])
            }[kind]
    cfg = T.DFedAvgMConfig(eta=0.1, theta=0.9, local_steps=2,
                           quant=quant(qname), mixer_impl="sparse",
                           fuse_round=True)
    mesh2 = make_test_mesh(2, model_parallel=4, device="cpu")
    step = T.make_round_step(_loss_2nn, cfg, spec, device="cpu", mesh=mesh2,
                             param_specs=specs)
    st = T.init_round_state(stacked, prng.PRNGKey(11), mesh=mesh2,
                            param_specs=specs)
    mets = []
    for _ in range(3):
        st, mt = step(st, batches)
        mets.append(mt)
    want, want_mets = _run_rounds(spec, cfg, make_test_mesh(2, "cpu"), None,
                                  stacked, batches)
    assert len(st.params) == 8
    for s in range(2):
        for c in range(4):
            equal(st.params[s * 4 + c], st.params[s * 4], f"cell {s},{c}")
    equal(mesh2.gather(st.params, specs), want, "2d fused vs 1d fused")
    for a, b in zip(mets, want_mets):
        for k in b:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("extra, match", [
    (["--pool"], "--pool"), (["--mixer-impl", "dense"], "sparse backend"),
    (["--fuse-round"], "--fuse-round")],
    ids=["pool", "dense", "fuse-round"])
def test_driver_refuses_what_the_reference_refuses(extra, match):
    from repro_torch.launch import train as TT
    argv = ["--clients", "4", "--rounds", "1", "--local-steps", "2",
            "--batch", "2", "--seq", "16", "--device", "cpu",
            "--model-parallel", "2"]
    with pytest.raises(SystemExit, match=match):
        TT.main(argv + extra)
    with pytest.raises(SystemExit, match=">= 1"):
        TT.main(argv[:-1] + ["0"])


def _driver_gemma_runs(capsys):
    """gemma-7b reduced through ``run_resident`` on a (2, 4) CPU test
    mesh, the 1D mesh of its 2 shards and one device: the runs, the 2D
    run's console and the 2D specs."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import train as TT
    from repro_torch.telemetry import RunLog, Tracer
    argv = ["--arch", "gemma-7b", "--clients", "2", "--rounds", "3",
            "--bits", "8", "--local-steps", "2", "--batch", "2", "--seq",
            "16", "--device", "cpu"]
    cfg = dataclasses.replace(reduced(get_config("gemma-7b")), remat=False)
    runs = {}
    for name, extra, mesh in (
            ("2d", ["--model-parallel", "4"],
             make_test_mesh(2, model_parallel=4, device="cpu")),
            ("1d", [], make_test_mesh(2, "cpu")), ("one", [], None)):
        args = TT.build_parser().parse_args(argv + extra)
        log = RunLog(jsonl=None)
        st, met = TT.run_resident(args, cfg, log, Tracer(False), mesh=mesh)
        log.close()
        runs[name] = (st, met)
        if name == "2d":
            out = capsys.readouterr().out
    mesh2 = make_test_mesh(2, model_parallel=4, device="cpu")
    from repro_torch.models.model import model_axes
    from repro_torch.sharding import RULES_A, specs_for_tree
    specs = specs_for_tree(
        model_axes(cfg), {n: torch.empty((2,) + tuple(t.shape[1:]),
                                         device="meta")
                          for n, t in runs["1d"][0].params[0].items()},
        RULES_A, mesh2, leading_client=("clients",))
    return runs, out, mesh2, specs


def test_driver_gemma_reduced_on_a_2d_cpu_mesh(capsys):
    """The reference's ``test_2d_train_driver_production_config``:
    gemma-7b reduced, ``--clients 2 --model-parallel 4 --rounds 3 --bits
    8``, here through ``run_resident`` on a CPU test mesh of 2 shards x 4
    columns: the three log lines and the tensor-parallel local step (gemma
    is dense), losses finite and falling, loss, consensus and parameters
    within rtol 1e-5 of the 1D mesh run (the row- and column-parallel
    sums change float order) and loss and consensus of the one-device
    run."""
    runs, out, mesh2, specs = _driver_gemma_runs(capsys)
    assert "2D mesh: model_parallel=4" in out
    assert "8/11 param leaves model-sharded" in out
    assert "4.0x reduction" in out
    assert "local step: tensor_parallel" in out
    losses = [float(ln.split("loss=")[1].split()[0])
              for ln in out.splitlines() if "loss=" in ln]
    assert len(losses) == 3 and all(math.isfinite(v) for v in losses)
    assert losses[-1] < losses[0]
    for k in ("loss", "consensus_dist"):
        assert float(runs["2d"][1][k]) == pytest.approx(
            float(runs["1d"][1][k]), rel=1e-5), k
        assert float(runs["2d"][1][k]) == pytest.approx(
            float(runs["one"][1][k]), rel=1e-5)
    # The parameters within rtol 1e-5 of the 1D run's in each leaf's L2
    # norm. Elementwise, a float-order difference of a few ulp flips a
    # few stochastic-rounding decisions of the 8-bit wire; a flip moves
    # a value by one quantizer level, at most the leaf's largest
    # magnitude over qmax (127).
    got = mesh2.gather(runs["2d"][0].params, specs)
    want = make_test_mesh(2, "cpu").gather(runs["1d"][0].params)
    for n in want:
        err = got[n] - want[n]
        assert float(err.norm()) <= 1e-5 * float(want[n].norm()), n
        assert float(err.abs().max()) <= float(want[n].abs().max()) / 127, n


def test_driver_gemma_reduced_joined_step_bitwise_with_1d(capsys,
                                                          monkeypatch):
    """The same driver run with an opaque loss (no column-parallel
    form): the 2D run takes the joined local step and its losses,
    consensus and parameters are bitwise the 1D mesh run's."""
    from repro_torch.launch import train as TT
    from repro_torch.models import model as TM
    monkeypatch.setattr(TT, "_model_loss", lambda cfg: (
        lambda p, b, r: TM.loss_fn(p, cfg, b, r)))
    runs, out, mesh2, specs = _driver_gemma_runs(capsys)
    assert "local step: joined" in out
    for k in ("loss", "consensus_dist"):
        assert torch.equal(runs["2d"][1][k], runs["1d"][1][k]), k
        assert float(runs["2d"][1][k]) == pytest.approx(
            float(runs["one"][1][k]), rel=1e-5)
    equal(mesh2.gather(runs["2d"][0].params, specs),
          make_test_mesh(2, "cpu").gather(runs["1d"][0].params), "driver")


@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("qname", ["fp32", "q8_lemma5"])
def test_placed_2d_bill_equals_the_reference(mp, qname):
    """``plan_round_bits(..., model_parallel=)``: a device column's bill of
    the placed block realization of ER(32) over 4 shards, with and
    without the lemma5 replicas, equal to the reference's."""
    from repro.core import comm_cost as jcc
    from repro_torch.core import comm_cost as tcc
    g, jg = (L.erdos_renyi_graph(32, 0.15, seed=1) for L in (T, J))
    pl, jpl = T.compute_placement(g, 4), J.compute_placement(jg, 4)
    assert np.array_equal(pl.perm, jpl.perm)
    q = quant(qname)
    jq = None if q is None else J.QuantConfig(**QUANTS[qname])
    for replicas in (False, True):
        got = tcc.plan_round_bits(T.MixingSpec.dense(g).gossip_plan(), 4096,
                                  q, replicas, clients_per_shard=8,
                                  placement=pl, model_parallel=mp)
        want = jcc.plan_round_bits(J.MixingSpec.dense(jg).gossip_plan(),
                                   4096, jq, replicas, clients_per_shard=8,
                                   placement=jpl, model_parallel=mp)
        assert got == want, (replicas, got, want)


def test_mesh2d_compare_smoke_gates():
    from repro_torch.bench.timevarying import mesh2d_compare
    res = mesh2d_compare(smoke=True, device="cpu")
    assert res["wire_ratio_1d_over_2d_b32"] == 4.0
    assert res["wire_ratio_1d_over_2d_b8"] >= 3.0
    assert res["mesh2d_b32"]["payload_bytes_per_device"] * 4 == \
        res["mesh1d_b32"]["payload_bytes_per_device"]
    assert res["mesh2d_b8"]["billed_bits_per_device_column"] * 4 == \
        res["mesh1d_b8"]["billed_bits_per_device_column"]
