"""The port's telemetry (``repro_torch.telemetry``, the ``with_telemetry``
steps, the pooled runners' telemetry and tracer, ``timeit_best``'s
tracer, ``check_schema`` and ``launch.report``) on the CPU.

First a counterpart of each test of the reference's
``tests/test_telemetry.py``, port against port: the schema, the run log,
the tracer, the off path bitwise, consensus equal to the metrics, wire
bits on a static ring, the quantizer replay exact and sampled, the lane
weight, the async histogram and bound, the pooled fields, the host
conversion and ``timeit_best``. Then the same numpy inputs through the
reference's functions and the port's: ``quant_round_telemetry`` within
rtol 1e-6 with the saturated count exact; ``staleness_histogram``,
``dropped_edge_count``, ``live_edge_count`` and ``wire_bits_for`` exact;
an unfused, a scheduled (edge sampling), a fused and an async step
(the reference jitted, its dense mixer, from the same initial
parameters) and both pooled runners: fields within rtol 1e-5, the
quantizer's within 1e-4, counts exact.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import core as J  # noqa: E402
from repro.data import FederatedDataset as JFed  # noqa: E402
from repro.data import classification_dataset as j_dataset  # noqa: E402
from repro.models import paper_nets as jnets  # noqa: E402
from repro.telemetry import metrics as jtm  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch import core as T  # noqa: E402
from repro_torch.core.mixing import _quant_leaf_keys  # noqa: E402
from repro_torch.core.quantize import (dequantize_int, message_bits,  # noqa: E402,E501
                                       quantize_int)
from repro_torch.data import FederatedDataset, classification_dataset  # noqa: E402,E501
from repro_torch.models import paper_nets as tnets  # noqa: E402
from repro_torch.telemetry import (QUANT_SAMPLE_LANES, SCHEMA_VERSION,  # noqa: E402,E501
                                   RunLog, Telemetry, Tracer,
                                   dropped_edge_count, live_edge_count,
                                   quant_round_telemetry,
                                   staleness_histogram, telemetry_host,
                                   validate_record, wire_bits_for)
from repro_torch.telemetry.schema import require_valid  # noqa: E402

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

M, D = 8, 12
RTOL = 1e-5                  # consensus, drift against the reference
QRTOL = 1e-4                 # the quantizer's fields in a step
FIELDS = ("consensus_dist", "local_drift", "quant_err_sq", "quant_bound",
          "quant_sat_frac")
COUNTS = ("live_edges", "wire_bits", "dropped_edges", "cohort_size")


def quad_problem(seed=1):
    """The reference tests' quadratic: client targets drawn by
    ``jax.random.normal`` (handed over as numpy), K = 4 steps on them."""
    cs = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (M, D)))

    def loss_fn(p, batch, rng):
        return 0.5 * ((p["w"] - batch["c"]) ** 2).sum(-1)

    batches = {"c": torch.from_numpy(np.ascontiguousarray(
        np.broadcast_to(cs[:, None], (M, 4, D))))}
    return cs, loss_fn, batches


def _params_equal(a, b):
    return all(torch.equal(a[n], b[n]) for n in a)


def _run_pair(cfg, spec, rounds=20, token=None, key=2):
    """The same trajectory with telemetry off and on; returns both
    (state, metrics) pairs."""
    _, loss_fn, batches = quad_problem()
    out = []
    for wt in (False, True):
        step = T.make_round_step(loss_fn, cfg, spec, device="cpu",
                                 with_telemetry=wt)
        st = T.init_round_state({"w": torch.zeros(M, D)}, prng.PRNGKey(key),
                                token=token)
        for _ in range(rounds):
            st, mt = step(st, batches)
        out.append((st, mt))
    return out


# -- schema ---------------------------------------------------------------

def test_schema_valid_round_record():
    rec = {"kind": "round", "t": 3, "loss": 0.5, "wall_s": 1.25,
           "consensus_dist": 0.1, "staleness_hist": [1, 2]}
    assert validate_record(rec) == []
    require_valid(rec)  # must not raise


def test_schema_rejects_malformed():
    assert validate_record({"kind": "nope"})          # unknown kind
    assert validate_record({"kind": "round", "t": 0})  # missing required
    assert validate_record({"kind": "round", "t": 0, "loss": 0.1,
                            "wall_s": 0.0, "typo_metric": 1.0})
    assert validate_record({"kind": "round", "t": "0", "loss": 0.1,
                            "wall_s": 0.0})            # wrong type
    assert validate_record({"kind": "round", "t": True, "loss": 0.1,
                            "wall_s": 0.0})            # bool is not int
    with pytest.raises(ValueError):
        require_valid({"kind": "info"})


def test_schema_is_the_references_field_for_field():
    from repro.telemetry import schema as jschema
    from repro_torch.telemetry import schema as tschema
    assert tschema.SCHEMA_VERSION == jschema.SCHEMA_VERSION
    assert tschema.RECORD_FIELDS == jschema.RECORD_FIELDS
    assert [list(v) for v in tschema.RECORD_FIELDS.values()] == \
        [list(v) for v in jschema.RECORD_FIELDS.values()]


# -- sink -----------------------------------------------------------------

def test_runlog_jsonl_roundtrip(tmp_path):
    path = tmp_path / "run.jsonl"
    log = RunLog(jsonl=str(path))
    log.start(config={"rounds": 2})
    log.info("topology: ring(8)")
    log.round(0, 1.5, consensus_dist=0.2, quant_err_sq=None)  # None dropped
    log.round(1, 1.2, console=False)
    log.end(2, final_loss=1.2)
    log.close()

    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["kind"] for r in recs] == \
        ["run_start", "info", "round", "round", "run_end"]
    assert recs[0]["schema"] == SCHEMA_VERSION
    assert "quant_err_sq" not in recs[2]
    for r in recs:
        assert validate_record(r) == [], r
    assert all("wall_s" in r for r in recs if r["kind"] == "round")


def test_runlog_rejects_unknown_field(tmp_path):
    log = RunLog(jsonl=str(tmp_path / "bad.jsonl"))
    log.start(config={})
    with pytest.raises(ValueError):
        log.round(0, 1.0, not_a_metric=3.0)
    log.close()


def test_console_lines_are_the_references(capsys):
    """The same records render the same console lines in both packages."""
    from repro.telemetry import RunLog as JRunLog
    rec = dict(consensus_dist=0.25, clock=3.5, ready_frac=0.125,
               quant_err_sq=1e-6, quant_bound=2e-6, pool_materialized=7,
               pool_mbytes=1.5, comm_bits=8 * 2 ** 20)
    lines = []
    for L in (RunLog, JRunLog):
        log = L(console=True)
        log.info("hello")
        log.round(4, 0.5, **rec)
        log.end(5, comm_bits=16 * 2 ** 20)
        lines.append([ln.rsplit("(", 1)[0]
                      for ln in capsys.readouterr().out.splitlines()])
    assert lines[0] == lines[1]


# -- tracer ---------------------------------------------------------------

def test_tracer_chrome_events(tmp_path):
    tr = Tracer(enabled=True)
    with tr.span("round/step", t=0):
        pass
    with tr.span("round/step", t=1):
        pass
    with tr.span("round/d2h"):
        pass
    trace = tr.to_chrome_trace()
    xs = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    ms = [e for e in trace["traceEvents"] if e["ph"] == "M"]
    assert len(xs) == 3 and ms, "complete events + thread metadata"
    for e in xs:
        assert e["dur"] >= 0 and e["ts"] >= 0
    assert xs[0]["args"] == {"t": 0}
    d = tr.durations()
    assert set(d) == {"round/step", "round/d2h"}
    tr.instant("marker", t=2)
    assert [e for e in tr.events if e["ph"] == "i"][0]["args"] == {"t": 2}
    p = tmp_path / "trace.json"
    tr.save(p)
    assert json.loads(p.read_text())["traceEvents"]


def test_tracer_disabled_is_silent():
    tr = Tracer(enabled=False)
    with tr.span("round/step"):
        pass
    tr.instant("marker")
    assert tr.events == []


def test_spans_and_stage_labels_reach_the_profiler():
    """A span is a ``torch.profiler`` range of its name, and a round's
    stages carry the reference's scope names."""
    from torch.profiler import ProfilerActivity, profile
    _, loss_fn, batches = quad_problem()
    cfg = T.DFedAvgMConfig(eta=0.05, theta=0.5, local_steps=2,
                           quant=T.QuantConfig(bits=8))
    step = T.make_round_step(loss_fn, cfg, T.MixingSpec.ring(M),
                             device="cpu", with_telemetry=True)
    st = T.init_round_state({"w": torch.zeros(M, D)}, prng.PRNGKey(2))
    tr = Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("pool/step"):
            step(st, batches)
    names = {e.name for e in prof.events()}
    for label in ("pool/step", "round/local_sgd", "round/mix",
                  "round/telemetry", "wire/encode", "wire/decode"):
        assert label in names, label


# -- off-path bitwise guarantee -------------------------------------------

@pytest.mark.parametrize("quant", [None, dict(bits=8)], ids=["fp32", "q8"])
def test_with_telemetry_off_path_bitwise_static(quant):
    cfg = T.DFedAvgMConfig(eta=0.05, theta=0.5, local_steps=4,
                           quant=None if quant is None
                           else T.QuantConfig(**quant))
    (st_off, mt_off), (st_on, mt_on) = _run_pair(cfg, T.MixingSpec.ring(M))
    assert _params_equal(st_off.params, st_on.params)
    assert torch.equal(st_off.rng, st_on.rng)
    assert "telemetry" not in mt_off
    assert isinstance(mt_on["telemetry"], Telemetry)
    for k in mt_off:
        assert torch.equal(mt_off[k], mt_on[k]), k


@pytest.mark.parametrize("kind", ["edge_sample", "partial", "exact", "walk",
                                  "cycle", "fused"])
def test_with_telemetry_off_path_bitwise_scheduled(kind):
    """Every way a schedule's round draws its event (sampled edges,
    i.i.d. participation, an exact cohort trained by compute-skip, the
    stateful walk, a cycle on its plans) and the fused round: the same
    parameters with telemetry on, and the replay's error under its
    bound."""
    ring = T.ring_graph(M)
    spec = {"edge_sample": lambda: T.TopologySchedule.edge_sample(ring, 0.5),
            "partial": lambda: T.TopologySchedule.partial(ring, 0.6),
            "exact": lambda: T.TopologySchedule.partial(ring, 0.5,
                                                        exact=True),
            "walk": lambda: T.TopologySchedule.random_walk(ring,
                                                           stateful=True),
            "cycle": lambda: T.TopologySchedule.cycle(
                [T.MixingSpec.ring(M), T.MixingSpec.torus(2, 4)]),
            "fused": lambda: T.TopologySchedule.edge_sample(ring, 0.5),
            }[kind]()
    cfg = T.DFedAvgMConfig(eta=0.05, theta=0.5, local_steps=2,
                           quant=T.QuantConfig(bits=8),
                           fuse_round=kind == "fused")
    token = spec.init_token() if spec.is_stateful else None
    (st_off, mt_off), (st_on, mt_on) = _run_pair(cfg, spec, rounds=6,
                                                 token=token)
    assert _params_equal(st_off.params, st_on.params)
    tel = mt_on["telemetry"]
    if kind == "fused":
        assert tel.quant_err_sq is None and tel.quant_bound is None
    else:
        assert float(tel.quant_err_sq) <= float(tel.quant_bound) + 1e-12
    assert tel.placement_boundary_lanes is None


# -- metric parity --------------------------------------------------------

@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
def test_telemetry_consensus_matches_metrics(fuse):
    cfg = T.DFedAvgMConfig(eta=0.05, theta=0.5, local_steps=4,
                           fuse_round=fuse)
    _, (st, mt) = _run_pair(cfg, T.MixingSpec.ring(M), rounds=5)
    tel = mt["telemetry"]
    assert torch.equal(tel.consensus_dist, mt["consensus_dist"])
    assert torch.equal(tel.local_drift, mt["local_drift"])


def test_telemetry_wire_bits_static_ring():
    """Static ring: every directed edge fires every round, so the
    realized wire equals the deterministic per-round bill."""
    q = T.QuantConfig(bits=8)
    cfg = T.DFedAvgMConfig(eta=0.05, theta=0.5, local_steps=2, quant=q)
    _, (st, mt) = _run_pair(cfg, T.MixingSpec.ring(M), rounds=3)
    tel = mt["telemetry"]
    edges = T.ring_graph(M).num_directed_edges()
    assert float(tel.live_edges) == float(edges)
    assert float(tel.wire_bits) == float(message_bits(D, q) * edges)
    assert float(tel.wire_bits) == T.round_comm_bits(T.MixingSpec.ring(M), D,
                                                     q)


def _xz(seed, shapes=(("b", (M, 5)), ("w", (M, 3, 4)))):
    rng = np.random.default_rng(seed)
    x = {n: rng.normal(size=s).astype(np.float32) for n, s in shapes}
    z = {n: (v + 0.01 * rng.normal(size=v.shape)).astype(np.float32)
         for n, v in x.items()}
    return x, z


def _t(tree):
    return {n: torch.from_numpy(v.copy()) for n, v in tree.items()}


def test_quant_replay_exact_and_sampled():
    """Full replay reproduces the per-lane codec exactly; a strided lane
    sample is the mean of those exact per-lane values over lanes
    ``range(0, m, m // s)``."""
    q = T.QuantConfig(bits=8)
    x, z = (_t(a) for a in _xz(3, (("w", (M, D)),)))
    kq = prng.PRNGKey(3)
    leaf_keys = _quant_leaf_keys(kq, 1, M)
    err_lane, bound_lane = [], []
    for i in range(M):
        drow = (z["w"][i] - x["w"][i]).to(torch.float32)
        code, s = quantize_int(drow, q, leaf_keys[0][i])
        err_lane.append(float(((dequantize_int(code, s) - drow) ** 2).sum()))
        bound_lane.append(D / 4.0 * float(s) ** 2)

    qe, qb, qs = quant_round_telemetry(x, z, q, kq)
    np.testing.assert_allclose(float(qe), np.mean(err_lane), rtol=1e-6)
    np.testing.assert_allclose(float(qb), np.mean(bound_lane), rtol=1e-6)
    assert float(qe) <= float(qb)

    s_lanes = 2
    ids = list(range(0, M, M // s_lanes))[:s_lanes]
    qe_s, qb_s, _ = quant_round_telemetry(x, z, q, kq, sample_lanes=s_lanes)
    np.testing.assert_allclose(
        float(qe_s), np.mean([err_lane[i] for i in ids]), rtol=1e-6)
    np.testing.assert_allclose(
        float(qb_s), np.mean([bound_lane[i] for i in ids]), rtol=1e-6)


def test_quant_replay_lane_weight_excludes_gated():
    """A gated (zero-delta) lane trips the codec's s=1 zero-amax guard;
    lane_weight must keep it out of the averages."""
    q = T.QuantConfig(bits=8)
    key = prng.PRNGKey(4)
    x = {"w": torch.from_numpy(np.random.default_rng(4).normal(
        size=(M, D)).astype(np.float32))}
    zw = {"w": x["w"].clone()}
    zw["w"][0] += 0.01
    active = torch.zeros(M)
    active[0] = 1.0
    _, qb_all, _ = quant_round_telemetry(x, zw, q, key)
    _, qb_act, _ = quant_round_telemetry(x, zw, q, key, lane_weight=active)
    # 7 zero-delta lanes each contribute D/4 * 1.0 to the unweighted mean
    assert float(qb_all) > 0.1
    assert float(qb_act) < 1e-4


# -- async path -----------------------------------------------------------

def _async_setup(L, max_staleness=4):
    speed = L.SpeedModel.straggler(mean=1.0, sigma=0.5, frac=1.0 / M,
                                   factor=10.0)
    acfg = L.AsyncConfig(speed=speed, max_staleness=max_staleness)
    sched = L.TopologySchedule.edge_sample(L.ring_graph(M), p_edge=0.5)
    cfg = L.DFedAvgMConfig(eta=0.05, theta=0.5, local_steps=2,
                           quant=L.QuantConfig(bits=8))
    return speed, acfg, sched, cfg


def test_async_telemetry_histogram_and_bound():
    _, loss_fn, batches = quad_problem()
    speed, acfg, sched, cfg = _async_setup(T)
    evs = {k: b[None].expand((M,) + b.shape) for k, b in batches.items()}
    params = {}
    for wt in (False, True):
        eng = T.make_async_engine(loss_fn, cfg, sched, acfg, device="cpu",
                                  with_telemetry=wt)
        ast = T.init_async_state({"w": torch.zeros(M, D)}, prng.PRNGKey(5),
                                 speed)
        for _ in range(2):
            ast, amt = eng(ast, evs)
        params[wt] = ast.params
    assert _params_equal(params[False], params[True])
    tel = amt["telemetry"]
    assert tel.cohort_size is None                     # None stays None
    hist = tel.staleness_hist.numpy()                  # [events, buckets]
    assert hist.shape == (M, acfg.max_staleness + 2)
    assert (hist.sum(axis=1) == M).all()
    assert (tel.quant_err_sq <= tel.quant_bound + 1e-12).all()
    assert (tel.dropped_edges >= 0).all()


def test_engine_stacks_telemetry_as_the_event_loop():
    """The engine's stacked Telemetry equals the event loop's, event by
    event, field by field."""
    _, loss_fn, batches = quad_problem()
    speed, acfg, sched, cfg = _async_setup(T, max_staleness=1)
    step = T.make_async_round_step(loss_fn, cfg, sched, acfg, device="cpu",
                                   with_telemetry=True)
    st = T.init_async_state({"w": torch.zeros(M, D)}, prng.PRNGKey(6), speed)
    s0, loop = st, []
    for _ in range(5):
        st, mt = step(st, batches)
        loop.append(mt["telemetry"])
    eng = T.make_async_engine(loss_fn, cfg, sched, acfg, device="cpu",
                              with_telemetry=True)
    _, em = eng(s0, {k: b[None].expand((5,) + b.shape)
                     for k, b in batches.items()})
    for name, f in zip(Telemetry._fields, em["telemetry"]):
        if loop[0]._asdict()[name] is None:
            assert f is None, name
        else:
            assert torch.equal(f, torch.stack([getattr(t, name)
                                               for t in loop])), name


# -- pooled path ----------------------------------------------------------

POOL_M, POOL_K = 32, 8
TEMPLATE = {"w": torch.zeros(6, 4), "b": torch.zeros(4)}


def pool_loss(p, b, r):
    return ((b["x"] @ p["w"] + p["b"][:, None] - b["y"]) ** 2).mean((-2, -1))


def pool_batches(ids, t):
    keys = prng.fold_in(prng.fold_in(prng.PRNGKey(5), ids), t)
    return {"x": prng.normal(keys, (2, 4, 6)),
            "y": prng.normal(prng.fold_in(keys, 1), (2, 4, 4))}


def test_pooled_telemetry_fields_and_bitwise():
    cfg = T.DFedAvgMConfig(eta=0.05, theta=0.5, local_steps=2,
                           quant=T.QuantConfig(bits=8))
    stores = {}
    for wt in (False, True):
        runner = T.PooledRunner(
            T.ClientPool(TEMPLATE, POOL_M),
            T.PoolSchedule.ring_partial(POOL_M, POOL_K / POOL_M), pool_loss,
            cfg, pool_batches, key=prng.PRNGKey(1), telemetry=wt,
            device="cpu")
        for _ in range(3):
            mt = runner.round()
        runner.close()
        stores[wt] = runner.pool.fetch(np.arange(POOL_M))
    assert _params_equal(stores[False], stores[True])
    assert mt["cohort_size"] == POOL_K
    assert mt["quant_err_sq"] <= mt["quant_bound"] + 1e-12
    assert mt["pool_hit"] + mt["pool_miss"] == POOL_K
    # A scattered cohort may draw no adjacent ring pair, so live_edges can
    # be 0 — the invariant is the realized-bill relation.
    d_client = sum(t.numel() for t in TEMPLATE.values())
    assert mt["wire_bits"] == message_bits(d_client, cfg.quant) * \
        mt["live_edges"]


# -- host conversion ------------------------------------------------------

def test_telemetry_host_drops_none_and_converts():
    tel = Telemetry(consensus_dist=torch.tensor(0.25),
                    staleness_hist=torch.tensor([3, 4, 1], dtype=torch.int32))
    out = telemetry_host(tel)
    assert out == {"consensus_dist": 0.25, "staleness_hist": [3, 4, 1]}
    assert isinstance(out["consensus_dist"], float)
    assert all(isinstance(c, int) for c in out["staleness_hist"])
    assert telemetry_host(Telemetry()) == {}


def test_capture_clones_telemetry_field_by_field():
    """A captured round returns a fresh Telemetry every replay (the clone
    ``capture_step``'s run applies to each metric)."""
    from repro_torch.core.compiled import _clone
    tel = Telemetry(consensus_dist=torch.tensor(0.5),
                    staleness_hist=torch.tensor([1, 2]))
    got = _clone(tel)
    assert isinstance(got, Telemetry) and got.local_drift is None
    assert got.consensus_dist.data_ptr() != tel.consensus_dist.data_ptr()
    assert torch.equal(got.staleness_hist, tel.staleness_hist)


# -- benchmark timing primitive -------------------------------------------

def test_timeit_best_call_index_and_carry():
    from repro_torch.bench.common import timeit_best

    seen = []

    def body(i, carry):
        seen.append(i)
        return carry + i

    tr = Tracer()
    best, carry = timeit_best(body, 0, iters=2, reps=3, warmup=2,
                              device="cpu", tracer=tr, label="arm")
    assert seen == list(range(8)), "global call index stays monotone"
    assert carry == sum(range(8)), "carry threads through warmup + reps"
    assert best >= 0.0
    spans = [e for e in tr.events if e["ph"] == "X"]
    assert [e["args"] for e in spans] == [{"rep": r, "iters": 2}
                                          for r in range(3)]
    assert {e["name"] for e in spans} == {"arm"}


# -- the run log's check and report ---------------------------------------

def test_check_schema_and_report(tmp_path, capsys, monkeypatch):
    """A pooled run written through RunLog with an enabled tracer: the
    log passes ``check_schema`` (exit 0), the report renders it with the
    trace's stage breakdown; a broken log exits 1, no log 2; the
    roofline mode renders the dry-run's table (no records: its
    header)."""
    from repro_torch.launch import report
    from repro_torch.telemetry import check_schema

    cfg = T.DFedAvgMConfig(eta=0.05, theta=0.5, local_steps=2,
                           quant=T.QuantConfig(bits=8))
    tr = Tracer()
    runner = T.PooledRunner(
        T.ClientPool(TEMPLATE, POOL_M),
        T.PoolSchedule.ring_partial(POOL_M, POOL_K / POOL_M), pool_loss, cfg,
        pool_batches, key=prng.PRNGKey(1), telemetry=True, tracer=tr,
        device="cpu")
    path, trace = tmp_path / "run.jsonl", tmp_path / "trace.json"
    with RunLog(jsonl=str(path), console=False) as log:
        log.start(config={"m": POOL_M, "k": POOL_K})
        for t in range(3):
            mt = runner.round()
            log.round(t, float(mt.pop("loss")), comm_bits=runner.comm_bits,
                      active_frac=float(mt.pop("active_frac")), **mt)
        log.end(3, comm_bits=runner.comm_bits)
    runner.close()
    tr.save(trace)
    assert set(tr.durations()) == {"pool/prepare", "pool/step",
                                   "pool/writeback", "pool/join",
                                   "pool/patch"}
    assert check_schema.main([str(path)]) == 0
    text = report.telemetry_report(path, trace)
    assert "3 rounds" in text and "pool/step" in text and "quant:" in text
    report.main(["telemetry", "--jsonl", str(path)])
    assert "telemetry report" in capsys.readouterr().out
    bad = tmp_path / "bad.jsonl"
    bad.write_text(path.read_text().splitlines()[1] + "\n")
    assert check_schema.main([str(bad)]) == 1
    assert check_schema.main([]) == 2
    monkeypatch.setattr(report, "OUT_DIR", tmp_path / "dryrun_torch")
    capsys.readouterr()
    report.main(["roofline"])
    assert capsys.readouterr().out.splitlines() == [
        "| arch | shape | mesh | tag | compute ms | memory ms | "
        "collective ms | dominant | useful | wire GB/dev | note |",
        "|" + "---|" * 11]


# ---------------------------------------------------------------------------
# Against the reference, on the same numpy inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits,stochastic,mode", [
    (8, True, "full"), (8, True, "sampled"), (8, True, "weighted"),
    (4, True, "sampled"), (8, False, "full")])
def test_quant_round_telemetry_matches_the_reference(bits, stochastic, mode):
    """Same x, z and key: err and bound within rtol 1e-6, the saturated
    count exact (two leaves, so the leaf order and keys count)."""
    x, z = _xz(7)
    if mode == "weighted":         # two lanes sit the round out
        z["b"][[2, 5]] = x["b"][[2, 5]]
        z["w"][[2, 5]] = x["w"][[2, 5]]
    w = np.ones(M, np.float32)
    w[[2, 5]] = 0.0
    kw = dict(sample_lanes=3 if mode == "sampled" else None)
    lane = mode == "weighted"
    jq = J.QuantConfig(bits=bits, stochastic=stochastic)
    tq = T.QuantConfig(bits=bits, stochastic=stochastic)
    want = jtm.quant_round_telemetry(
        {n: jnp.asarray(v) for n, v in x.items()},
        {n: jnp.asarray(v) for n, v in z.items()}, jq,
        jax.random.PRNGKey(9), lane_weight=jnp.asarray(w) if lane else None,
        **kw)
    got = quant_round_telemetry(_t(x), _t(z), tq, prng.PRNGKey(9),
                                lane_weight=torch.from_numpy(w) if lane
                                else None, **kw)
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-6)
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-6)
    codes = (6.0 if lane else 3.0 if mode == "sampled" else M) * 17
    assert round(float(got[2]) * codes) == round(float(want[2]) * codes)
    assert round(float(got[2]) * codes) > 0


def test_counts_match_the_reference():
    """``staleness_histogram``, ``dropped_edge_count``,
    ``live_edge_count`` (and its ``valid`` mask) and ``wire_bits_for``
    equal the reference's on the same inputs, a realized bill past 2^24
    and a 2D-mesh column bill included."""
    rng = np.random.default_rng(11)
    for trial in range(6):
        version = rng.integers(0, 9, size=M).astype(np.int32)
        ready = (rng.random(M) < 0.5).astype(np.float32)
        adj = np.triu(rng.random((M, M)) < 0.4, 1)
        W = np.where(adj | adj.T, rng.random((M, M)), 0.0).astype(np.float32)
        W += np.diag(rng.random(M)).astype(np.float32)
        valid = (rng.random(M) < 0.7).astype(np.float32)
        S = int(trial % 4)
        tv, tW = torch.from_numpy(version), torch.from_numpy(W)
        assert staleness_histogram(tv, S).tolist() == np.asarray(
            jtm.staleness_histogram(jnp.asarray(version), S)).tolist()
        assert float(dropped_edge_count(tW, tv, torch.from_numpy(ready),
                                        S)) == \
            float(jtm.dropped_edge_count(jnp.asarray(W),
                                         jnp.asarray(version),
                                         jnp.asarray(ready), S))
        assert float(live_edge_count(tW)) == float(
            jtm.live_edge_count(jnp.asarray(W)))
        assert float(live_edge_count(tW, torch.from_numpy(valid))) == float(
            jtm.live_edge_count(jnp.asarray(W), jnp.asarray(valid)))
    for d, q, live, mp in ((199_210, dict(bits=8), 29.0, 1),
                           (199_210, None, 13.0, 1),
                           (1_663_370, dict(bits=4), 31.0, 3),
                           (12, dict(bits=2), 0.0, 1)):
        got = wire_bits_for(d, None if q is None else T.QuantConfig(**q),
                            torch.tensor(live), model_parallel=mp)
        want = jtm.wire_bits_for(d, None if q is None
                                 else J.QuantConfig(**q), live,
                                 model_parallel=mp)
        assert got.dtype == torch.float32
        assert np.float32(got) == np.float32(want), (d, q, live, mp)


D_IN, HID, K, B = 32, 16, 2, 8


def j_loss(p, b, rng):
    return jnets.softmax_xent(jnets.apply_2nn(p, b["x"]), b["y"])


def t_loss(p, b, rng):
    return tnets.softmax_xent(tnets.apply_2nn(p, b["x"]), b["y"])


def _assert_tel(got: dict, want: dict, what):
    """Port and reference telemetry fields of one round or event."""
    for k, v in want.items():
        if v is None:
            assert got.get(k) is None, (what, k)
            continue
        g = got[k]
        if k == "staleness_hist":
            assert [int(c) for c in g] == [int(c) for c in v], (what, k)
        elif k in COUNTS:
            assert float(g) == float(v), (what, k, float(g), float(v))
        elif k in FIELDS:
            rel = QRTOL if k.startswith("quant") else RTOL
            assert float(g) == pytest.approx(float(v), rel=rel, abs=1e-12), \
                (what, k)
    assert got.get("placement_boundary_lanes") is None


@pytest.mark.parametrize("kind", ["ring", "edge_sample", "fused"])
def test_round_step_telemetry_matches_the_reference(kind):
    """Two 2NN rounds (m 8, q8) from the reference's initial parameters:
    the reference jitted (its dense mixer), the port's plan realization
    on the CPU. Every Telemetry field the reference fills, the port
    fills: consensus and drift within rtol 1e-5, the replay's fields
    within 1e-4, live edges and wire bits exact."""
    params = jnets.init_2nn(jax.random.PRNGKey(0), d_in=D_IN, d_hidden=HID)
    np_params = jax.tree.map(np.asarray, params)
    fed = JFed.make(j_dataset(n=400, d=D_IN, seed=0), M)
    tfed = FederatedDataset.make(classification_dataset(n=400, d=D_IN,
                                                        seed=0), M)
    spec = {"ring": lambda L: L.MixingSpec.ring(M, 0.5),
            "edge_sample": lambda L: L.TopologySchedule.edge_sample(
                L.erdos_renyi_graph(M, 0.5, seed=1), 0.5),
            "fused": lambda L: L.MixingSpec.ring(M, 0.5)}[kind]
    kw = dict(eta=0.05, theta=0.9, local_steps=K, fuse_round=kind == "fused")
    jstep = jax.jit(J.make_round_step(
        j_loss, J.DFedAvgMConfig(quant=J.QuantConfig(bits=8), **kw),
        spec(J), with_telemetry=True))
    step = T.make_round_step(
        t_loss, T.DFedAvgMConfig(quant=T.QuantConfig(bits=8), **kw),
        spec(T), device="cpu", with_telemetry=True)
    jst = J.init_round_state(jax.tree.map(
        lambda t: jnp.broadcast_to(t[None], (M,) + t.shape), params),
        jax.random.PRNGKey(1))
    tst = T.init_round_state(convert.params_from_numpy(
        np_params, stack=M, device="cpu"), prng.PRNGKey(1))
    for t in range(2):
        jst, jm = jstep(jst, fed.round_batches(t, K=K, batch=B))
        tst, tm = step(tst, tfed.round_batches(t, K=K, batch=B,
                                               device="cpu"))
        want = jm["telemetry"]._asdict()
        want.pop("placement_boundary_lanes")
        _assert_tel(tm["telemetry"]._asdict(), want, (kind, t))
        if kind == "fused":
            assert tm["telemetry"].quant_err_sq is None


def test_async_step_telemetry_matches_the_reference():
    """14 straggler events on an edge-sampled ring (m 8, q8, hard cutoff
    at lag 1, so edges drop and the overflow bucket fills): the
    histogram, dropped and live edges and wire bits exact at every
    event, consensus and drift within rtol 1e-5, the replay's fields
    within 1e-4; and the invariant live + dropped == the base's live
    edges on the ready rows."""
    cs, loss_fn, batches = quad_problem()
    w0 = np.random.default_rng(3).normal(size=(M, D)).astype(np.float32)
    jb = {"c": jnp.asarray(batches["c"].numpy())}

    def jloss(p, b, r):
        return 0.5 * jnp.sum((p["w"] - b["c"]) ** 2)

    jspeed, jacfg, jsched, jcfg = _async_setup(J, max_staleness=1)
    tspeed, tacfg, tsched, tcfg = _async_setup(T, max_staleness=1)
    jstep = jax.jit(J.make_async_round_step(jloss, jcfg, jsched, jacfg,
                                            with_telemetry=True))
    step = T.make_async_round_step(loss_fn, tcfg, tsched, tacfg,
                                   device="cpu", with_telemetry=True)
    jst = J.init_async_state({"w": jnp.asarray(w0)}, jax.random.PRNGKey(5),
                             jspeed)
    tst = T.init_async_state({"w": torch.from_numpy(w0.copy())},
                             prng.PRNGKey(5), tspeed)
    dropped = 0.0
    for e in range(14):
        pre = tst
        jst, jm = jstep(jst, jb)
        tst, tm = step(tst, batches)
        assert np.array_equal(np.asarray(jst.version), tst.version.numpy())
        tel = tm["telemetry"]
        _assert_tel(tel._asdict(), jm["telemetry"]._asdict(), e)
        assert int(tel.staleness_hist.sum()) == M
        # The invariant, from the event's own W_t and ready set.
        key_mix = prng.split(pre.rng, 3)[1]
        W_t, active, _ = tsched.round_event(key_mix, pre.round)
        _, ready = T.next_event(pre.next_ready)
        ready_eff = ready * active
        base = live_edge_count(W_t * ready_eff[:, None])
        assert float(tel.live_edges) + float(tel.dropped_edges) == \
            float(base)
        dropped += float(tel.dropped_edges)
    assert dropped > 0


def test_pooled_runners_telemetry_match_the_reference():
    """The reference's PooledRunner and PooledAsyncRunner with
    ``telemetry=True`` against the port's on the same seed and data:
    every host field equal (pool counters, cohort size, live edges, wire
    bits, staleness), consensus within rtol 1e-5, the replay's fields
    within 1e-4."""
    m, k, d = 12, 4, 5
    cs = np.random.default_rng(1).normal(size=(m, d)).astype(np.float32)
    tb = torch.from_numpy(np.ascontiguousarray(
        np.broadcast_to(cs[:, None], (m, 4, d))))

    def tl(p, b, r):
        return 0.5 * ((p["w"] - b["c"]) ** 2).sum(-1)

    def jl(p, b, r):
        return 0.5 * jnp.sum((p["w"] - b["c"]) ** 2)

    kw = dict(eta=0.05, theta=0.5, local_steps=4)
    tcfg = T.DFedAvgMConfig(quant=T.QuantConfig(bits=8), **kw)
    jcfg = J.DFedAvgMConfig(quant=J.QuantConfig(bits=8), **kw)
    host = ("pool_hit", "pool_miss", "pool_materialized", "pool_mbytes",
            "cohort_size", "live_edges", "wire_bits")
    tr = T.PooledRunner(T.ClientPool({"w": torch.zeros(d)}, m),
                        T.PoolSchedule.ring_partial(m, k / m), tl, tcfg,
                        lambda idx, t: {"c": tb[idx]}, key=prng.PRNGKey(7),
                        backend="sparse", telemetry=True, device="cpu")
    jr = J.PooledRunner(J.ClientPool({"w": jnp.zeros((d,))}, m),
                        J.PoolSchedule.ring_partial(m, k / m), jl, jcfg,
                        lambda idx, t: {"c": jnp.asarray(cs)[idx][:, None]
                                        .repeat(4, 1)},
                        key=jax.random.PRNGKey(7), backend="sparse",
                        telemetry=True)
    for t in range(4):
        tm, jm = tr.round(), jr.round()
        for f in host:
            assert tm[f] == jm[f], (t, f, tm[f], jm[f])
        for f in ("consensus_dist", "quant_err_sq", "quant_bound",
                  "quant_sat_frac"):
            rel = QRTOL if f.startswith("quant") else RTOL
            assert tm[f] == pytest.approx(jm[f], rel=rel, abs=1e-12), (t, f)
    tr.close()

    def acfg(L):
        return L.AsyncConfig(speed=L.SpeedModel.straggler(factor=4.0),
                             max_staleness=2)

    m8 = 8
    b8 = tb[:m8]
    ta = T.PooledAsyncRunner(
        T.ClientPool({"w": torch.zeros(d)}, m8), tl, tcfg, acfg(T),
        lambda ids, vers: {"c": b8[ids]}, key=prng.PRNGKey(11),
        capacity=m8, ring_self_weight=0.5, telemetry=True, device="cpu")
    ja = J.PooledAsyncRunner(
        J.ClientPool({"w": jnp.zeros((d,))}, m8), jl, jcfg, acfg(J),
        lambda ids, vers: {"c": jnp.asarray(cs[:m8])[ids][:, None]
                           .repeat(4, 1)},
        key=jax.random.PRNGKey(11), capacity=m8, ring_self_weight=0.5,
        telemetry=True)
    for e in range(8):
        tm, jm = ta.step_event(), ja.step_event()
        for f in ("cohort_size", "wire_bits", "staleness_hist",
                  "mean_staleness", "max_staleness", "pool_materialized",
                  "pool_mbytes", "ready_frac"):
            assert tm[f] == jm[f], (e, f, tm[f], jm[f])
        assert float(tm["live_edges"]) == float(jm["live_edges"])


def test_quant_sample_lanes_is_the_references():
    assert QUANT_SAMPLE_LANES == jtm.QUANT_SAMPLE_LANES == 2
    assert Telemetry._fields == jtm.Telemetry._fields
