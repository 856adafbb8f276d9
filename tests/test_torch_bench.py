"""The port's bench runner (``python -m repro_torch.bench.run``) at its
smoke size on the CPU: it prints the reference benches' CSV header and
row names (``benchmarks/bench_fig6_compare.py``,
``benchmarks/bench_quant_epochs.py``, ``bench_cnn.py``,
``bench_charlm.py``, ``bench_topology.py``, the in-process rows of
``bench_timevarying.py`` and ``bench_async.py``), every arm trains to a
finite accuracy or loss, the Fig. 6 rows bill exactly the bits of the
reference's ``comm_cost`` at the same m, rounds and d, the topology
bench's lambda rows are the reference's, the time-varying rows bill the
reference's schedule bits, the async row has the reference's fields and
the pool bench (``bench_pool.py``) reports its pooled arm bitwise with
the resident one, billed and FLOP-counted equal, and the rows of
``bench_mia.py``, ``bench_comm_cost.py`` and ``bench_kernels.py``
(``tests/test_torch_bench_ride_alongs.py`` holds their values); a
two-round Fig. 6
DFedAvgM arm tracks the reference's. A failing bench makes the runner
exit non-zero.

Contract: names, lambda rows and MB and bit strings equal; accuracies
finite in [0, 1], losses finite and positive; the Fig. 6 arm's loss,
consensus distance and accuracy within rtol 1e-4 of the reference's (the
same keyed init and data).
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro.configs import list_archs as j_list_archs  # noqa: E402
from repro.core import MixingSpec as JMixingSpec  # noqa: E402
from repro.core import comm_cost as jcc  # noqa: E402
from repro_torch.bench import (async_compare, charlm, cnn,  # noqa: E402
                               fig6_compare, pool, quant_epochs, timevarying,
                               topology)
from repro_torch.bench import run as bench_run  # noqa: E402
from repro_torch.bench.common import timed, timeit_best  # noqa: E402

torch.set_num_threads(1)

D = 199_210          # the 2NN 784-200-200-10


def reference_rows():
    """Row names as the reference benches build them."""
    names = ["fig6/dfedavgm", "fig6/fedavg", "fig6/dsgd"]
    for tag in ("iid", "noniid"):
        names += [f"fig2345/{tag}/bits{b}" for b in (32, 16, 8, 4)]
        names += [f"fig2345/{tag}/K{k}" for k in (1, 2, 5)]
    names += [f"fig8/cnn/K{k}" for k in (1, 2)]
    names += [f"fig7/charlm/bits{b}" for b in (32, 8)]
    names += [f"topology/lambda/{g}" for g in (
        "ring16", "torus4x4", "ring32", "torus4x8", "complete16")]
    names += ["topology/noniid_acc/ring4", "topology/noniid_acc/torus2x2"]
    names += [f"timevarying_{s}" for s in (
        "static_ring", "constant_sched", "er_edge_sample", "ring_partial",
        "ring_random_walk")]
    names += ["gossip_sparse_vs_dense_b32", "gossip_sparse_vs_dense_b8",
              "gossip_block64_sparse_vs_dense_b8", "gossip_mesh2d_vs_1d_b8",
              "round_fused_vs_unfused_b8", "round_telemetry_on_vs_off",
              "placement_er_partition_vs_contiguous",
              "placement_ring_chords_partition_vs_contiguous"]
    names.append("async_vs_sync_straggler")
    names += ["pool/m=4096", "pool/compare"]
    # bench_mia at the port's smoke size (2 rounds), bench_comm_cost's
    # Prop. 3 table and bench_kernels' rows of the plain versions (the
    # card adds one row for each entry point; the CPU runs none).
    names.append("mia/dfedavgm/rounds2")
    names += [f"prop3/{a}/b{b}" for a in j_list_archs() for b in (8, 4)]
    names += [f"kernels/{k}" for k in (
        "encode_ref/b8", "dequant_mix_ref/b8", "encode_ref/b4",
        "dequant_mix_ref/b4", "momentum_ref")]
    return names


_WIRE = {"sparse_wireB", "dense_wireB", "ratio", "dense_us", "billed_bits",
         "realized_wire_bits"}
_LANES = {"graph", "contig_lanes", "part_lanes", "ratio", "contig_q8B",
          "part_q8B"}
MESH_ROW_FIELDS = {
    "gossip_sparse_vs_dense_b32": _WIRE, "gossip_sparse_vs_dense_b8": _WIRE,
    "gossip_block64_sparse_vs_dense_b8": {
        "m", "shards", "block_wireB", "dense_wireB", "ratio",
        "boundary_lanes", "realized_wire_bits"},
    "gossip_mesh2d_vs_1d_b8": {"mp", "wire2dB", "wire1dB", "ratio",
                               "fp32_ratio"},
    "round_fused_vs_unfused_b8": {"unfused_us", "speedup", "bytes_min"},
    "placement_er_partition_vs_contiguous": _LANES,
    "placement_ring_chords_partition_vs_contiguous": _LANES}


def reference_fig6_derived(m, rounds, k):
    """The MB fields of the reference's Fig. 6 rows at (m, rounds)."""
    ring = JMixingSpec.ring(m, self_weight=0.5).graph
    mb = {"dfedavgm": jcc.dfedavgm_round_bits(ring, D) * rounds / 8e6,
          "fedavg": jcc.fedavg_round_bits(m, D) * rounds / 8e6,
          "dsgd": jcc.dsgd_round_bits(JMixingSpec.ring(m).graph, D)
          * rounds * k / 8e6}
    neck = {"dfedavgm": jcc.bottleneck_bits("dfedavgm", D, graph=ring),
            "fedavg": jcc.bottleneck_bits("fedavg", D, m=m)}
    out = {f"fig6/{a}": f"commMB={v:.0f}" for a, v in mb.items()}
    for a, v in neck.items():
        out[f"fig6/{a}"] += f";bottleneckMB={v * rounds / 8e6:.1f}"
    return out


def reference_topology_lambda_rows():
    """The reference bench's lambda rows (its ``run`` without the
    training half): spec.lam and ``_rounds_to_consensus`` of the JAX
    package's specs."""
    from benchmarks.bench_topology import _rounds_to_consensus
    rows = []
    for name, spec in (("ring16", JMixingSpec.ring(16)),
                       ("torus4x4", JMixingSpec.torus(4, 4)),
                       ("ring32", JMixingSpec.ring(32)),
                       ("torus4x8", JMixingSpec.torus(4, 8)),
                       ("complete16", JMixingSpec.complete(16))):
        rows.append((f"topology/lambda/{name}", 0.0,
                     f"lambda={spec.lam:.4f};"
                     f"consensus_rounds={_rounds_to_consensus(spec)};"
                     f"deg={int(spec.graph.degrees().max())}"))
    return rows


def reference_timevarying_bits():
    """bits_per_round of the reference's schedules at the smoke m."""
    from benchmarks.bench_timevarying import schedules
    from repro.core import TopologySchedule as JSched
    out = {}
    for name, topo in schedules(timevarying.SMOKE_M, timevarying.SMOKE_ROUNDS):
        bpr = (jcc.schedule_round_bits(topo, D, None)
               if isinstance(topo, JSched)
               else jcc.dfedavgm_round_bits(topo.graph, D, None))
        out[f"timevarying_{name}"] = f"{bpr:.0f}"
    return out


def test_topology_lambda_rows_equal_the_reference():
    assert topology.lambda_rows() == reference_topology_lambda_rows()


def test_smoke_run_gives_the_reference_rows_and_bits(capsys, monkeypatch,
                                                     tmp_path):
    monkeypatch.setattr(async_compare, "OUT_JSON", tmp_path / "a.json")
    monkeypatch.setattr(pool, "OUT_JSON", tmp_path / "p.json")
    monkeypatch.setattr(timevarying, "GOSSIP_JSON", tmp_path / "g.json")
    assert bench_run.main(["--smoke", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "name,us_per_call,derived"
    rows = [ln.split(",", 2) for ln in lines[1:]]
    assert [r[0] for r in rows] == reference_rows()
    want = reference_fig6_derived(fig6_compare.SMOKE_M,
                                  fig6_compare.SMOKE_ROUNDS, fig6_compare.K)
    lam = {n: d for n, _, d in reference_topology_lambda_rows()}
    for name, us, derived in rows:
        if name in lam:       # numpy rows: no time, as in the reference
            assert float(us) == 0.0 and derived == lam[name], name
            continue
        if name == "round_telemetry_on_vs_off":   # on / off, us a round
            fields = dict(f.split("=") for f in derived.split("|"))
            assert set(fields) == {"off_us", "overhead_ratio"}, derived
            assert float(us) > 0 and float(fields["overhead_ratio"]) > 0
            continue
        if name in MESH_ROW_FIELDS:      # the mesh halves' rows
            fields = dict(f.split("=") for f in derived.split("|"))
            assert set(fields) == MESH_ROW_FIELDS[name], derived
            assert (float(us) == 0.0) == name.startswith("placement_"), name
            continue
        if name == "async_vs_sync_straggler":   # virtual time to target
            assert set(dict(f.split("=") for f in derived.split("|"))) == {
                "target_loss", "sync_t", "async_t", "speedup", "beats_sync",
                "us_per_event"}, derived
            continue
        if name.startswith("pool/"):       # space-separated fields
            fields = dict(f.split("=") for f in derived.split(" "))
            assert set(fields) == ({"rps", "k"} if name != "pool/compare"
                                   else {"pooled", "resident",
                                         "cost_ratio", "bitwise"}), name
            continue
        if name.startswith(("mia/", "prop3/")):  # no time, as the reference
            fields = dict(f.split("=") for f in derived.split(";"))
            assert float(us) == 0.0, name
            assert set(fields) == ({"auc"} if name.startswith("mia/") else
                                   {"wins", "roundGB32", "roundGBq",
                                    "saving"}), name
            if name.startswith("mia/"):
                assert 0.0 <= float(fields["auc"]) <= 1.0, name
            continue
        if name.startswith("kernels/"):   # the plain versions, timed
            assert float(us) > 0 and derived in {
                "wire_saving=4x", "wire_saving=8x", "fused=1pass",
                "hbm_traffic=5N"}, name
            continue
        assert math.isfinite(float(us)) and float(us) > 0, name
        fields = dict(f.split("=") for f in derived.replace(
            "|", ";").split(";"))
        if not name.startswith("fig7/"):
            assert 0.0 <= float(fields["acc"]) <= 1.0, name
        if "loss" in fields:
            assert math.isfinite(float(fields["loss"])), name
            assert float(fields["loss"]) > 0, name
        if name in want:
            acc, mb = derived.split(";", 1)
            assert acc.startswith("acc="), name
            assert mb == want[name], name
            assert set(fields) - {"commMB", "bottleneckMB"} == {"acc"}, name
        elif name.startswith("fig8/"):
            assert set(fields) == {"acc", "loss"}, name
        elif name.startswith("fig7/"):
            assert set(fields) == {"loss"}, name
        elif name.startswith("timevarying_"):
            assert set(fields) == {"loss", "consensus_dist",
                                   "bits_per_round", "acc"}, name
            assert fields["bits_per_round"] == \
                reference_timevarying_bits()[name], name
        else:
            assert set(fields) == {"acc"}, name


def test_arms_report_losses_and_bits():
    arms = dict(fig6_compare.arms(smoke=True, device="cpu"))
    m, rounds = fig6_compare.SMOKE_M, fig6_compare.SMOKE_ROUNDS
    assert arms["fig6/fedavg"]["comm_bits"] == \
        jcc.fedavg_round_bits(m, D) * rounds
    for name, r in arms.items():
        assert math.isfinite(r["first_loss"]) and math.isfinite(r["loss"])
        assert r["captured"] is False and r["capture_s"] == 0.0, name
    names = [n for n, _ in quant_epochs.arms(smoke=True, device="cpu")]
    assert names == reference_rows()[3:17]


@pytest.mark.parametrize("bench", [cnn, charlm], ids=["fig8", "fig7"])
def test_paper_model_benches_report_losses(bench):
    """The CNN (Fig. 8) and char-LM (Fig. 7) arms at smoke size: finite
    losses from the first round to the last, eager on the CPU."""
    rows = dict(bench.arms(smoke=True, device="cpu"))
    assert list(rows) == [n for n in reference_rows()
                          if n.startswith(("fig8/", "fig7/"))
                          and n.split("/")[1] == bench.__name__.rsplit(
                              ".", 1)[1]]
    for name, r in rows.items():
        assert math.isfinite(r["first_loss"]) and math.isfinite(r["loss"])
        assert math.isfinite(r["consensus_dist"]), name
        assert r["captured"] is False and r["graph"] is None, name


def test_async_compare_smoke_row_and_json(monkeypatch, tmp_path):
    """``bench.async_compare`` at the reference's smoke size (3 rounds,
    batch 8) on the CPU: the row parses as the reference's, the curves
    have a point a round, losses are finite, the async arm's virtual
    clock runs ahead of the sync arm's rounds, and the JSON is written
    where ``OUT_JSON`` points."""
    import json

    out = tmp_path / "BENCH_async_torch.json"
    monkeypatch.setattr(async_compare, "OUT_JSON", out)
    [(name, us, derived)] = async_compare.run(smoke=True, device="cpu")
    assert name == "async_vs_sync_straggler" and us >= 0.0
    fields = dict(f.split("=") for f in derived.split("|"))
    assert float(fields["target_loss"]) > 0
    assert float(fields["us_per_event"]) > 0
    res = json.loads(out.read_text())
    assert res["device"] == "cpu" and res["captured"] is False
    assert res["rounds"] == 3 and res["m"] == 8 and res["K"] == 2
    for arm in ("sync_curve", "async_curve"):
        assert len(res[arm]) == 3
        assert all(math.isfinite(t) and math.isfinite(v) and v > 0
                   for t, v in res[arm]), arm
    # A sync round waits for the straggler (~10); an m-event async chunk
    # advances the clock by the fast clients' durations (~1).
    assert res["async_curve"][-1][0] < res["sync_curve"][-1][0]


def test_pool_smoke_rows_and_json(monkeypatch, tmp_path):
    """``bench.pool`` at the reference's smoke size on the CPU (one m =
    4 096 arm at k 64; the comparison at m 64, k 16): the rows parse as
    the reference's, and the pooled run is bitwise with the resident one,
    bills its schedule's bits and counts the resident skip round's
    FLOPs."""
    import json

    out = tmp_path / "BENCH_pool_torch.json"
    monkeypatch.setattr(pool, "OUT_JSON", out)
    rows = pool.run(smoke=True, device="cpu")
    assert [r[0] for r in rows] == ["pool/m=4096", "pool/compare"]
    rps = dict(f.split("=") for f in rows[0][2].split(" "))
    assert float(rps["rps"]) > 0 and rps["k"] == "64"
    cmp = dict(f.split("=") for f in rows[1][2].split(" "))
    assert cmp["bitwise"] == "True"
    res = json.loads(out.read_text())
    assert res["smoke"] is True and res["device"] == "cpu"
    [arm] = res["pool_scaling"]
    assert arm["m"] == 4096 and arm["cohort"] == 64
    c = res["compare"]
    assert (c["m"], c["cohort"]) == (64, 16)
    assert c["bitwise_equal"] and c["billing_equal"] and c["flops_equal"]
    assert c["pooled_round_flops"] == c["resident_round_flops"] > 0
    assert c["billing_bits_per_round"] > 0


def test_fig6_dfedavgm_arm_tracks_the_reference():
    """Two rounds of the Fig. 6 DFedAvgM arm at the smoke size (m 4, K 4,
    batch 32), seeded as the reference's bench seeds it
    (``init_2nn(PRNGKey(0))``, the state's key ``PRNGKey(1)``): loss,
    consensus distance and accuracy within rtol 1e-4 of the reference's
    ``train_dfedavgm_2nn`` on the same data."""
    from benchmarks.common import train_dfedavgm_2nn as j_train
    from repro.data import classification_dataset as j_data

    r = next(fig6_compare.arms(smoke=True, device="cpu"))[1]
    want = j_train(m=fig6_compare.SMOKE_M, K=fig6_compare.K,
                   batch=fig6_compare.B, rounds=fig6_compare.SMOKE_ROUNDS,
                   data=j_data(n=8000, seed=0))
    for f in ("loss", "consensus_dist", "acc"):
        assert r[f] == pytest.approx(want[f], rel=1e-4), f


def test_charlm_batches_are_the_reference_windows():
    """Each row of a round's batch is a window of SEQ + 1 characters of
    its client's stream, at the starts the reference draws."""
    import numpy as np

    streams = [np.arange(100, dtype=np.int32) + 1000 * i for i in range(3)]
    t = charlm.lm_batches(streams, 5, K=2, batch=4, seq=6)["t"].numpy()
    rng = np.random.default_rng(5)
    for i in range(3):
        starts = rng.integers(0, 100 - 6 - 1, size=(2, 4))
        assert np.array_equal(t[i, :, :, 0], starts + 1000 * i)
        assert np.array_equal(np.diff(t[i], axis=-1), np.ones((2, 4, 6)))


def test_only_and_a_failing_bench(monkeypatch, capsys):
    def broken(**kwargs):
        raise RuntimeError("boom")

    monkeypatch.setattr(quant_epochs, "run", broken)
    assert bench_run.main(["--smoke", "--device", "cpu", "--only",
                           "quant"]) == 1
    out = capsys.readouterr().out
    assert "quant_epochs,NaN,FAILED:RuntimeError('boom')" in out
    assert "fig6" not in out


def test_timers_on_the_cpu():
    assert timed(lambda: None, device="cpu") >= 0
    best, carry = timeit_best(lambda i, c: c + [i], [], iters=2, reps=2,
                              warmup=1, device="cpu")
    assert best >= 0 and carry == [0, 1, 2, 3, 4]
