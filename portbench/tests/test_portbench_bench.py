"""Discovery by name: every cell's configuration, mix and limits, every
metric's reader; the readers on a made-up run; ``BENCHMARK.json``'s shape;
the last line's keys of a run on the CPU."""
from __future__ import annotations

import json
import re
from types import SimpleNamespace

import pytest

from portbench.harness import check
from portbench.harness.bench import PORTBENCH, ROOT, Bench

BENCH = Bench()
SPEC = BENCH.spec
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("cell", [c["name"] for c in SPEC["workloads"]])
def test_cell_files_are_found_by_name(cell):
    spec = BENCH.cell(cell)
    assert set(spec) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell) and NAME.match(spec["traffic"])
    assert spec["chips"] == 1 and 0 < len(spec["why"]) <= 200
    config = BENCH.config(spec)
    entry = next(c for c in SPEC["configs"] if c["name"] == spec["config"])
    assert entry["file"].startswith("portbench/configs/")
    assert config["name"] == spec["config"]
    assert sorted(entry["reduced"]) == sorted(
        [*config["reduced"], *config.get("port_differs", {})])
    assert config["source"] == entry["source"]
    mix = BENCH.mix(spec)
    assert mix["topology"] == "ring"
    assert not {"check_rounds", "stochastic"} & set(mix)
    assert BENCH.limits(spec) and set(BENCH.limits(spec)) <= set(check.NUMBERS)
    assert (PORTBENCH / "reference" / f"{config['family']}.py").exists()
    for traced in (False, True):
        assert BENCH.metrics(spec, traced)


def test_metrics_have_readers_and_valid_entries():
    assert {m["name"] for m in SPEC["end_to_end"]} >= {"setup_s"}
    setup = next(m for m in SPEC["end_to_end"] if m["name"] == "setup_s")
    assert "workloads" not in setup, "every cell reports setup_s"
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    moves = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert callable(BENCH.reader(m["name"]))
    for m in SPEC["per_layer"]:
        assert m["moves"] in moves and "\n" not in m["layer"]
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def _trace(**group_s):
    return SimpleNamespace(rounds=2, window_s=0.8, busy_s=0.6,
                           group_s=group_s)


def test_readers_on_a_made_up_run():
    counts = {"tokens_per_round": 1000, "flops_per_round": 989e12 * 0.04,
              "b1_least_s": 0.001, "b2_least_s": 0.002, "b3_least_s": 0.003}
    run = SimpleNamespace(counts=counts, setup_s=12.5, peak_bytes=2 ** 31,
                          round_s=[0.1] * 9 + [0.2] * 11, window_s=4.0,
                          trace=_trace(matmul=0.1, torch_other=0.3, b1=0.004,
                                       b2=0.004, b3=0.012))
    read = {m["name"]: BENCH.reader(m["name"])(run)
            for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    assert read["tokens_per_s"] == pytest.approx(5000.0)
    assert read["round_ms_p90"] == pytest.approx(200.0)
    assert read["peak_mem_gib"] == 2.0 and read["setup_s"] == 12.5
    assert read["device_idle_share"] == pytest.approx(25.0)
    assert read["step_mfu"] == pytest.approx(10.0)
    assert read["matmul_ms_per_round"] == pytest.approx(50.0)
    assert read["torch_other_ms_per_round"] == pytest.approx(150.0)
    assert read["b1_roofline"] == pytest.approx(50.0)
    assert read["b2_roofline"] == pytest.approx(100.0)
    assert read["b3_roofline"] == pytest.approx(50.0)


def test_readers_find_nothing_to_read():
    run = SimpleNamespace(counts={}, setup_s=1.0, peak_bytes=0, round_s=[],
                          window_s=1.0, trace=_trace(matmul=0.1))
    for name in ("b1_roofline", "b2_roofline", "b3_roofline",
                 "torch_other_ms_per_round", "peak_mem_gib", "round_ms_p90"):
        assert BENCH.reader(name)(run) is None
    run.trace = None
    for m in SPEC["per_layer"]:
        assert BENCH.reader(m["name"])(run) is None


def test_result_line_keys_on_the_cpu(tmp_path):
    import time

    from portbench.harness import cell as cells
    from portbench.tests import tiny

    bench = tiny.make(tmp_path)
    result, notes, lines = cells.run_cell(bench, "smollm.tiny", 2 ** 31 + 7,
                                          2.0, False, "cpu",
                                          time.perf_counter())
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checked"]
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["metrics"]) == {"tokens_per_s", "round_ms_p90",
                                      "setup_s"}
    assert list(result["checked"]) == list(tiny.LIMITS)
    assert [ln.split()[1] for ln in lines] == list(tiny.LIMITS)
    assert result["device"]["platform"] == "cpu"
    assert (ROOT / "BENCHMARK.json").exists()


def test_numbers_by_hand():
    # Two leaves of two clients each. Whole-leaf norms: a 5 (3, 4) against
    # 5 (4, 3), b 13 (5, 12) against 10 (6, 8); median leaf 7.5. The parts'
    # median norm is 5: gaps 1/5, 1/5, 1/6, 4/8.
    prog = {"losses": [2.0, 1.0], "update1": {"a": [3.0, 4.0],
                                              "b": [5.0, 12.0]}}
    ref = {"losses": [2.5, 1.0], "update1": {"a": [4.0, 3.0],
                                             "b": [6.0, 8.0]},
           "grad_norms": {"a": 1.0, "b": 2.0}}
    prog["change"], ref["change"] = prog["update1"], ref["update1"]
    nums = check.numbers(prog, ref)
    assert nums["loss_gap"] == pytest.approx(0.2)
    assert nums["update1_gap"] == pytest.approx(0.3)
    assert nums["change_gap"] == pytest.approx(0.3)
    assert nums["update1_median_gap"] == pytest.approx(0.2)
    ok, shown = check.judge(nums, {"loss_gap": 0.25, "update1_gap": 0.29})
    assert not ok and list(shown) == ["loss_gap", "update1_gap"]
