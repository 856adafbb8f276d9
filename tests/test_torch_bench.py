"""The port's bench runner (``python -m repro_torch.bench.run``) at its
smoke size on the CPU: it prints the reference benches' CSV header and
row names (``benchmarks/bench_fig6_compare.py``,
``benchmarks/bench_quant_epochs.py``), every arm trains to a finite
accuracy, and the Fig. 6 rows bill exactly the bits of the reference's
``comm_cost`` at the same m, rounds and d. A failing bench makes the
runner exit non-zero.

Contract: names and MB strings equal; accuracies finite in [0, 1].
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro.core import MixingSpec as JMixingSpec  # noqa: E402
from repro.core import comm_cost as jcc  # noqa: E402
from repro_torch.bench import fig6_compare, quant_epochs  # noqa: E402
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
    return names


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


def test_smoke_run_gives_the_reference_rows_and_bits(capsys):
    assert bench_run.main(["--smoke", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "name,us_per_call,derived"
    rows = [ln.split(",", 2) for ln in lines[1:]]
    assert [r[0] for r in rows] == reference_rows()
    want = reference_fig6_derived(fig6_compare.SMOKE_M,
                                  fig6_compare.SMOKE_ROUNDS, fig6_compare.K)
    for name, us, derived in rows:
        assert math.isfinite(float(us)) and float(us) > 0, name
        fields = dict(f.split("=") for f in derived.split(";"))
        assert 0.0 <= float(fields["acc"]) <= 1.0, name
        if name in want:
            mb = derived.split(";", 1)[1]
            assert mb == want[name], name
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
    assert names == reference_rows()[3:]


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
