"""The ride-alongs of the membership-inference slice on the CPU:
``repro_torch.bench.comm_cost`` against ``benchmarks/bench_comm_cost.py``
(rows equal, character for character: pure arithmetic over the configs'
``n_params()``), ``repro_torch.bench.kernels`` at its smoke size (the
reference's row names and derived strings; the plain versions it times
against the reference's oracles: words bitwise, the ring decode and the
momentum step within 2 ulp, as XLA may contract their multiply-adds),
and ``examples/nonIID_vs_IID_torch.py`` for two rounds on the CPU.
"""
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as JR  # noqa: E402
from repro_torch.bench import comm_cost, kernels  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
MAX_ULP = 2
REFERENCE_KERNEL_ROWS = [
    ("kernels/encode_ref/b8", "wire_saving=4x"),
    ("kernels/dequant_mix_ref/b8", "fused=1pass"),
    ("kernels/encode_ref/b4", "wire_saving=8x"),
    ("kernels/dequant_mix_ref/b4", "fused=1pass"),
    ("kernels/momentum_ref", "hbm_traffic=5N")]


def ulp(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(np.where(a < 0, -(a & 0x7FFFFFFF), a)
                      - np.where(b < 0, -(b & 0x7FFFFFFF), b)).max())


def test_comm_cost_rows_equal_the_reference():
    from benchmarks.bench_comm_cost import run as j_run
    want = j_run()
    got = comm_cost.run(smoke=True, device="cpu")
    assert got == want and len(got) == 20


def test_kernels_smoke_has_the_reference_rows():
    rows = kernels.run(smoke=True, device="cpu")
    assert [(n, d) for n, _, d in rows] == REFERENCE_KERNEL_ROWS
    assert all(us >= 0 for _, us, _ in rows)


@pytest.mark.parametrize("bits", [8, 4])
def test_kernels_plain_versions_against_the_reference_oracles(bits):
    x, v, g = kernels.operands(kernels.SMOKE_N, torch.device("cpu"))
    jx = jnp.asarray(x.numpy())
    s = torch.full((), kernels.S, dtype=torch.float32)
    want = np.asarray(JR.quantize_pack_ref(jx, bits, jnp.float32(kernels.S)))
    words = kernels.encode_plain(x, bits, s)
    assert np.array_equal(words.numpy().view(np.uint32), want)
    sc = torch.tensor([0.01, 0.02, 0.03], dtype=torch.float32)
    got = kernels.ring_plain(x, words, sc, bits)
    jw = jnp.asarray(want)
    ref = JR.dequant_mix_ref(jx, jw, jw, jw, jnp.asarray(sc.numpy()), bits,
                             kernels.W_SELF, kernels.W_NB)
    assert got.shape == x.shape and ulp(got, ref) <= MAX_ULP
    ty, tv = TR.momentum_sgd_ref(x, v, g, 0.01, 0.9)
    jy, jv = JR.momentum_sgd_ref(jx, jnp.asarray(v.numpy()),
                                 jnp.asarray(g.numpy()), 0.01, 0.9)
    assert ulp(ty, jy) <= MAX_ULP and ulp(tv, jv) <= MAX_ULP


def test_nonIID_vs_IID_example_two_rounds(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["nonIID_vs_IID_torch.py", "--device",
                                      "cpu", "--rounds", "2"])
    runpy.run_path(str(ROOT / "examples" / "nonIID_vs_IID_torch.py"),
                   run_name="__main__")
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if "acc=" in ln]
    assert "===== IID =====" in out and "===== Non-IID =====" in out
    assert [ln.split()[0] for ln in lines] == [
        "DFedAvgM-32b", "DFedAvgM-8b", "FedAvg"] * 2
    for ln in lines:
        acc = float(ln.split("acc=")[1].split()[0])
        loss = float(ln.split("loss=")[1].split()[0])
        assert 0.0 <= acc <= 1.0 and np.isfinite(loss) and loss > 0
    # 2 rounds of the 2NN's 199 210 parameters: the reference's bills.
    assert "comm=51MB" in lines[0] and "comm=13MB" in lines[1]
