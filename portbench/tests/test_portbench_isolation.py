"""What the benchmark loads: no module of JAX or of the JAX package (their
top-level names compared whole: the port's ``repro_torch`` begins with
``repro``) and nothing of the JAX-era ``benchmarks/``; the reference loads
nothing of the program. Without a card the harness prints no result and
exits non-zero, also from a directory holding only ``BENCHMARK.json`` and
``portbench/``."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench.harness.bench import PORTBENCH, ROOT

ENV = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT / "src"),
                                                    str(ROOT)])}


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport json, sys\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")],
        capture_output=True, text=True, env=ENV, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_and_the_program_load_no_jax():
    top = _loaded(
        "from portbench.harness import cell, program\n"
        "from portbench.harness.bench import Bench\n"
        "import portbench.control\n"
        "b = Bench()\n"
        "for name in ('smollm135m.q8.k4', 'mamba2-780m.q8.k2'):\n"
        "    c = cell.Cell(b, name, 'cpu')\n"
        "    program.build_step(c.arch, c.mix, 'cpu')\n"
        "assert not cell.forbidden_modules(), cell.forbidden_modules()\n")
    assert "repro_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def test_the_reference_loads_nothing_of_the_program():
    top = _loaded("import portbench.reference.dfedavgm, "
                  "portbench.reference.smollm, portbench.reference.mamba2")
    assert not top & {"repro_torch", "repro", "jax", "benchmarks"}
    for path in (PORTBENCH / "reference").glob("*.py"):
        text = path.read_text()
        assert "repro_torch" not in text and "harness" not in text, path


@pytest.mark.parametrize("only_the_benchmark", [False, True])
def test_no_card_no_result(tmp_path, only_the_benchmark):
    root = ROOT
    if only_the_benchmark:
        root = tmp_path / "checkout"
        shutil.copytree(PORTBENCH, root / "portbench",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(ROOT / "BENCHMARK.json", root)
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "smollm135m.q8.k1", "--seed", str(2 ** 31 + 3), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=root,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""}, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "card" in out.stderr


@pytest.mark.card
def test_a_cell_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "smollm135m.q8.k1", "--seed", str(2 ** 31 + 5), "--seconds", "3",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert line["correct"], line["checked"]
