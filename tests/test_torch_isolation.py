"""The port stands alone: no module of ``src/repro_torch`` and none of
``chip_smoke.py``, ``chip_b7_variants.py``, ``chip_turns.py`` and the
port's examples (``examples/*_torch.py``) imports JAX or the JAX package
(``repro``). Only the parity tests import both.
The check walks each file's syntax tree, so an import inside a function
counts too."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "repro")
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "chip_b7_variants.py",
    ROOT / "chip_turns.py"] + sorted((ROOT / "examples").glob("*_torch.py"))


def imported_roots(path: Path) -> set[str]:
    """Top-level package of every absolute import in ``path``."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_the_port_has_modules_to_check():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "src/repro_torch/core/dfedavgm.py" in names
    # The time-varying slice: schedules, their plans, mixers and benches.
    for mod in ("core/topology.py", "core/gossip_plan.py", "core/mixing.py",
                "core/compiled.py", "prng.py", "kernels/threefry.py",
                "bench/topology.py", "bench/timevarying.py"):
        assert f"src/repro_torch/{mod}" in names, mod
    # The telemetry slice: metrics, tracer, run log, schema and its
    # check, and the report.
    for mod in ("telemetry/metrics.py", "telemetry/tracer.py",
                "telemetry/sink.py", "telemetry/schema.py",
                "telemetry/check_schema.py", "launch/report.py"):
        assert f"src/repro_torch/{mod}" in names, mod
    # The production models and the LM driver: configs, the models, the
    # training and serving drivers and their examples.
    for mod in ("configs/base.py", "configs/smollm_135m.py",
                "models/layers.py", "models/attention.py",
                "models/transformer.py", "models/moe.py", "models/ssm.py",
                "models/frontends.py", "models/model.py", "launch/mesh.py",
                "launch/train.py", "launch/serve.py"):
        assert f"src/repro_torch/{mod}" in names, mod
    for ex in ("train_dfedavgm_lm_torch.py", "serve_consensus_torch.py"):
        assert f"examples/{ex}" in names, ex
    # The 1D client mesh: block plans and placement, the mesh, the
    # sharded executor and its callers, the bills, the B2/B5 row count.
    for mod in ("core/gossip_plan.py", "core/topology.py", "launch/mesh.py",
                "core/mixing.py", "core/dfedavgm.py", "core/compiled.py",
                "core/async_gossip.py", "core/comm_cost.py",
                "launch/train.py", "kernels/dequant_mix.py"):
        assert f"src/repro_torch/{mod}" in names, mod
    # The 2D (clients, model) mesh: the sharding rules and the models'
    # logical axes.
    for mod in ("sharding/__init__.py", "sharding/rules.py",
                "models/model.py", "launch/mesh.py", "bench/timevarying.py"):
        assert f"src/repro_torch/{mod}" in names, mod
    assert "chip_smoke.py" in names and len(names) > 20


@pytest.mark.parametrize("path", FILES,
                         ids=[p.relative_to(ROOT).as_posix() for p in FILES])
def test_no_jax_or_repro_import(path):
    bad = imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_the_check_catches_each_forbidden_form(tmp_path):
    for src in ("import jax", "import jax.numpy as jnp",
                "from jaxlib import xla_client", "from repro.core import x",
                "import repro", "def f():\n    from jax import lax\n"):
        p = tmp_path / "m.py"
        p.write_text(src + "\n")
        assert imported_roots(p) & set(FORBIDDEN), src
    p = tmp_path / "m.py"
    p.write_text("import repro_torch\nfrom . import repro\nimport torch\n")
    assert not imported_roots(p) & set(FORBIDDEN)
