"""Everything by name: ``BENCHMARK.json`` at the checkout's root names the
cells, configurations and metrics; a cell's files are found from it.

* configuration ``<name>``: the file its ``configs`` entry names
  (``portbench/configs/<name>.json``);
* traffic mix ``<name>``: ``portbench/mixes/<name>.json``;
* a cell's limits: ``portbench/limits/<cell>.json``;
* metric ``<name>``: its reader ``portbench/metrics/<name>.py``;
* model family ``<family>`` (a configuration's ``family``): its reference
  ``portbench/reference/<family>.py`` and its counts
  ``portbench/counts/<family>.py``.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

PORTBENCH = Path(__file__).resolve().parent.parent
ROOT = PORTBENCH.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The Python file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """``BENCHMARK.json`` and the files its names lead to."""

    def __init__(self, root: Path = ROOT, portbench: Path = PORTBENCH):
        self.root = Path(root)
        self.dir = Path(portbench)
        self.spec = _json(self.root / "BENCHMARK.json")

    def _entry(self, kind: str, name: str) -> dict:
        for e in self.spec[kind]:
            if e["name"] == name:
                return e
        raise KeyError(f"{kind} has no entry {name!r}; have "
                       f"{[e['name'] for e in self.spec[kind]]}")

    def cell(self, name: str) -> dict:
        return self._entry("workloads", name)

    def config(self, cell: dict) -> dict:
        return _json(self.root / self._entry("configs", cell["config"])
                     ["file"])

    def mix(self, cell: dict) -> dict:
        return _json(self.dir / "mixes" / f"{cell['traffic']}.json")

    def limits(self, cell: dict) -> dict:
        return _json(self.dir / "limits" / f"{cell['name']}.json")["limits"]

    def metrics(self, cell: dict, traced: bool) -> list[dict]:
        """The cell's metrics of one kind (per-layer when ``traced``, else
        end-to-end): those whose ``workloads`` name it, or that have none."""
        kind = "per_layer" if traced else "end_to_end"
        return [m for m in self.spec[kind]
                if cell["name"] in m.get("workloads", [cell["name"]])]

    def reader(self, metric: str):
        """Metric ``metric``'s ``read(run) -> float | None``."""
        return load_module(self.dir / "metrics" / f"{metric}.py",
                           f"portbench_metric_{metric}").read

    def counts(self, family: str):
        return load_module(self.dir / "counts" / f"{family}.py",
                           f"portbench_counts_{family}")
