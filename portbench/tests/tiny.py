"""A benchmark of tiny cells for the CPU tests: the real configuration and
mix files with their widths, depth and traffic cut down, written with a
``BENCHMARK.json`` into a directory of their own beside copies of the
real metric readers and counts."""
from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

from portbench.harness.bench import PORTBENCH, ROOT, Bench

SMOLLM = {"hidden_size": 64, "intermediate_size": 128,
          "num_attention_heads": 4, "num_key_value_heads": 2,
          "num_hidden_layers": 2, "vocab_size": 256, "vocab_ids": 256}
SMOLLM_PORT = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
               "head_dim": 16, "d_ff": 128, "vocab_size": 256}
MAMBA2 = {"d_model": 64, "n_layer": 2, "vocab_size": 250, "d_state": 16,
          "headdim": 16, "vocab_ids": 250}
MAMBA2_PORT = {"n_layers": 2, "d_model": 64, "ssm_state": 16,
               "ssm_head_dim": 16, "vocab_size": 256}
CELLS = {"smollm.tiny": ("smollm-135m", SMOLLM, SMOLLM_PORT,
                         "ring8.q8.k4.b4x128",
                         {"clients": 4, "local_steps": 2, "batch": 2,
                          "seq": 16}),
         "smollm.tiny.k1": ("smollm-135m", SMOLLM, SMOLLM_PORT,
                            "ring8.q8.k1.b1x128",
                            {"clients": 4, "seq": 16}),
         "mamba2.tiny": ("mamba2-780m-l12", MAMBA2, MAMBA2_PORT,
                         "ring4.q8.k2.b2x512",
                         {"batch": 1, "seq": 256})}
LIMITS = {"loss_gap": 1e-2, "update1_gap": 0.2, "change_gap": 0.2}


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def make(tmp: Path, limits: dict = LIMITS) -> Bench:
    """A ``Bench`` over the tiny cells, in ``tmp``."""
    pb = tmp / "pb"
    for sub in ("metrics", "counts"):
        shutil.copytree(PORTBENCH / sub, pb / sub)
    for sub in ("configs", "mixes", "limits"):
        (pb / sub).mkdir(parents=True)
    spec = _json(ROOT / "BENCHMARK.json")
    spec["configs"], spec["workloads"] = [], []
    for name, (config, cut, port, mix, traffic) in CELLS.items():
        cfg = _json(PORTBENCH / "configs" / f"{config}.json")
        cfg.update(cut)
        cfg["port"] = copy.deepcopy(cfg["port"])
        cfg["port"]["set"].update(port)
        cfg["port"]["expect"].update(port)
        file = pb / "configs" / f"{name}.json"
        file.write_text(json.dumps(cfg))
        spec["configs"].append({"name": name, "source": "tiny",
                                "file": str(file), "reduced": [],
                                "why": "tiny"})
        m = _json(PORTBENCH / "mixes" / f"{mix}.json")
        m.update(traffic)
        m["trace_rounds"] = 2
        (pb / "mixes" / f"{name}.json").write_text(json.dumps(m))
        (pb / "limits" / f"{name}.json").write_text(
            json.dumps({"limits": limits}))
        spec["workloads"].append({"name": name, "config": name,
                                  "traffic": name, "chips": 1,
                                  "why": "tiny"})
    names = list(CELLS)
    for m in spec["end_to_end"] + spec["per_layer"]:
        m["workloads"] = names
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return Bench(tmp, pb)
