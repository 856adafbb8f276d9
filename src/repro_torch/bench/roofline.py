"""Roofline table — the reference's ``benchmarks/bench_roofline.py`` on the
port: one row per (arch x shape x mesh x tag) from the dry-run's records
(``experiments/dryrun_torch/*.json``, written by ``python -m
repro_torch.launch.dryrun``), plus the fused-round bytes-moved over
bytes-minimum rows from the ``fused`` entry of the port's gossip bench
JSON (``bench.timevarying.GOSSIP_JSON``). It never reads the reference's
outputs. A record whose collective term is null (``launch.dryrun``) shows
``n=null``."""
from __future__ import annotations

import json
from pathlib import Path

from . import timevarying

OUT = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"


def _ms(s) -> str:
    return "null" if s is None else f"{s * 1e3:.1f}ms"


def _fused_rows():
    """Round-level memory roofline: structural bytes moved per round over
    the paper-minimum bill (K x (3 reads + 2 writes) of N + realized
    wire), for the fused and unfused rounds, and the tail's kernel
    bytes."""
    gossip = timevarying.GOSSIP_JSON
    if not gossip.exists():
        return []
    fz = json.loads(gossip.read_text()).get("fused")
    if not fz:
        return []
    rows = []
    for arm in ("unfused", "fused"):
        a = fz[arm]
        rows.append((
            f"roofline/round_{arm}_b{fz['bits']}",
            a["roofline_ratio"],
            f"bytes_moved={a['bytes_moved_per_round']:.3e};"
            f"bytes_min={fz['bytes_min_per_round']:.3e};"
            f"us={a['us_per_round']:.1f}"))
    tk = fz["tail_kernel_bytes"]
    rows.append((
        "roofline/round_tail_kernels_fused_vs_unfused",
        tk["fused"],
        f"unfused_bytes={tk['unfused']:.3e};"
        f"saved_frac={fz['tail_kernel_bytes_saved_frac']:.3f}"))
    return rows


def run(*, smoke: bool = False, device=None):
    """The rows; ``smoke`` and ``device`` are the runner's and change
    nothing (the table only reads records)."""
    del smoke, device
    rows = _fused_rows()
    if not OUT.exists():
        return rows + [("roofline/no-dryrun-data", 0.0,
                        "run: python -m repro_torch.launch.dryrun")]
    for f in sorted(OUT.glob("*.json")):
        rec = json.loads(f.read_text())
        name = f"roofline/{rec['arch']}/{rec['shape']}/{rec['mesh']}/" \
               f"{rec.get('tag', 'baseline')}"
        if rec.get("skipped"):
            rows.append((name, 0.0, "skipped=" + rec["skipped"][:40]))
            continue
        t = rec["roofline"]
        uf = rec["useful_flops_ratio"]
        rows.append((name, t[rec["dominant"]] * 1e6,
                     f"dom={rec['dominant'][:-2]};"
                     f"c={_ms(t['compute_s'])};"
                     f"m={_ms(t['memory_s'])};"
                     f"n={_ms(t['collective_s'])};"
                     f"useful={uf and round(uf, 2)}"))
    return rows
