"""Render run reports — the JAX package's ``launch/report.py``.

Two modes (the positional argument, ``roofline`` the default as in the
reference):

  telemetry  summarize a run from its structured telemetry artifacts (a
             JSONL run log written through ``RunLog`` and, optionally, a
             Chrome trace saved by ``Tracer``):
               python -m repro_torch.launch.report telemetry \\
                   --jsonl run.jsonl [--trace trace.json]
             Loss trajectory, realized wire vs billed bits, quantizer
             error vs the Assumption-4 bound, staleness P50/P99, and the
             host-stage wall-time breakdown from the trace. Every record
             is validated against the schema on the way in.
  roofline   the roofline table from the dry-run's records
             (``experiments/dryrun_torch/*.json``, written by
             ``python -m repro_torch.launch.dryrun``):
               python -m repro_torch.launch.report \\
                   [--tag baseline] [--mesh 16x16]
             A null collective term (``launch.dryrun``) shows as a dash;
             the note column gives the structural evaluation's seconds
             (a record with the reference's ``compile_s`` shows that).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

__all__ = ["load", "markdown_table", "telemetry_report", "main"]

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"


def load(tag: str | None = None, mesh: str | None = None) -> list[dict]:
    """The dry-run records under ``OUT_DIR``, filtered by tag and mesh."""
    recs = []
    for f in sorted(OUT_DIR.glob("*.json")):
        r = json.loads(f.read_text())
        if tag and r.get("tag") != tag:
            continue
        if mesh and r.get("mesh") != mesh:
            continue
        recs.append(r)
    return recs


def fmt_ms(s: float | None) -> str:
    """Seconds as milliseconds with one decimal, a dash for None."""
    return "—" if s is None else f"{s*1e3:.1f}"


def markdown_table(recs: list[dict]) -> str:
    """The dry-run records as a markdown table: each row's three terms, the
    dominant one, the useful-FLOPs ratio and wire bytes a device (a skipped row
    its reason)."""
    hdr = ("| arch | shape | mesh | tag | compute ms | memory ms | "
           "collective ms | dominant | useful | wire GB/dev | note |")
    sep = "|" + "---|" * 11
    lines = [hdr, sep]
    for r in recs:
        if r.get("skipped"):
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                f"{r.get('tag','')} | — | — | — | — | — | — | "
                f"SKIP: {r['skipped'][:60]} |")
            continue
        t = r["roofline"]
        uf = r.get("useful_flops_ratio")
        coll = r.get("collective_looped")
        wire = "—" if coll is None else f"{coll['wire_bytes'] / 1e9:.2f}"
        note = (f"compile {r['compile_s']}s" if "compile_s" in r
                else f"struct {r.get('struct_s')}s")
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['tag']} | "
            f"{fmt_ms(t['compute_s'])} | {fmt_ms(t['memory_s'])} | "
            f"{fmt_ms(t['collective_s'])} | {r['dominant'][:-2]} | "
            f"{uf and round(uf, 2)} | {wire} | {note} |")
    return "\n".join(lines)


def _percentile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile on a pre-sorted list."""
    if not sorted_vals:
        return float("nan")
    i = min(len(sorted_vals) - 1,
            max(0, int(round(q / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[i]


def telemetry_report(jsonl_path, trace_path=None) -> str:
    """Human-readable run summary from the JSONL log (+ optional trace).

    Validates every record against the schema on the way in, so a report
    doubles as a log check.
    """
    from ..telemetry.schema import require_valid

    recs = []
    with open(jsonl_path) as f:
        for line in f:
            rec = json.loads(line)
            require_valid(rec)
            recs.append(rec)
    rounds = [r for r in recs if r["kind"] == "round"]
    end = next((r for r in recs if r["kind"] == "run_end"), None)
    lines = [f"telemetry report: {jsonl_path} ({len(rounds)} rounds)"]

    if rounds:
        losses = [r["loss"] for r in rounds]
        lines.append(f"  loss: first={losses[0]:.4f} last={losses[-1]:.4f} "
                     f"min={min(losses):.4f}")
        cds = [r["consensus_dist"] for r in rounds if "consensus_dist" in r]
        if cds:
            lines.append(f"  consensus_dist: first={cds[0]:.3e} "
                         f"last={cds[-1]:.3e}")
        wire = sum(r.get("wire_bits", 0.0) for r in rounds)
        if wire:
            lines.append(f"  wire (realized): {wire/8/2**20:.1f}MB over "
                         f"{sum(r.get('live_edges', 0) for r in rounds):.0f}"
                         f" live directed edges")
        billed = (end or {}).get("comm_bits") or (
            rounds[-1].get("comm_bits") if rounds else None)
        if billed:
            lines.append(f"  comm (billed): {billed/8/2**20:.1f}MB"
                         + (f" (realized/billed = {wire/billed:.3f})"
                            if wire else ""))
        pbl = [r["placement_boundary_lanes"] for r in rounds
               if "placement_boundary_lanes" in r]
        if pbl:
            lines.append(f"  placement: {pbl[-1]:.0f} boundary wire lane "
                         f"slots per round (compile-time block cut)")
        qe = [(r["quant_err_sq"], r["quant_bound"]) for r in rounds
              if "quant_err_sq" in r and "quant_bound" in r]
        if qe:
            worst = max((e / b if b else 0.0) for e, b in qe)
            lines.append(f"  quant: observed err <= {worst:.3f}x the "
                         f"Assumption-4 bound (worst round)")
        stale = []
        for r in rounds:
            for lag, count in enumerate(r.get("staleness_hist", [])):
                stale.extend([lag] * int(count))
        if stale:
            stale.sort()
            lines.append(f"  staleness: P50={_percentile(stale, 50):.0f} "
                         f"P99={_percentile(stale, 99):.0f} "
                         f"max={stale[-1]}")
        drops = sum(r.get("dropped_edges", 0.0) for r in rounds)
        if drops:
            lines.append(f"  staleness cutoff dropped {drops:.0f} edges")
    if end:
        lines.append(f"  wall: {end['wall_s']:.1f}s for {end['rounds']} "
                     f"rounds")

    if trace_path:
        tr = json.loads(Path(trace_path).read_text())
        totals: dict[str, float] = {}
        for ev in tr.get("traceEvents", []):
            if ev.get("ph") == "X":
                totals[ev["name"]] = (totals.get(ev["name"], 0.0)
                                      + ev["dur"] / 1e6)
        if totals:
            lines.append("  stage breakdown (host wall, from trace):")
            width = max(len(n) for n in totals)
            for name, s in sorted(totals.items(), key=lambda kv: -kv[1]):
                lines.append(f"    {name:<{width}}  {s:8.3f}s")
    return "\n".join(lines)


def main(argv=None):
    """The report's command line: the roofline table of the dry-run records, or
    a telemetry run log's summary (``--jsonl``, ``--trace``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", nargs="?", default="roofline",
                    choices=["roofline", "telemetry"])
    ap.add_argument("--tag", default=None)
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--jsonl", default=None,
                    help="telemetry mode: the run's JSONL log")
    ap.add_argument("--trace", default=None,
                    help="telemetry mode: the run's Chrome trace")
    args = ap.parse_args(argv)
    if args.mode == "telemetry":
        if not args.jsonl:
            ap.error("telemetry mode needs --jsonl")
        print(telemetry_report(args.jsonl, args.trace))
    else:
        print(markdown_table(load(args.tag, args.mesh)))


if __name__ == "__main__":
    main()
