"""Validate telemetry JSONL run logs against the schema — the port's
analogue of the JAX package's ``tools/check_telemetry_schema.py``, with
the same run-shape checks and exit codes.

Every line must parse as JSON and pass
:func:`repro_torch.telemetry.schema.validate_record` — unknown kinds,
missing required fields, wrong types, and unknown fields are all
failures. Also enforces run shape: exactly one ``run_start`` (first line,
current SCHEMA_VERSION), at least one ``round``, and a terminal
``run_end``.

Usage:  python -m repro_torch.telemetry.check_schema run.jsonl...

Exit status 1 lists every offender as ``path:line: problem``; 2 when no
log is named.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

from .schema import SCHEMA_VERSION, validate_record

__all__ = ["check_file", "main"]


def check_file(path: Path) -> list[str]:
    """Every problem of one log as ``path:line: problem`` (empty: valid)."""
    path = Path(path)
    problems = []
    records = []
    for n, line in enumerate(path.read_text().splitlines(), 1):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError as e:
            problems.append(f"{path}:{n}: not JSON ({e})")
            continue
        for err in validate_record(rec):
            problems.append(f"{path}:{n}: {err}")
        records.append((n, rec))
    if not records:
        problems.append(f"{path}:1: empty log")
        return problems
    first = records[0][1]
    if first.get("kind") != "run_start":
        problems.append(f"{path}:{records[0][0]}: first record must be "
                        f"run_start, got {first.get('kind')!r}")
    elif first.get("schema") != SCHEMA_VERSION:
        problems.append(f"{path}:{records[0][0]}: schema version "
                        f"{first.get('schema')!r} != {SCHEMA_VERSION}")
    kinds = [r.get("kind") for _, r in records]
    if "round" not in kinds:
        problems.append(f"{path}:1: no round records")
    if kinds[-1] != "run_end":
        problems.append(f"{path}:{records[-1][0]}: log does not end with "
                        f"run_end (crashed run?)")
    return problems


def main(argv: list[str]) -> int:
    """Check every run log named in ``argv`` against the schema; print each
    problem and return 1 when any, 0 when clean (2 without arguments)."""
    if not argv:
        print(__doc__)
        return 2
    problems = []
    for arg in argv:
        problems.extend(check_file(Path(arg)))
    for p in problems:
        print(p)
    if not problems:
        print(f"OK: {len(argv)} log(s) schema-valid "
              f"(schema v{SCHEMA_VERSION})")
    return 1 if problems else 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
