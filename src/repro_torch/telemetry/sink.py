"""Structured run-log sinks: JSONL file + the console renderer — the JAX
package's ``telemetry/sink.py``, record for record (same fields, same
order, same console lines).

:class:`RunLog` is the single emission point the training drivers use —
every record fans out to the JSONL sink (``--log-jsonl``) and to the
console renderer (the old ``print`` lines, now a THIN VIEW over the same
records, so the file and the terminal can never disagree). Records are
validated against :mod:`repro_torch.telemetry.schema` at emit time.
"""
from __future__ import annotations

import json
import sys
import time
from typing import Any, IO

from .schema import SCHEMA_VERSION, require_valid

__all__ = ["JsonlSink", "ConsoleRenderer", "RunLog"]


class JsonlSink:
    """Append-only JSONL writer; one validated record per line, flushed
    eagerly so a crashed run still leaves a readable log."""

    def __init__(self, path):
        self.path = path
        self._f: IO | None = open(path, "w")

    def emit(self, rec: dict) -> None:
        if self._f is None:
            raise ValueError(f"sink {self.path} is closed")
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class ConsoleRenderer:
    """Renders records as the driver's historical one-line prints.

    ``round`` records print every field that is present, in a stable
    order, so the resident / async / pooled modes keep their familiar
    console shapes without bespoke format strings at each call site.
    """

    def __init__(self, stream: IO | None = None):
        self.stream = stream if stream is not None else sys.stdout

    def emit(self, rec: dict) -> None:
        kind = rec["kind"]
        if kind == "info":
            print(rec["msg"], file=self.stream)
        elif kind == "round":
            print(self._round_line(rec), file=self.stream)
        elif kind == "run_end":
            bits = rec.get("comm_bits")
            comm = f" comm={bits / 8 / 2**20:.1f}MB" if bits else ""
            print(f"done; {rec['rounds']} rounds in "
                  f"{rec['wall_s']:.1f}s{comm}", file=self.stream)
        # run_start is file-only: the console already saw the banner.

    @staticmethod
    def _round_line(rec: dict) -> str:
        parts = [f"round {rec['t']:4d} loss={rec['loss']:.4f}"]
        if "consensus_dist" in rec:
            parts.append(f"consensus={rec['consensus_dist']:.3e}")
        if "clock" in rec:
            parts.append(f"clock={rec['clock']:.2f}")
        if "ready_frac" in rec:
            parts.append(f"ready={rec['ready_frac']:.2f}")
        if "quant_err_sq" in rec and "quant_bound" in rec:
            parts.append(f"qerr={rec['quant_err_sq']:.3e}"
                         f"/{rec['quant_bound']:.3e}")
        if "pool_materialized" in rec:
            parts.append(f"pool={rec['pool_materialized']} rows")
        if "pool_mbytes" in rec:
            parts.append(f"({rec['pool_mbytes']:.1f}MB host)")
        if "comm_bits" in rec:
            parts.append(f"comm={rec['comm_bits'] / 8 / 2**20:.1f}MB")
        parts.append(f"({rec['wall_s']:.1f}s)")
        return " ".join(parts)


class RunLog:
    """Fan-out run log: ``.start`` / ``.info`` / ``.round`` / ``.end``.

    ``jsonl`` (a path) attaches a :class:`JsonlSink`; ``console=True``
    attaches a :class:`ConsoleRenderer`. ``round(..., console=False)``
    records to the file but skips the terminal — the drivers emit EVERY
    round to the JSONL log while keeping the historical sparse print
    cadence. ``wall_s`` is stamped automatically from the ``start`` call.
    """

    def __init__(self, jsonl=None, console: bool = True,
                 stream: IO | None = None):
        self.jsonl = jsonl or None
        self._sinks: list = []
        self._console = ConsoleRenderer(stream) if console else None
        if jsonl:
            self._sinks.append(JsonlSink(jsonl))
        self._t0 = time.time()

    # -- emission ----------------------------------------------------------

    def _emit(self, rec: dict, console: bool = True) -> None:
        require_valid(rec)
        for s in self._sinks:
            s.emit(rec)
        if console and self._console is not None:
            self._console.emit(rec)

    def start(self, config: dict | None = None) -> None:
        self._t0 = time.time()
        self._emit({"kind": "run_start", "schema": SCHEMA_VERSION,
                    "time": self._t0, "config": config or {}})

    def info(self, msg: str) -> None:
        self._emit({"kind": "info", "msg": msg})

    def round(self, t: int, loss: float, console: bool = True,
              **fields: Any) -> None:
        rec = {"kind": "round", "t": int(t), "loss": float(loss),
               "wall_s": time.time() - self._t0}
        rec.update({k: v for k, v in fields.items() if v is not None})
        self._emit(rec, console=console)

    def end(self, rounds: int, **fields: Any) -> None:
        rec = {"kind": "run_end", "rounds": int(rounds),
               "wall_s": time.time() - self._t0}
        rec.update({k: v for k, v in fields.items() if v is not None})
        self._emit(rec)

    def close(self) -> None:
        for s in self._sinks:
            s.close()

    def __enter__(self) -> "RunLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
