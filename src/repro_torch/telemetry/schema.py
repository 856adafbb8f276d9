"""The structured run log's record schema (JSONL, one record per line) —
a copy of the JAX package's ``telemetry/schema.py``, field for field, so a
log either package writes is valid under the other.

Every record is a flat JSON object with a ``kind`` discriminator. The
schema is STRICT both ways: a record must carry every required field of
its kind, with the declared type, and may not carry fields the kind does
not declare — so a typo'd metric name fails
:mod:`repro_torch.telemetry.check_schema` instead of silently vanishing
from dashboards. Bump :data:`SCHEMA_VERSION` when a kind gains/loses fields;
the version rides every ``run_start`` record.

Kinds:

  run_start  — one per run: schema version, wall-clock origin, the CLI /
               config dict the run was launched with.
  info       — free-form one-liners (topology banner, backend choice);
               the console renderer prints ``msg`` verbatim.
  round      — one per round (sync) or event (async): required ``t`` /
               ``loss`` / ``wall_s``, plus whichever optional metric
               fields the execution mode produces (per-field definitions
               in :mod:`repro_torch.telemetry.metrics`).
  run_end    — one per run: totals the summary renderer reads.
"""
from __future__ import annotations

from typing import Any

__all__ = ["SCHEMA_VERSION", "RECORD_FIELDS", "validate_record",
           "require_valid"]

SCHEMA_VERSION = 1

_NUM = (int, float)
_INT = (int,)
_STR = (str,)
_DICT = (dict,)
_LIST = (list,)

# kind -> {field: (allowed python types, required)}
RECORD_FIELDS: dict[str, dict[str, tuple[tuple, bool]]] = {
    "run_start": {
        "schema": (_INT, True),
        "time": (_NUM, True),        # epoch seconds of the run origin
        "config": (_DICT, True),     # launch args / hyper-parameters
    },
    "info": {
        "msg": (_STR, True),
    },
    "round": {
        "t": (_INT, True),           # round (sync) / event (async) index
        "loss": (_NUM, True),        # participation-weighted mean loss
        "wall_s": (_NUM, True),      # host seconds since run_start
        # -- shared optional metrics --------------------------------------
        "consensus_dist": (_NUM, False),   # Lemma 4 LHS over x^{t+1}
        "local_drift": (_NUM, False),      # same functional over z^t
        "active_frac": (_NUM, False),      # realized participation rate
        "live_edges": (_NUM, False),       # realized live directed edges
        "wire_bits": (_NUM, False),        # message_bits * live_edges
        "comm_bits": (_NUM, False),        # CommLedger cumulative bill
        # sparse backend: boundary wire lane slots of the (possibly
        # placed) block realization — compile-time constant per run
        "placement_boundary_lanes": (_NUM, False),
        # -- codec-path telemetry (quantized rounds) ----------------------
        "quant_err_sq": (_NUM, False),     # mean_i ||Q(d_i) - d_i||^2
        "quant_bound": (_NUM, False),      # Assumption-4 d/4 * s^2 bound
        "quant_sat_frac": (_NUM, False),   # codes pinned at qmin/qmax
        # -- async engine --------------------------------------------------
        "clock": (_NUM, False),            # virtual time of the event
        "ready_frac": (_NUM, False),
        "mean_staleness": (_NUM, False),
        "max_staleness": (_NUM, False),
        "staleness_hist": (_LIST, False),  # [max_staleness + 2] lag counts
        "dropped_edges": (_NUM, False),    # hard-cutoff zeroed live edges
        # -- virtual client pool -------------------------------------------
        "cohort_size": (_NUM, False),
        "pool_hit": (_NUM, False),         # cohort rows already on a slab
        "pool_miss": (_NUM, False),        # cohort rows read from template
        "pool_materialized": (_NUM, False),
        "pool_mbytes": (_NUM, False),
    },
    "run_end": {
        "rounds": (_INT, True),
        "wall_s": (_NUM, True),
        "comm_bits": (_NUM, False),
        "final_loss": (_NUM, False),
        "final_consensus_dist": (_NUM, False),
    },
}


def validate_record(rec: Any) -> list[str]:
    """All schema violations of one decoded record (empty list == valid)."""
    if not isinstance(rec, dict):
        return [f"record is {type(rec).__name__}, expected object"]
    kind = rec.get("kind")
    if kind not in RECORD_FIELDS:
        return [f"unknown record kind {kind!r} "
                f"(allowed: {sorted(RECORD_FIELDS)})"]
    fields = RECORD_FIELDS[kind]
    errs = []
    for name, (types, required) in fields.items():
        if name not in rec:
            if required:
                errs.append(f"{kind}: missing required field {name!r}")
            continue
        val = rec[name]
        # bool passes isinstance(..., int); no field is boolean-typed.
        if isinstance(val, bool) or not isinstance(val, types):
            want = "/".join(t.__name__ for t in types)
            errs.append(f"{kind}.{name}: expected {want}, "
                        f"got {type(val).__name__}")
    for name in rec:
        if name != "kind" and name not in fields:
            errs.append(f"{kind}: unknown field {name!r}")
    return errs


def require_valid(rec: Any) -> None:
    """Raise ``ValueError`` on the first invalid record (the sink calls
    this so a malformed emit fails at the call site, not in a later
    check)."""
    errs = validate_record(rec)
    if errs:
        raise ValueError("invalid telemetry record: " + "; ".join(errs))
