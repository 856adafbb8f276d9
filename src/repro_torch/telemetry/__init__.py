"""Observability subsystem — the JAX package's ``repro.telemetry`` on
torch: in-graph round metrics, host span tracing, and the structured run
log.

Three independent layers, composable per run:

  * :mod:`repro_torch.telemetry.metrics` — the :class:`Telemetry`
    NamedTuple the round steps emit under ``with_telemetry=True``
    (consensus distance, local drift, realized wire bits, quantizer error
    vs the Assumption-4 bound, staleness histogram, ...): device tensors
    computed inside the round (inside its CUDA graph when captured), with
    no host sync; the off path is the step built without the flag.
  * :mod:`repro_torch.telemetry.tracer` — wall-clock spans over the host
    stages, exported as Chrome trace-event JSON (Perfetto), each also a
    ``torch.profiler.record_function`` range.
  * :mod:`repro_torch.telemetry.schema` / :mod:`repro_torch.telemetry.sink`
    — the JSONL run-log schema (the reference's, field for field) and the
    :class:`RunLog` fan-out (file + console renderer).

``python -m repro_torch.telemetry.check_schema run.jsonl`` checks a log;
``python -m repro_torch.launch.report telemetry --jsonl run.jsonl
[--trace trace.json]`` renders it.
"""
from .metrics import (QUANT_SAMPLE_LANES, Telemetry, client_dim,
                      dropped_edge_count, live_edge_count,
                      quant_round_telemetry, staleness_histogram,
                      telemetry_host, wire_bits_for)
from .schema import SCHEMA_VERSION, validate_record
from .sink import ConsoleRenderer, JsonlSink, RunLog
from .tracer import NULL_TRACER, Tracer

__all__ = [
    "QUANT_SAMPLE_LANES", "Telemetry", "client_dim", "dropped_edge_count",
    "live_edge_count",
    "quant_round_telemetry", "staleness_histogram", "telemetry_host",
    "wire_bits_for",
    "SCHEMA_VERSION", "validate_record",
    "ConsoleRenderer", "JsonlSink", "RunLog",
    "NULL_TRACER", "Tracer",
]
