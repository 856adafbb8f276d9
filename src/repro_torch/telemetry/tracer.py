"""Wall-clock span tracing -> Chrome trace-event JSON (Perfetto-viewable)
— the JAX package's ``telemetry/tracer.py`` on torch.

:class:`Tracer` wraps a run's HOST-side stages (the cohort's prepare,
the step, the write-back, ...) in ``with tracer.span("pool/step"):``
blocks and serializes them as Chrome ``traceEvents`` — load the saved
file at https://ui.perfetto.dev (or ``chrome://tracing``) to see the
stage timeline. Spans record the REAL thread they ran on, so
:class:`~repro_torch.core.client_pool.PooledRunner`'s prefetch shows up
as two overlapping tracks (the caller thread's ``pool/step`` next to the
worker thread's ``pool/prepare``).

Each span also enters a ``torch.profiler.record_function`` with the same
name: when a ``torch.profiler`` trace is being taken, the host spans land
on its timeline under identical labels, and the round's own stages
carry matching ranges (``round/local_sgd``, ``round/mix``,
``round/telemetry``, ``wire/encode``, ``wire/decode``) — so host trace
and device profile align without a correlation table. A range is a host
marker: it adds no node to a captured CUDA graph.

A disabled tracer (``Tracer(enabled=False)``, the default for every
runner argument) costs one attribute check per span — the hot loops stay
untouched unless tracing is requested.
"""
from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager

from torch.profiler import record_function

__all__ = ["Tracer", "NULL_TRACER"]

_PID = 1  # single-process traces; one pid keeps Perfetto's UI flat


class Tracer:
    """Collects host spans as Chrome trace 'X' (complete) events."""

    def __init__(self, enabled: bool = True, clock=time.perf_counter):
        self.enabled = enabled
        self._clock = clock
        self._t0 = clock()
        self._events: list[dict] = []
        self._lock = threading.Lock()
        self._tids: dict[int, int] = {}

    # -- recording ---------------------------------------------------------

    def _tid(self) -> int:
        """Stable small ints per OS thread, named on first sight so the
        trace viewer shows 'main' / 'prefetch' tracks, not raw idents."""
        ident = threading.get_ident()
        with self._lock:
            tid = self._tids.get(ident)
            if tid is None:
                tid = self._tids[ident] = len(self._tids)
                self._events.append({
                    "ph": "M", "name": "thread_name", "pid": _PID,
                    "tid": tid,
                    "args": {"name": threading.current_thread().name}})
            return tid

    @contextmanager
    def span(self, name: str, **args):
        """Wall-clock span around a host stage. ``args`` land in the
        event's args dict (Perfetto shows them on click)."""
        if not self.enabled:
            yield
            return
        tid = self._tid()
        t0 = self._clock()
        with record_function(name):
            try:
                yield
            finally:
                t1 = self._clock()
                ev = {"ph": "X", "name": name, "pid": _PID, "tid": tid,
                      "ts": (t0 - self._t0) * 1e6,
                      "dur": (t1 - t0) * 1e6}
                if args:
                    ev["args"] = args
                with self._lock:
                    self._events.append(ev)

    def instant(self, name: str, **args) -> None:
        """Zero-duration marker (Chrome 'i' event)."""
        if not self.enabled:
            return
        ev = {"ph": "i", "name": name, "pid": _PID, "tid": self._tid(),
              "ts": (self._clock() - self._t0) * 1e6, "s": "t"}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    # -- export ------------------------------------------------------------

    @property
    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def to_chrome_trace(self) -> dict:
        """The Chrome trace-event JSON object Perfetto loads directly."""
        return {"traceEvents": self.events, "displayTimeUnit": "ms"}

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)

    def durations(self) -> dict[str, float]:
        """Total seconds per span name — the stage-time breakdown the
        report's telemetry mode renders."""
        out: dict[str, float] = {}
        for ev in self.events:
            if ev.get("ph") == "X":
                out[ev["name"]] = out.get(ev["name"], 0.0) \
                    + ev["dur"] / 1e6
        return out


NULL_TRACER = Tracer(enabled=False)
