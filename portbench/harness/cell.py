"""One run of a cell: set-up, the measured window, the comparison, the
result line.

Set-up: the inputs from the seed, the program's round built and captured
(its warm-ups compile and load every kernel), then the first
``check.CHECK_ROUNDS`` rounds through the window's own call and feed on
batches that all differ; the program's losses and each leaf's change are
kept for the comparison. The window runs the same object on: closed
loop, each round from handing in its batch to a synchronize after
``run`` returns, until ``seconds`` have passed. With tracing, the
profiler covers ``trace_rounds`` whole rounds from 40 % of the window on.
After the window: the memory peak is read, the program's state freed,
and the reference works the check rounds out again from the same
inputs.
"""
from __future__ import annotations

import gc
import math
import subprocess
import sys
import time
from contextlib import nullcontext
from types import SimpleNamespace

import torch
from torch.profiler import record_function

from .. import reference
from ..reference import dfedavgm as ref_round
from . import check, inputs, program, trace, yardstick

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
TRACE_FROM = 0.4     # share of the window before the profiled rounds


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (the part before the first dot,
    compared whole) is the JAX package, JAX or the JAX-era harness."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


class Cell:
    """A cell's configuration, mix and counts, and the port's architecture
    and leaves for it."""

    def __init__(self, bench, name: str, device):
        self.spec = bench.cell(name)
        self.config = bench.config(self.spec)
        self.mix = bench.mix(self.spec)
        self.device = torch.device(device)
        self.counts = yardstick.counts(bench.counts(self.config["family"]),
                                       self.config, self.mix)
        self.arch = program.arch_config(self.config)
        self.shapes = program.leaf_shapes(self.arch)

    def weights(self, seed: int) -> dict:
        return inputs.weights(self.shapes, self.config["init"], seed,
                              self.mix["clients"], self.device)

    def batches(self, seed: int) -> inputs.Batches:
        return inputs.Batches(seed, self.mix, self.config["vocab_ids"],
                              self.device)

    def reference(self, seed: int, batches: list, **variant) -> dict:
        """The reference's check rounds from the seed's inputs."""
        W = ref_round.ring(self.mix["clients"], self.mix["self_weight"])
        return ref_round.rounds(
            self.weights(seed), batches,
            inputs.round_key(seed, self.device),
            family=reference.family(self.config["family"]), cfg=self.config,
            eta=self.mix["eta"], theta=self.mix["theta"], W=W,
            bits=self.mix["bits"], **variant)


def check_rounds(run, x0: dict, key: torch.Tensor, data, n: int):
    """The first ``n`` rounds from x0 through ``run``. Returns (state, the
    program's readings, the batches)."""
    state = program.initial_state(x0, key)
    losses, update1, batches = [], None, []
    for t in range(n):
        batches.append(data.next())
        state, met = run(state, batches[-1])
        losses.append(float(met["loss"]))
        if t == 0:
            update1 = ref_round.norms(state.params, x0)
    return state, {"losses": losses, "update1": update1,
                   "change": ref_round.norms(state.params, x0)}, batches


def window(run, state, data, seconds: float, traced: bool,
           trace_rounds: int):
    """The measured window. Returns (state, each round's seconds, the
    window's seconds, each round's loss tensor, the profiled stretch or
    None)."""
    span = record_function if traced else (lambda name: nullcontext())
    prof, profiled, stretch = None, 0, None
    times, losses = [], []
    sync = torch.cuda.synchronize if state.rng.is_cuda else (lambda: None)
    begin = time.perf_counter()
    while True:
        if (traced and prof is None and stretch is None
                and time.perf_counter() - begin >= TRACE_FROM * seconds):
            prof = trace.profiler()
            prof.start()
        with span("round/batch"):
            batch = data.next()
        t0 = time.perf_counter()
        with span("round/run"):
            state, met = run(state, batch)
        with span("round/sync"):
            sync()
        t1 = time.perf_counter()
        times.append(t1 - t0)
        losses.append(met["loss"])
        if prof is not None:
            profiled += 1
            if profiled == trace_rounds:
                prof.stop()
                stretch = trace.Trace(
                    profiled, prof.profiler.kineto_results.events())
                prof = None
        if t1 - begin >= seconds and (not traced or stretch is not None):
            return state, times, t1 - begin, losses, stretch


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def run_cell(bench, name: str, seed: int, seconds: float, traced: bool,
             device, t_start: float) -> tuple[dict, list, list]:
    """One run (module docstring). Returns (the result line's object,
    notes for standard error, the compared numbers as its last lines)."""
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    stages = {"imports": time.perf_counter() - t_start}

    def stage(label):
        sync()
        stages[label] = time.perf_counter() - t_start - sum(stages.values())

    cell = Cell(bench, name, device)
    mix = cell.mix
    x0 = cell.weights(seed)
    key = inputs.round_key(seed, cell.device)
    data = cell.batches(seed)
    stage("inputs")
    step = program.build_step(cell.arch, mix, cell.device)
    first = data.next()
    run = program.capture(step, program.initial_state(x0, key), first)
    stage("build_and_capture")
    state, prog, check_batches = check_rounds(run, x0, key, data,
                                              check.CHECK_ROUNDS)
    del x0
    stage("check_rounds")
    setup_s = time.perf_counter() - t_start

    state, times, window_s, losses, stretch = window(
        run, state, data, seconds, traced, mix["trace_rounds"])
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    losses = [float(v) for v in losses]
    del run, step, state, data, first
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = cell.reference(seed, check_batches)
    ref_s = time.perf_counter() - t_ref
    nums = check.numbers(prog, ref)
    failed = sum(not math.isfinite(v) for v in losses)
    ok, shown = check.judge(nums, bench.limits(cell.spec))

    readings = SimpleNamespace(
        counts=cell.counts, mix=mix, config=cell.config, setup_s=setup_s,
        round_s=times, window_s=window_s, peak_bytes=peak, trace=stretch)
    metrics = {}
    for m in bench.metrics(cell.spec, traced):
        value = bench.reader(m["name"])(readings)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.spec["chips"], "memory_peak_bytes": peak,
           "power_limit": power_limit() if cuda else None}
    result = {"correct": ok and failed == 0, "attempted": len(losses),
              "failed": failed, "metrics": metrics, "device": dev}
    if stretch is not None:
        dev["busy_s"] = stretch.busy_s
        dev["window_s"] = stretch.window_s
        result["breakdown"] = stretch.breakdown()
    result["checked"] = shown
    notes = [f"rounds {len(losses)} in {window_s:.6f} s, set-up "
             f"{setup_s:.6f} s {stages}, reference {ref_s:.3f} s, "
             f"program losses {prog['losses']}, reference "
             f"{ref['losses']}, numbers {nums}"]
    if stretch is not None:
        notes.append(f"traced {stretch.rounds} rounds: {stretch.device_ops} "
                     f"device ops, idle by span {stretch.idle_by_span()}, "
                     f"device s by group {stretch.group_s}")
    lines = [f"checked {k} {v['value']!r} limit {v['limit']!r}"
             for k, v in shown.items()]
    return result, notes, lines
