"""The round as one captured program — the port's counterpart of the
call-site ``jax.jit`` around a round step in the JAX package
(``examples/quickstart.py``, ``benchmarks/common.py``,
``benchmarks/bench_fig6_compare.py``).

``capture_step(step, state, batches)`` runs ``step`` a few times on a side
stream (autograd, cuBLAS and the kernels' first-use builds and caches
warm up there), then captures one call in a CUDA graph over static
device buffers for the parameters, the key and every batch leaf. The
returned ``run(state, batches)`` copies its inputs into those buffers,
replays the graph, and returns ``(state', metrics)`` exactly as the step
does: the key chain, the local steps, the mix and the metrics all run
inside the graph. The step sees the round index as a 0-dim int64 device
buffer that ``run`` fills (a fill kernel, never a copy from the host)
before each replay, so a schedule that reads it (a cycle's member, a
precomputed walk's edge) picks the round's event inside the graph; the
``state.round`` that ``run`` returns stays a host int. A stateful
schedule's token is a static buffer too. An async event step
(``core.async_gossip``) is captured the same way: every field of its
``AsyncRoundState`` gets a buffer, the device event counter included, so
its engine replays one graph an event.

No aliasing: the graph writes its outputs to the same device memory on
every replay, so ``run`` hands the caller clones of them (a round's
``Telemetry`` field by field). A state the caller holds never changes
under a later call, as in the functional reference; the clones cost one
device copy of the parameters a round.

A replay launches no kernel from the host, so ``native.LAUNCHES`` does
not count it: count a captured round's launches from the graph's kernel
nodes (``graph`` on the returned function).

A round on a client mesh whose shards share one card (``make_test_mesh``;
a 2D mesh's cells alike) is captured the same way, every shard's (cell's)
leaves a static buffer, and its transfers are device copies inside the
graph. A mesh over several cards raises: a CUDA graph is captured on one
device's stream.
"""
from __future__ import annotations

import gc
from typing import Callable, NamedTuple

import torch

Params = dict[str, torch.Tensor]

__all__ = ["capture_step"]

WARMUP = 3  # eager calls on the side stream before capture


def _load(dst: torch.Tensor, src: torch.Tensor, name: str) -> None:
    """Copy ``src`` into the static buffer ``dst`` (nothing to do when
    ``src`` is that buffer)."""
    if src.shape != dst.shape or src.dtype != dst.dtype:
        raise ValueError(f"{name}: captured for {dst.dtype} "
                         f"{tuple(dst.shape)}, got {src.dtype} "
                         f"{tuple(src.shape)}")
    if src.data_ptr() != dst.data_ptr():
        dst.copy_(src)


def _buffer(value, dev: torch.device):
    """The static device buffer of one state field: a dict of leaves (a
    list of them on a client mesh), a tensor, None, or a host int (the
    round index: an int64 0-dim buffer that ``run`` fills)."""
    if value is None:
        return None
    if isinstance(value, list):
        return [_buffer(v, dev) for v in value]
    if isinstance(value, dict):
        return {n: t.detach().to(dev).clone() for n, t in value.items()}
    if isinstance(value, torch.Tensor):
        return value.detach().to(dev).clone()
    return torch.full((), value, dtype=torch.int64, device=dev)


def _fill(buf, value, name: str) -> None:
    """Load one state field into its static buffer (see :func:`_buffer`)."""
    if buf is None:
        return
    if isinstance(buf, list):
        for b, v in zip(buf, value):
            _fill(b, v, name)
    elif isinstance(buf, dict):
        for n, t in value.items():
            _load(buf[n], t, n)
    elif isinstance(value, torch.Tensor):
        _load(buf, value, name)
    else:
        buf.fill_(value)


def _out(out, value):
    """A field of the returned state: a clone of the graph's output, or
    for a host-int round index the next host int."""
    if out is None:
        return None
    if isinstance(out, list):
        return [_out(o, v) for o, v in zip(out, value)]
    if isinstance(out, dict):
        return {n: t.clone() for n, t in out.items()}
    if not isinstance(value, torch.Tensor) and not isinstance(value, dict):
        return value + 1
    return out.clone()


def _clone(metric):
    """A fresh copy of one metric the graph wrote: a tensor, or a
    ``Telemetry`` (a NamedTuple of tensors and Nones) field by field."""
    if isinstance(metric, tuple):
        return type(metric)(*(None if f is None else f.clone()
                              for f in metric))
    return metric.clone()


def capture_step(step: Callable, state: NamedTuple,
                 batches: Params | None) -> Callable:
    """Capture ``step(state, batches) -> (state', metrics)`` — a
    ``make_round_step``, ``make_fedavg_step`` or ``make_dsgd_step`` round
    on a ``RoundState``, or an async event (``make_async_round_step``) on
    an ``AsyncRoundState`` — in one CUDA graph, at the shapes and dtypes
    of ``state`` and ``batches`` (None for an event step with a
    ``batch_fn``).

    Every field of the state gets a static buffer (the parameters, the
    key, an async state's clock, next-ready times, versions and clock
    key, a walk's token); ``run`` loads each before a replay. A host-int
    round index is filled into its int64 buffer and comes back as the
    next host int; a device event counter is copied in and its successor
    cloned out.

    Returns ``run(state, batches) -> (state', metrics)`` with the step's
    contract; ``run.graph`` is the ``torch.cuda.CUDAGraph`` (its
    ``cudaGraph_t`` kept for inspection), ``run.static_batches`` the
    batch buffers (a caller that fills them in place skips the copy) and
    ``run.step`` the step, kept alive with the graph.
    Raises on a CPU state: a CUDA graph needs the card, and the step
    runs eagerly on the CPU as it is; raises on a client mesh whose shards
    lie on more than one device.
    """
    shards = (state.params if isinstance(state.params, list)
              else [state.params])
    devs = {t.device for s in shards for t in s.values()}
    dev = next(iter(shards[0].values())).device
    if len(devs) > 1:
        raise ValueError(
            "capture_step captures one device's stream; this state's "
            f"shards lie on {sorted(str(d) for d in devs)} (a mesh over "
            "several cards runs its rounds eagerly)")
    if dev.type != "cuda":
        raise ValueError(f"capture_step needs the round on a CUDA device, "
                         f"got {dev}; call the step itself on the CPU")
    kind = type(state)
    static = {f: _buffer(getattr(state, f), dev) for f in kind._fields}
    static_batches = _buffer(batches, dev)

    def call():
        return step(kind(**static), static_batches)

    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(WARMUP):
            call()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    # No cyclic garbage collection while capturing: a collected object
    # that held a graph of its own (a dropped pooled runner's) would
    # destroy it mid-capture, which invalidates this capture.
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            out_state, out_metrics = call()
    finally:
        if collecting:
            gc.enable()
    graph.instantiate()

    def run(state: NamedTuple, batches: Params | None):
        for f in kind._fields:
            _fill(static[f], getattr(state, f), f)
        _fill(static_batches, batches, "batches")
        graph.replay()
        return (kind(**{f: _out(getattr(out_state, f), getattr(state, f))
                        for f in kind._fields}),
                {k: _clone(v) for k, v in out_metrics.items()})

    run.graph = graph
    run.static_batches = static_batches
    # The graph reads device tensors the step owns (the mixer's tables,
    # the wire layout's caches): they must live as long as ``run``, even
    # when the caller drops the step.
    run.step = step
    return run
