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
schedule's token is a static buffer too.

No aliasing: the graph writes its outputs to the same device memory on
every replay, so ``run`` hands the caller clones of them. A state the
caller holds never changes under a later call, as in the functional
reference; the clones cost one device copy of the parameters a round.

A replay launches no kernel from the host, so ``native.LAUNCHES`` does
not count it: count a captured round's launches from the graph's kernel
nodes (``graph`` on the returned function).
"""
from __future__ import annotations

from typing import Callable

import torch

from .dfedavgm import RoundState

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


def capture_step(step: Callable, state: RoundState,
                 batches: Params) -> Callable:
    """Capture ``step(state, batches) -> (state', metrics)`` — a
    ``make_round_step``, ``make_fedavg_step`` or ``make_dsgd_step`` round
    — in one CUDA graph, at the shapes and dtypes of ``state`` and
    ``batches``.

    Returns ``run(state, batches) -> (state', metrics)`` with the step's
    contract; ``run.graph`` is the ``torch.cuda.CUDAGraph`` (its
    ``cudaGraph_t`` kept for inspection), ``run.static_batches`` the
    batch buffers (a caller that fills them in place skips the copy) and
    ``run.step`` the step, kept alive with the graph.
    Raises on a CPU state: a CUDA graph needs the card, and the step
    runs eagerly on the CPU as it is.
    """
    dev = next(iter(state.params.values())).device
    if dev.type != "cuda":
        raise ValueError(f"capture_step needs the round on a CUDA device, "
                         f"got {dev}; call the step itself on the CPU")
    params = {n: t.detach().to(dev).clone() for n, t in state.params.items()}
    rng = state.rng.to(dev).clone()
    round_t = torch.full((), state.round, dtype=torch.int64, device=dev)
    token = None if state.token is None else state.token.to(dev).clone()
    static_batches = {n: b.to(dev).clone() for n, b in batches.items()}

    def call():
        return step(RoundState(params=params, rng=rng, round=round_t,
                               token=token), static_batches)

    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(WARMUP):
            call()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        out_state, out_metrics = call()
    graph.instantiate()

    def run(state: RoundState, batches: Params):
        for n, t in state.params.items():
            _load(params[n], t, n)
        _load(rng, state.rng, "rng")
        if token is not None:
            _load(token, state.token, "token")
        for n, b in batches.items():
            _load(static_batches[n], b, n)
        round_t.fill_(state.round)
        graph.replay()
        return (RoundState(params={n: t.clone() for n, t in
                                   out_state.params.items()},
                           rng=out_state.rng.clone(), round=state.round + 1,
                           token=None if token is None
                           else out_state.token.clone()),
                {k: v.clone() for k, v in out_metrics.items()})

    run.graph = graph
    run.static_batches = static_batches
    # The graph reads device tensors the step owns (the mixer's tables,
    # the wire layout's caches): they must live as long as ``run``, even
    # when the caller drops the step.
    run.step = step
    return run
