"""Shared helpers of the port's bench harness — the counterpart of the
JAX package's ``benchmarks/common.py``.

Every bench module exposes ``run(*, smoke, device) -> list[tuple[name,
us_per_call, derived]]``; ``repro_torch.bench.run`` prints them as the
CSV ``name,us_per_call,derived``. ``us_per_call`` is the host-clock time
of one round, ended by a synchronize, on the device the bench ran on:
on the card a number of the card, on the CPU one of the CPU. On the card
each round is one replay of a captured CUDA graph (``capture_step``, the
counterpart of the reference's ``jax.jit``); the capture, like the
reference's compile, is set-up and is timed apart (``capture_s``).
"""
from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from .. import prng
from ..core import (DFedAvgMConfig, MixingSpec, QuantConfig, average_params,
                    capture_step, init_round_state, make_round_step)
from ..data import FederatedDataset, classification_dataset
from ..device import resolve_device
from ..models.paper_nets import (apply_2nn, apply_charlstm, apply_cnn,
                                 init_2nn, softmax_xent)

Params = dict[str, torch.Tensor]


def sync(device=None) -> None:
    """Wait for the card's work on ``device`` (nothing to wait for on the
    CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn, *args, warmup: int = 1, iters: int = 5,
          device=None) -> float:
    """Median wall time per call in microseconds, each call ended by a
    synchronize of ``device`` (CUDA unless ``"cpu"``)."""
    for _ in range(warmup):
        fn(*args)
    sync(device)
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        sync(device)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts) * 1e6)


def timeit_best(body, carry=None, *, iters: int = 1, reps: int = 3,
                warmup: int = 0, device=None, tracer=None,
                label: str = "timeit"):
    """Best-of-``reps`` wall time of a stateful loop body, as the
    reference's ``timeit_best``: ``body(i, carry) -> carry`` with a global
    call index ``i``; each rep times ``iters`` calls ended by a
    synchronize of ``device``. ``tracer`` (a
    :class:`~repro_torch.telemetry.Tracer`) wraps each rep in a ``label``
    span. Returns ``(best_us_per_call, carry)``."""
    if tracer is None:
        from ..telemetry import NULL_TRACER as tracer
    i = 0
    for _ in range(warmup):
        carry = body(i, carry)
        i += 1
    sync(device)
    best = float("inf")
    for rep in range(reps):
        with tracer.span(label, rep=rep, iters=iters):
            t0 = time.perf_counter()
            for _ in range(iters):
                carry = body(i, carry)
                i += 1
            sync(device)
            best = min(best, (time.perf_counter() - t0) / iters * 1e6)
    return best, carry


def loss_2nn(p, batch, rng):
    """The 2NN's per-client softmax cross-entropy [m] of a batch ``{"x", "y"}``
    (``rng`` unused), the round's loss."""
    return softmax_xent(apply_2nn(p, batch["x"]), batch["y"])


def acc_2nn(params: Params, data) -> float:
    """Accuracy of one (unstacked) 2NN on the whole dataset."""
    dev = next(iter(params.values())).device
    with torch.no_grad():
        pred = apply_2nn(params, torch.from_numpy(data.x).to(dev)).argmax(-1)
        return float((pred == torch.from_numpy(data.y).to(dev))
                     .to(torch.float32).mean())


def stacked(p0: Params, m: int) -> Params:
    """m client copies of one model's parameters, leaves [m, ...]."""
    return {n: t.unsqueeze(0).expand((m,) + t.shape).contiguous()
            for n, t in p0.items()}


def stacked_2nn(m: int, seed: int, device) -> Params:
    """m copies of the 2NN drawn from ``prng.PRNGKey(seed)``, as the
    reference's benches draw ``init_2nn(jax.random.PRNGKey(seed))``."""
    return stacked(init_2nn(seed, device=device), m)


def loss_cnn(p, batch, rng):
    """The paper CNN's per-client softmax cross-entropy [m] of a batch ``{"x",
    "y"}`` (``rng`` unused), the round's loss."""
    return softmax_xent(apply_cnn(p, batch["x"]), batch["y"])


def acc_cnn(params: Params, x, y) -> float:
    """Accuracy of one (unstacked) CNN on NHWC images ``x`` (numpy)."""
    dev = next(iter(params.values())).device
    with torch.no_grad():
        pred = apply_cnn(params, torch.from_numpy(x).to(dev)).argmax(-1)
        return float((pred == torch.from_numpy(y).to(dev))
                     .to(torch.float32).mean())


def loss_charlm(p, batch, rng):
    """Next-character loss of the CharLSTM on ``batch["t"]`` [m, B, L+1]:
    the mean over batch and time, as the reference's ``softmax_xent`` of
    [B, L] logits."""
    t = batch["t"]
    logits = apply_charlstm(p, t[..., :-1])
    return softmax_xent(logits.flatten(-3, -2), t[..., 1:].flatten(-2))


def run_rounds(step: Callable, state, batch_of: Callable[[int], Params],
               rounds: int, *, capture: bool = True) -> dict:
    """``rounds`` rounds of ``step`` from ``state``, round t on
    ``batch_of(t)`` (numpy draws on the host, handed over as CPU
    tensors). On the card the step is captured first (``capture_step``)
    unless ``capture`` is False; on the CPU it runs eagerly. Returns the
    final state and metrics, the first round's loss, the host-clock
    microseconds a round, the capture's seconds and the captured
    ``CUDAGraph`` (None when eager)."""
    dev = next(iter(state.params.values())).device
    captured = capture and dev.type == "cuda"
    capture_s = 0.0
    if captured:
        t0 = time.perf_counter()
        step = capture_step(step, state, batch_of(0))
        sync(dev)
        capture_s = time.perf_counter() - t0
    sync(dev)
    t0 = time.perf_counter()
    for t in range(rounds):
        b = batch_of(t)
        if not captured:          # the graph copies into its own buffers
            b = {n: x.to(dev) for n, x in b.items()}
        state, mt = step(state, b)
        if t == 0:
            first_loss = mt["loss"]
    sync(dev)
    wall = time.perf_counter() - t0
    return {"state": state, "metrics": mt, "first_loss": float(first_loss),
            "us_per_round": wall / rounds * 1e6, "capture_s": capture_s,
            "captured": captured, "graph": step.graph if captured else None}


def train_dfedavgm_2nn(*, m=16, K=4, batch=32, rounds=40, eta=0.05,
                       theta=0.9, bits=32, iid=True, data=None,
                       self_weight=0.5, seed=0, mixer="dense",
                       topology=None, return_state=False, device=None,
                       capture=True):
    """DFedAvgM on the 2NN, the reference's ``train_dfedavgm_2nn`` with
    its defaults; ``device`` (CUDA unless ``"cpu"``) and ``capture``
    (on the card: each round one graph replay) are the port's.
    ``topology`` overrides the default ring: a static MixingSpec or a
    TopologySchedule (time-varying gossip)."""
    dev = resolve_device(device)
    data = data if data is not None else classification_dataset(n=8000,
                                                                seed=0)
    fed = FederatedDataset.make(data, m, iid=iid, seed=seed)
    q = QuantConfig(bits=bits) if bits < 32 else None
    spec = (topology if topology is not None
            else MixingSpec.ring(m, self_weight=self_weight))
    step = make_round_step(loss_2nn, DFedAvgMConfig(
        eta=eta, theta=theta, local_steps=K, quant=q, mixer_impl=mixer),
        spec, device=dev)
    st = init_round_state(stacked_2nn(m, seed, dev), prng.PRNGKey(seed + 1))
    r = run_rounds(step, st, lambda t: fed.round_batches(
        t, K=K, batch=batch, seed=seed, device="cpu"), rounds,
        capture=capture)
    st, mt = r["state"], r["metrics"]
    out = {
        "acc": acc_2nn(average_params(st.params), data),
        "loss": float(mt["loss"]),
        "first_loss": r["first_loss"],
        "consensus_dist": float(mt["consensus_dist"]),
        "us_per_round": r["us_per_round"],
        "capture_s": r["capture_s"],
        "captured": r["captured"],
        "graph": r["graph"],
        "spec": spec,
        "d": sum(t.numel() for t in st.params.values()) // m,
    }
    if return_state:
        out["state"] = st
    return out
