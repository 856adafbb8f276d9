"""Async against sync gossip under a straggler tail: virtual wall-clock to
a target loss — the reference's ``benchmarks/bench_async.py`` on the
port (a module may not be named ``async``).

Both arms train the 2NN on the synthetic task over an edge-sampled ring
(m 8, p 0.7, the dense fp32 mixer) with the same straggler speed model
(one client 10x slower). The synchronous arm pays ``max_i duration_i`` a
round (its virtual clock draws from ``fold_in(PRNGKey(seed + 1), 7)``);
the async engine lets the fast clients keep mixing. Each arm's (virtual
time, eval loss) curve, a target from the sync curve (three quarters of
the way in), the virtual time each arm needs, the speedup, and the
engine's ``us_per_event`` (host clock, best of 3, m events a call). On
the card the rounds and the events are captured (one graph replay each)
unless ``capture=False``.

Writes its JSON to ``OUT_JSON`` (under the git-ignored ``chiprun_out/``;
the reference's ``BENCH_async.json`` is the JAX package's).
"""
from __future__ import annotations

import json
from pathlib import Path

import torch

from .. import prng
from ..core import (AsyncConfig, DFedAvgMConfig, SpeedModel,
                    TopologySchedule, average_params, capture_step,
                    init_async_state, init_round_state, make_async_engine,
                    make_round_step)
from ..core.topology import ring_graph
from ..data import FederatedDataset, classification_dataset
from ..device import resolve_device
from .common import loss_2nn, stacked_2nn, sync, timeit_best

OUT_JSON = (Path(__file__).resolve().parents[3] / "chiprun_out"
            / "BENCH_async_torch.json")
M, K, B, ROUNDS = 8, 2, 32, 40
SMOKE_K, SMOKE_B, SMOKE_ROUNDS = 2, 8, 3


def _time_to_target(times, losses, target):
    """First virtual time at which the curve reaches the target loss."""
    for t, loss in zip(times, losses):
        if loss <= target:
            return t
    return None


def run_compare(m=M, K=K, batch=B, rounds=ROUNDS, eta=0.05, theta=0.9,
                p_edge=0.7, seed=0, speed: SpeedModel | None = None,
                max_staleness=8, device=None, capture: bool = True):
    """Both arms (the reference's ``run_compare``). Returns its dict,
    plus ``async_final_state`` and, captured on the card, the event
    graph (``async_graph``) and the sync round's (``sync_graph``)."""
    dev = resolve_device(device)
    captured = capture and dev.type == "cuda"
    speed = speed or SpeedModel.straggler(mean=1.0, sigma=0.5, frac=1.0 / m,
                                          factor=10.0)
    data = classification_dataset(n=4000, seed=0)
    fed = FederatedDataset.make(data, m, iid=True, seed=seed)
    sched = TopologySchedule.edge_sample(ring_graph(m), p_edge=p_edge)
    cfg = DFedAvgMConfig(eta=eta, theta=theta, local_steps=K,
                         mixer_impl="dense")
    stacked = stacked_2nn(m, seed, dev)
    full = {"x": torch.from_numpy(data.x).to(dev),
            "y": torch.from_numpy(data.y).to(dev)}

    def eval_loss(params) -> float:
        with torch.no_grad():
            return float(loss_2nn(average_params(params), full, None))

    def batches(t):
        return fed.round_batches(t, K=K, batch=batch, seed=seed, device=dev)

    # Synchronous arm: the barrier bills max_i duration_i a round.
    step = make_round_step(loss_2nn, cfg, sched, device=dev)
    st = init_round_state({n: t.clone() for n, t in stacked.items()},
                          prng.PRNGKey(seed + 1))
    if captured:
        step = capture_step(step, st, batches(0))
    clock_key = prng.fold_in(prng.PRNGKey(seed + 1, device=dev), 7)
    sync_t, sync_loss, t_virtual = [], [], 0.0
    for t in range(rounds):
        st, _ = step(st, batches(t))
        clock_key, k_dur = prng.split(clock_key)
        t_virtual += float(speed.draw(k_dur, m).max())
        sync_t.append(t_virtual)
        sync_loss.append(eval_loss(st.params))

    # Asynchronous arm: the same speed model, no barrier.
    acfg = AsyncConfig(speed=speed, max_staleness=max_staleness)
    engine = make_async_engine(loss_2nn, cfg, sched, acfg, device=dev,
                               capture=captured)
    ast = init_async_state({n: t.clone() for n, t in stacked.items()},
                           prng.PRNGKey(seed + 1), speed)
    async_t, async_loss = [], []
    for chunk in range(rounds):
        evs = [batches(chunk * m + e) for e in range(m)]
        events = {n: torch.stack([b[n] for b in evs]) for n in evs[0]}
        ast, _ = engine(ast, events)
        async_t.append(float(ast.clock))
        async_loss.append(eval_loss(ast.params))
    final = ast

    # Engine throughput: best of 3 of m events a call, continuing from the
    # trained state (the curves above are done).
    us_call, _ = timeit_best(lambda i, a: engine(a, events)[0], ast,
                             iters=2 if rounds <= 3 else 5, reps=3,
                             device=dev)
    sync(dev)
    target = sync_loss[min(rounds - 1, max(0, int(0.75 * rounds) - 1))]
    t_sync = _time_to_target(sync_t, sync_loss, target)
    t_async = _time_to_target(async_t, async_loss, target)
    return {
        "m": m, "K": K, "rounds": rounds, "schedule": sched.name,
        "speed_model": {"kind": speed.kind, "mean": speed.mean,
                        "sigma": speed.sigma,
                        "straggler_frac": speed.straggler_frac,
                        "straggler_factor": speed.straggler_factor},
        "max_staleness": max_staleness,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "captured": captured,
        "us_per_event": us_call / m,
        "target_loss": target,
        "sync_time_to_target": t_sync,
        "async_time_to_target": t_async,
        "speedup_virtual_wallclock": (t_sync / t_async
                                      if t_sync and t_async else None),
        "async_beats_sync": (t_async is not None and t_sync is not None
                             and t_async < t_sync),
        "sync_final": {"time": sync_t[-1], "loss": sync_loss[-1]},
        "async_final": {"time": async_t[-1], "loss": async_loss[-1]},
        "sync_curve": [[t, loss] for t, loss in zip(sync_t, sync_loss)],
        "async_curve": [[t, loss] for t, loss in zip(async_t, async_loss)],
        "async_final_state": final,
        "async_graph": engine.graph,
        "sync_graph": step.graph if captured else None,
    }


def run(*, smoke: bool = False, device=None):
    res = run_compare(rounds=SMOKE_ROUNDS if smoke else ROUNDS,
                      K=SMOKE_K if smoke else K,
                      batch=SMOKE_B if smoke else B, device=device)
    OUT_JSON.parent.mkdir(parents=True, exist_ok=True)
    OUT_JSON.write_text(json.dumps(
        {k: v for k, v in res.items()
         if k not in ("async_final_state", "async_graph", "sync_graph")},
        indent=2))
    sp = res["speedup_virtual_wallclock"]
    return [(
        "async_vs_sync_straggler",
        0.0 if res["async_time_to_target"] is None
        else res["async_time_to_target"] * 1e6,
        f"target_loss={res['target_loss']:.4f}|"
        f"sync_t={res['sync_time_to_target']}|"
        f"async_t={res['async_time_to_target']}|"
        f"speedup={sp if sp is None else round(sp, 2)}|"
        f"beats_sync={res['async_beats_sync']}|"
        f"us_per_event={res['us_per_event']:.1f}")]
