"""Virtual client pool: rounds a second against the logical population m
— the reference's ``benchmarks/bench_pool.py`` on the port.

The host-backed :class:`~repro_torch.core.ClientPool` decouples the
LOGICAL client count from device memory: a fixed cohort of k lanes serves
m = 10^4..10^6 clients at a round rate set by k (compute) and the
cohort's fetch and write-back (host bandwidth), not by m. Three
measurements, on the reference's problem (a d = 32 MLP, regression
batches keyed ``fold_in(fold_in(key, client), t)``):

  * ``pool_scaling`` — rounds a second for a k = 64 cohort as m sweeps
    10^4 -> 10^6 (smoke: one m = 4096 arm). The only m-dependent work is
    the cohort draw (a permutation of m on the device).
  * ``compare`` — pooled against resident execution at m = 256, k = 16
    (every client fits on the device): the pooled store must equal the
    resident parameters bit for bit, and the cost ratio is reported. Both
    run the plan realization (``backend="sparse"``, the resident
    schedule's ``"auto"``), where the two mixes are term for term equal.
  * billing — the pooled round bills ``schedule_round_bits`` and its
    matmul FLOPs (``launch.hlo_stats.traced_flops``) equal the
    resident skip round's: the pool moves where parameters live, never
    the compute or the wire the algorithm is billed for.

On the card each pooled round's step and each resident round is one CUDA
graph replay. Writes its JSON to ``OUT_JSON`` (under the git-ignored
``chiprun_out/``; the reference's ``BENCH_pool.json`` is the JAX
package's).
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from .. import prng
from ..core import (ClientPool, DFedAvgMConfig, PoolSchedule, PooledRunner,
                    TopologySchedule, capture_step, init_round_state,
                    make_round_step, schedule_round_bits)
from ..core.topology import ring_graph
from ..device import resolve_device
from ..launch.hlo_stats import traced_flops
from .common import timeit_best

OUT_JSON = (Path(__file__).resolve().parents[3] / "chiprun_out"
            / "BENCH_pool_torch.json")
D_HID = 32
COHORT = 64
SCALING_M = (10_000, 100_000, 1_000_000)
SMOKE_M = (4096,)


def problem(d: int = D_HID):
    """The reference's tiny MLP and its fold_in-keyed gaussian regression
    batches: ``template``, ``loss_fn`` and ``batch_rows(key, ids, t)``
    (ids an int64 tensor on the key's device; leaves [k, K, bsz, ...])."""
    template = {"w1": torch.zeros(d, d), "b1": torch.zeros(d),
                "w2": torch.zeros(d)}

    def loss_fn(p, b, r):
        h = torch.tanh(b["x"] @ p["w1"] + p["b1"].unsqueeze(-2))
        pred = (h @ p["w2"].unsqueeze(-1)).squeeze(-1)
        return ((pred - b["y"]) ** 2).mean(dim=-1)

    def batch_rows(key, ids, t, K=2, bsz=8):
        ks = prng.fold_in(prng.fold_in(key, ids), t)
        kxy = prng.split(ks)
        return {"x": prng.normal(kxy[:, 0].contiguous(), (K, bsz, d)),
                "y": prng.normal(kxy[:, 1].contiguous(), (K, bsz))}

    return template, loss_fn, batch_rows


def _rounds_per_sec(runner: PooledRunner, n_rounds: int, dev,
                    warmup: int = 2) -> float:
    us, _ = timeit_best(lambda i, _: runner.round(), None, iters=n_rounds,
                        reps=1, warmup=warmup, device=dev)
    return 1e6 / us


def _step_flops(fn, *args) -> int:
    """The matmul FLOPs one call of the step runs (the elementwise work
    of a pooled round's gathers is not the algorithm's bill)."""
    return int(traced_flops(fn, *args, matmul_only=True))


def run_pool(smoke: bool = False, device=None) -> tuple[dict, list]:
    """Both measurements; returns (the JSON dict, the CSV rows)."""
    dev = resolve_device(device)
    template, loss_fn, batch_rows = problem()
    d = sum(t.numel() for t in template.values())
    cfg = DFedAvgMConfig(eta=0.05, theta=0.9, local_steps=2)
    key = prng.PRNGKey(0, device=dev)

    def bf(ids, t):
        return batch_rows(key, ids, t)

    out, res = [], {"n_params": d, "cohort": COHORT,
                    "device": (torch.cuda.get_device_name(dev)
                               if dev.type == "cuda" else "cpu")}

    # --- scaling: fixed cohort k, growing logical population m ---------
    n_rounds = 3 if smoke else 10
    res["pool_scaling"] = []
    for m in (SMOKE_M if smoke else SCALING_M):
        psched = PoolSchedule.ring_partial(m, COHORT / m)
        runner = PooledRunner(ClientPool(template, m), psched, loss_fn, cfg,
                              bf, key=prng.PRNGKey(1), backend="sparse",
                              device=dev)
        rps = _rounds_per_sec(runner, n_rounds, dev)
        res["pool_scaling"].append(
            {"m": m, "cohort": psched.cohort_size, "rounds_per_sec": rps,
             "pool_mbytes": runner.pool.nbytes / 2 ** 20})
        out.append((f"pool/m={m}", 1e6 / rps,
                    f"rps={rps:.2f} k={psched.cohort_size}"))

    # --- pooled vs resident at m = resident capacity -------------------
    m_cmp, k_cmp = (64, 16) if smoke else (256, 16)
    n_cmp, warmup = (5, 3) if smoke else (20, 3)
    sched = TopologySchedule.partial(ring_graph(m_cmp), k_cmp / m_cmp,
                                     exact=True)
    all_ids = torch.arange(m_cmp, device=dev)
    step = make_round_step(loss_fn, cfg, sched, device=dev)
    st0 = init_round_state(
        {n: t.to(dev).unsqueeze(0).expand((m_cmp,) + t.shape).contiguous()
         for n, t in template.items()}, prng.PRNGKey(7))
    run_step = step
    if dev.type == "cuda":
        run_step = capture_step(step, st0, bf(all_ids, 0))
    # The call index is the round, so the (client, round)-keyed batches
    # follow the resident sequence through the warm-up and the timed span.
    us_resident, st = timeit_best(
        lambda t, s: run_step(s, bf(all_ids, t))[0], st0, iters=n_cmp,
        reps=1, warmup=warmup, device=dev)
    resident_rps = 1e6 / us_resident

    psched = PoolSchedule.ring_partial(m_cmp, k_cmp / m_cmp)
    runner = PooledRunner(ClientPool(template, m_cmp), psched, loss_fn, cfg,
                          bf, key=prng.PRNGKey(7), backend="sparse",
                          device=dev)
    us_pooled, _ = timeit_best(lambda i, _: runner.round(), None,
                               iters=n_cmp, reps=1, warmup=warmup,
                               device=dev)
    pooled_rps = 1e6 / us_pooled

    got = runner.pool.fetch(np.arange(m_cmp))
    bitwise = all(torch.equal(got[n], st.params[n].cpu()) for n in got)
    if not bitwise:
        raise AssertionError("pooled params diverged from resident-lane "
                             "params")
    bits_resident = schedule_round_bits(sched, d, cfg.quant)
    bits_pooled = psched.round_bits(d, cfg.quant)
    billing_equal = bits_pooled == bits_resident
    if not billing_equal:
        raise AssertionError(f"pooled bill {bits_pooled} != resident "
                             f"{bits_resident}")

    inp = runner._rs.inputs(prng.PRNGKey(7, device=dev), 0)
    x_sub = {n: t.to(dev) for n, t in runner.pool.fetch(
        inp["idx"].cpu().numpy()).items()}
    f_pooled = _step_flops(runner._rs.step, x_sub, bf(inp["idx"], 0),
                           inp["client_keys"], inp["W_sub"], inp["idx"],
                           inp["key_q"])
    f_resident = _step_flops(step, st0, bf(all_ids, 0))
    flops_equal = f_pooled == f_resident
    if not flops_equal:
        raise AssertionError(f"pooled round FLOPs {f_pooled} != resident "
                             f"{f_resident}")

    ratio = resident_rps / pooled_rps
    res["compare"] = {
        "m": m_cmp, "cohort": k_cmp, "backend": "sparse",
        "resident_rounds_per_sec": resident_rps,
        "pooled_rounds_per_sec": pooled_rps,
        "pooled_over_resident_cost": ratio,
        "bitwise_equal": bitwise,
        "billing_bits_per_round": bits_pooled,
        "billing_equal": billing_equal,
        "pooled_round_flops": f_pooled,
        "resident_round_flops": f_resident,
        "flops_equal": flops_equal,
    }
    out.append(("pool/compare", 1e6 / pooled_rps,
                f"pooled={pooled_rps:.2f}rps resident={resident_rps:.2f}"
                f"rps cost_ratio={ratio:.2f} bitwise={bitwise}"))
    res["smoke"] = smoke
    return res, out


def run(*, smoke: bool = False, device=None):
    """The runner's entry: the pooled runner's scaling and pooled-against-
    resident rows, the record written to ``OUT_JSON``; returns the CSV rows."""
    res, out = run_pool(smoke=smoke, device=device)
    OUT_JSON.parent.mkdir(parents=True, exist_ok=True)
    OUT_JSON.write_text(json.dumps(res, indent=2))
    return out
