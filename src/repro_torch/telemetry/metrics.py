"""In-graph round telemetry: the :class:`Telemetry` NamedTuple and its
builders — the JAX package's ``telemetry/metrics.py`` on torch.

Everything here is a plain function of device tensors with no host sync,
so it runs INSIDE the round step built with ``with_telemetry=True`` and,
on the card, inside the round's captured CUDA graph. The flag defaults
to off and the off path builds the step it builds without it (its
parameters bitwise, its graph the same nodes). Fields a path does not
produce stay ``None``, so one NamedTuple serves the synchronous, fused,
asynchronous and pooled steps.

Metric definitions, as in the reference:

  consensus_dist  (1/m) sum_i ||x^{t+1}(i) - xbar||^2 — Lemma 4's LHS.
  local_drift     the same functional over the published z^t.
  live_edges      realized nonzero off-diagonal entries of the round's
                  effective mixing matrix — the directed edges that
                  actually carried a message.
  wire_bits       message_bits(d, quant) * live_edges — the REALIZED wire
                  bill, to cross-check against ``CommLedger``'s
                  expectation-based accounting.
  quant_err_sq    mean_i ||Q(delta_i) - delta_i||^2 over participating
                  clients, replaying the codec's draws — in the round
                  steps over a :data:`QUANT_SAMPLE_LANES` strided lane
                  sample.
  quant_bound     the paper's Assumption-4 budget mean_i sum_l d_l/4 *
                  s_{l,i}^2 next to it.
  quant_sat_frac  fraction of codes pinned at qmin/qmax.
  staleness_hist  [max_staleness + 2] counts of per-client version lag;
                  the last bucket collects lags past the hard cutoff.
  dropped_edges   base-support edges hard-zeroed by the staleness cutoff
                  (live_edges + dropped_edges == the base matrix's ready
                  live count).
  cohort_size     pooled: resident lanes this round/event.
  placement_boundary_lanes
                  the (placed) plan's block realization's wire lane
                  slots on the round's client mesh, for a sparse impl
                  other than a cycle's switch (``core.dfedavgm``'s
                  ``_boundary_lanes``); None without a mesh.

The quantizer replay draws its stochastic-rounding noise through
``core.mixing._quant_leaf_keys`` and ``quantize_int`` (one T2 launch a
leaf over the replayed lanes' keys) — the flat draw the dense mixer and
the reference's replay make. The plan realization's B1 draws its noise at
planar positions, so its elementwise draws differ; the scales (the shared
``scale_from_amax``), and therefore the bound, are identical, and the
observed error is statistically the wire's.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core.mixing import _quant_leaf_keys
from ..core.quantize import (QuantConfig, dequantize_int, message_bits,
                             quantize_int)

Params = dict[str, torch.Tensor]

__all__ = ["QUANT_SAMPLE_LANES", "Telemetry", "client_dim",
           "live_edge_count", "wire_bits_for", "quant_round_telemetry",
           "sample_lane_ids", "shard_sample_ids", "staleness_histogram",
           "dropped_edge_count",
           "telemetry_host"]

# Lane-sample size the round steps pass to ``quant_round_telemetry``: the
# replay is one extra codec pass over the wire deltas, so a strided sample
# of two lanes keeps each sampled lane an exact replay of its draws and
# caps the cost at ~2/m of a full pass (the reference's choice, held to
# its 1.10x overhead budget). ``sample_lanes=None`` replays every lane.
QUANT_SAMPLE_LANES = 2


class Telemetry(NamedTuple):
    """Per-round in-graph telemetry (0-dim device tensors, the histogram
    [max_staleness + 2]). ``None`` = not produced by this execution
    path."""

    consensus_dist: torch.Tensor | None = None
    local_drift: torch.Tensor | None = None
    live_edges: torch.Tensor | None = None
    wire_bits: torch.Tensor | None = None
    quant_err_sq: torch.Tensor | None = None
    quant_bound: torch.Tensor | None = None
    quant_sat_frac: torch.Tensor | None = None
    staleness_hist: torch.Tensor | None = None
    dropped_edges: torch.Tensor | None = None
    cohort_size: torch.Tensor | None = None
    placement_boundary_lanes: torch.Tensor | None = None


def client_dim(stacked: Params) -> int:
    """d — parameters per client of a client-stacked parameter dict."""
    return int(sum(math.prod(t.shape[1:]) for t in stacked.values()))


def _off_diagonal(W: torch.Tensor) -> torch.Tensor:
    k = W.shape[0]
    return W * (1.0 - torch.eye(k, dtype=torch.float32, device=W.device))


def live_edge_count(W: torch.Tensor, valid: torch.Tensor | None = None
                    ) -> torch.Tensor:
    """Nonzero off-diagonal entries of the round's effective mixing
    matrix (f32 0-dim) — its realized directed message edges. Schedules
    already encode participation in ``W_t`` (inactive rows ``e_i``,
    inactive columns 0); ``valid`` [k] restricts to real lanes of a
    padded pooled matrix."""
    off = _off_diagonal(W.to(torch.float32))
    if valid is not None:
        off = off * valid[:, None] * valid[None, :]
    return (off != 0.0).to(torch.float32).sum()


def wire_bits_for(d: int, quant: QuantConfig | None, live_edges,
                  model_parallel: int = 1) -> torch.Tensor:
    """Realized wire bits: one ``message_bits`` payload per live directed
    edge, computed on the device in f32 as the reference does
    (``f32(message_bits) * f32(live) / f32(model_parallel)``; the
    per-column bill of a 2D mesh for ``model_parallel`` > 1)."""
    if model_parallel < 1:
        raise ValueError(f"model_parallel={model_parallel} must be >= 1")
    qc = quant if quant is not None else QuantConfig(bits=32)
    live = torch.as_tensor(live_edges).to(torch.float32)
    bits = live * float(np.float32(message_bits(d, qc)))
    if model_parallel == 1:
        return bits
    # A true f32 division (a host scalar divisor becomes a reciprocal
    # multiply on the card).
    return bits / torch.full_like(bits, float(model_parallel))


def sample_lane_ids(m: int, sample_lanes: int | None, device
                    ) -> torch.Tensor | None:
    """The strided lane sample ``arange(0, m, max(1, m // s))[:s]`` as an
    int64 index tensor on ``device`` (None: every lane). A round step
    builds it once, when it is built: a captured graph reads it."""
    ids = _sample_ids(m, sample_lanes)
    return None if ids is None else torch.as_tensor(ids, device=device)


def _sample_ids(m: int, sample_lanes: int | None) -> np.ndarray | None:
    if sample_lanes is None or sample_lanes >= m:
        return None
    return np.arange(0, m, max(1, m // sample_lanes))[:sample_lanes]


def shard_sample_ids(m: int, sample_lanes: int | None, devs
                     ) -> dict[int, torch.Tensor | None]:
    """:func:`sample_lane_ids` over a client mesh of ``len(devs)`` shards:
    {shard: its sampled lanes as local int64 indices on its device},
    shards without a sampled lane left out; every shard maps to None
    (all its lanes) when the sample covers m. Built once with the step."""
    ids = _sample_ids(m, sample_lanes)
    ml = m // len(devs)
    if ids is None:
        return {s: None for s in range(len(devs))}
    return {s: torch.as_tensor(ids[ids // ml == s] - s * ml, device=d)
            for s, d in enumerate(devs) if (ids // ml == s).any()}


def _lane_stats(x: Params, z_eff: Params, quant: QuantConfig,
                leaf_keys: torch.Tensor | None, ids: torch.Tensor | None):
    """The replay of the lanes ``ids`` of stacked ``x`` (every lane for
    None): per lane the squared error, the Assumption-4 bound and the
    saturated codes, [n] each, and d."""
    names = sorted(x)
    m = x[names[0]].shape[0]
    err = bound = sat = None
    d_total = 0
    for li, name in enumerate(names):
        delta = (z_eff[name] - x[name]).to(torch.float32).reshape(m, -1)
        d_l = delta.shape[1]
        d_total += d_l
        keys_l = leaf_keys[li] if quant.stochastic else None
        if ids is not None:
            delta = delta[ids]
            keys_l = None if keys_l is None else keys_l[ids]
        code, s = quantize_int(delta, quant, keys_l)
        e_l = ((dequantize_int(code, s) - delta) ** 2).sum(dim=-1)
        sat_l = ((code == quant.qmin) | (code == quant.qmax)).to(
            torch.float32).sum(dim=-1)
        b_l = float(np.float32(d_l / 4.0)) * s * s
        err = e_l if err is None else err + e_l
        bound = b_l if bound is None else bound + b_l
        sat = sat_l if sat is None else sat + sat_l
    return err, bound, sat, d_total


def quant_round_telemetry(x: Params | list[Params],
                          z_eff: Params | list[Params], quant: QuantConfig,
                          key_q: torch.Tensor | None,
                          leaf_keys: torch.Tensor | None = None,
                          lane_weight: torch.Tensor | None = None,
                          sample_lanes=None):
    """Replay the round's quantization and measure its error.

    ``x`` / ``z_eff`` are the client-stacked held state and effective
    published state (inactive lanes already gated to x: their delta is 0,
    they quantize to Q(0) and contribute nothing, as in the mixers). Per
    client i, leaf by leaf in sorted-name (flatten) order, this quantizes
    ``delta_i = z_eff_i - x_i`` with ``quantize_int`` under the keys
    ``_quant_leaf_keys(key_q, n_leaves, m)`` (or the pooled path's
    gathered ``leaf_keys`` [n_leaves, k, 2]) and returns the 0-dim

      err_sq   mean_i ||Q(delta_i) - delta_i||^2      (observed)
      bound    mean_i sum_l d_l / 4 * s_{l,i}^2       (Assumption 4)
      sat_frac fraction of codes at qmin/qmax          (amax saturation)

    ``lane_weight`` [m] averages over a subset of lanes (the ready or
    active mask). ``sample_lanes`` replays only a strided sample of the
    lanes: an int (the ids built here) or the index tensor of
    :func:`sample_lane_ids` (what the round steps pass, built once).

    On a client mesh ``x`` and ``z_eff`` are lists of shard dicts (lane
    order; ``leaf_keys`` and ``lane_weight`` then in lane order on the
    first shard's device) and ``sample_lanes`` is None or
    :func:`shard_sample_ids`'s map: each shard replays its own lanes on
    its device and only the per-lane sums meet on the first shard's,
    so the result is bitwise the one device's.
    """
    shards = x if isinstance(x, list) else [x]
    z_shards = z_eff if isinstance(z_eff, list) else [z_eff]
    names = sorted(shards[0])
    dev = shards[0][names[0]].device
    widths = [s[names[0]].shape[0] for s in shards]
    m = sum(widths)
    if leaf_keys is None and quant.stochastic:
        leaf_keys = _quant_leaf_keys(key_q, len(names), m)
    if isinstance(x, list):
        picks = ({s: None for s in range(len(shards))} if sample_lanes is None
                 else sample_lanes)
    else:
        ids = (sample_lane_ids(m, sample_lanes, dev)
               if isinstance(sample_lanes, int) else sample_lanes)
        picks = {0: ids}
    stats, weights = [], []
    for s, ids in picks.items():
        lo = sum(widths[:s])
        sdev = shards[s][names[0]].device
        keys = (None if leaf_keys is None else
                leaf_keys[:, lo:lo + widths[s]].to(sdev))
        stats.append([t.to(dev) for t in _lane_stats(
            shards[s], z_shards[s], quant, keys, ids)[:3]])
        if lane_weight is not None:
            w = lane_weight[lo:lo + widths[s]]
            weights.append(w if ids is None else w[ids.to(dev)])
    d_total = sum(int(math.prod(t.shape[1:])) for t in shards[0].values())
    err, bound, sat = (stats[0][i] if len(stats) == 1 else
                       torch.cat([p[i] for p in stats]) for i in range(3))
    m_eff = err.shape[0]

    # Divisions by device tensors: the same IEEE division on the card and
    # on the CPU (a host divisor is a reciprocal multiply on the card).
    if lane_weight is not None:
        w = (weights[0] if len(weights) == 1
             else torch.cat(weights)).to(torch.float32)
        denom = torch.clamp(w.sum(), min=1.0)
        return ((err * w).sum() / denom, (bound * w).sum() / denom,
                (sat * w).sum() / (denom * float(d_total)))
    n = torch.full((), float(m_eff), dtype=torch.float32, device=dev)
    return err.sum() / n, bound.sum() / n, sat.sum() / (n * float(d_total))


def staleness_histogram(version: torch.Tensor, max_staleness: int
                        ) -> torch.Tensor:
    """[max_staleness + 2] int32 counts of per-client version lag
    ``max_j version[j] - version[i]`` — buckets 0..max_staleness, plus a
    final overflow bucket for clients past the hard cutoff. A fixed-size
    scatter of ones (``bincount`` sizes its output from the data, a host
    sync); integer adds, so the counts are exact in any order."""
    lag = version.max() - version
    lagc = torch.clamp(lag, 0, max_staleness + 1).to(torch.int64)
    hist = torch.zeros(max_staleness + 2, dtype=torch.int32,
                       device=version.device)
    return hist.scatter_add_(0, lagc, torch.ones_like(lagc,
                                                      dtype=torch.int32))


def dropped_edge_count(W_base: torch.Tensor, version: torch.Tensor,
                       ready: torch.Tensor, max_staleness: int
                       ) -> torch.Tensor:
    """Base-support directed edges the staleness HARD CUTOFF zeroed this
    event (f32 0-dim): ready row i, base weight on j nonzero, pairwise lag
    ``version[i] - version[j] > max_staleness``. Both discounts are
    positive at or below the cutoff, so ``live_edges(W_eff) + dropped ==
    live_edges(W_base restricted to ready rows)``."""
    s = torch.clamp(version[:, None] - version[None, :], min=0)
    off = _off_diagonal(W_base.to(torch.float32)) != 0.0
    ready_row = ready.to(torch.float32)[:, None] > 0
    return (off & ready_row & (s > max_staleness)).to(torch.float32).sum()


def telemetry_host(tel: Telemetry) -> dict:
    """One device-to-host transfer -> plain python values keyed by field
    name (``staleness_hist`` a list of ints), ready for
    ``RunLog.round(**fields)``; ``None`` fields are omitted. The present
    fields go to the host as one f32 tensor (a histogram's counts are
    integers far below 2^24, exact in f32)."""
    present = {k: v for k, v in tel._asdict().items() if v is not None}
    if not present:
        return {}
    flat = torch.cat([v.reshape(-1).to(torch.float32)
                      for v in present.values()]).cpu().tolist()
    out, at = {}, 0
    for k, v in present.items():
        n = v.numel()
        out[k] = ([int(c) for c in flat[at:at + n]]
                  if k == "staleness_hist" else flat[at])
        at += n
    return out
