"""Virtual client pool: a host-backed parameter store for 10^5-10^6
clients — the port of the JAX package's ``core/client_pool.py``.

The resident round stacks every client's parameters on the device, so m
is capped by device memory, not by the topology. Here the LOGICAL
population lives on the host and only a round's cohort of k lanes is on
the card:

  * :class:`ClientPool` — a copy-on-write numpy slab store holding all m
    clients' parameters and version counters. A client that never trained
    reads the shared template and holds no slab row, so host memory is
    O(touched clients), not O(m).
  * :class:`PoolSchedule` — the cohort sampler: the resident
    :class:`~repro_torch.core.topology.TopologySchedule`'s draws (same key
    splits, same ``permutation`` or walk) with only the round's k ids and
    their [k, k] mixing submatrix materialized. The structural-ring
    constructors never build the O(m^2) adjacency.
  * :func:`make_pooled_round_step` — the round at cohort width: ``inputs``
    (the O(m) key work: round keys, the cohort, the gathered client and
    quantizer keys, the submatrix) and ``step`` (local SGD on k lanes,
    then gossip: dense, or the plan realization with the full-width plan
    remapped onto the cohort's lanes — one B1 and one B2 launch).
  * :class:`PooledRunner` — the host loop with double-buffered prefetch:
    cohort t+1 is drawn, gathered into a pinned staging buffer by a worker
    thread and copied to the card on a side stream while round t trains
    and is written back; round t's rows that cohort t+1 shares are
    patched in from round t's output, so the prefetch equals a fetch
    after the write-back bit for bit. On the card the step is one CUDA graph replay (captured once, at
    the cohort width).
  * :class:`PooledAsyncRunner` — the async engine over the pool: each
    event materializes the ready clients and their neighbours, padded to
    a static ``capacity``, and replays the resident event's math there.

Invariants (held by ``tests/test_torch_client_pool.py``): versions only
grow, and only on write-back; pooled rounds equal the resident ones bit
for bit on the same key (cohorts, per-lane local SGD, and the mix for
bases of degree <= 2, where a row has at most two off-diagonal terms;
quantized rounds draw their stochastic-rounding keys at the full width
and gather the cohort's rows); the async cohort is closed (every row that
reads a value holds it); pooled rounds bill the resident schedule's
``schedule_round_bits``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from .. import prng
from ..device import resolve_device
from .async_gossip import (_CLOCK_SALT, AsyncConfig, staleness_eta,
                           staleness_weights)
from .dfedavgm import DFedAvgMConfig, _weighted_mean
from .event_clock import next_event
from .gossip_plan import matching_steps
from .local_sgd import local_train
from .mixing import (_make_lanes_mixer, _mix_dense_quantized, _quant_leaf_keys,
                     mix_dense)
from .quantize import QuantConfig, message_bits
from .topology import (MixingSpec, TopologySchedule,
                       metropolis_weights_from_adjacency)

Params = dict[str, torch.Tensor]
LossFn = Callable[..., torch.Tensor]

__all__ = ["ClientPool", "PoolSchedule", "PooledRoundStep",
           "make_pooled_round_step", "PooledRunner", "PooledAsyncRunner",
           "ring_matching_src"]


# ---------------------------------------------------------------------------
# Structural ring plan: O(m) replication of matching_steps(ring_graph(m))
# ---------------------------------------------------------------------------

def ring_matching_src(m: int) -> np.ndarray:
    """The exact ``src`` array ``matching_steps(ring_graph(m).adj)``
    produces, built in O(m) without the dense adjacency.

    The greedy edge coloring walks triu edges row-major — (0,1), (0,m-1),
    (1,2), (2,3), ... — so color 0 takes (0,1) and the even-i chain edges,
    color 1 takes (0,m-1) and the odd-i chain edges, and an odd m pushes
    the final edge (m-2, m-1) to color 2 (both its endpoints already hold
    colors 0 and 1)."""
    if m < 2:
        raise ValueError("ring plan needs m >= 2")
    if m == 2:
        return np.array([[1, 0]], np.int32)
    n_steps = 2 if m % 2 == 0 else 3
    src = np.tile(np.arange(m, dtype=np.int32), (n_steps, 1))

    def assign(c, i, j):
        src[c, i], src[c, j] = j, i

    assign(0, 0, 1)
    assign(1, 0, m - 1)
    for i in range(1, m - 2):
        assign(1 if i % 2 else 0, i, i + 1)
    assign(0 if m % 2 == 0 else 2, m - 2, m - 1)
    return src


def _ring_walk(m: int, horizon: int, seed: int, start: int) -> np.ndarray:
    """``TopologySchedule.random_walk(ring_graph(m), ...)``'s path without
    the dense adjacency: a ring node's neighbours are the ascending pair
    {(i-1)%m, (i+1)%m} (one neighbour at m == 2), and the next position is
    ``rng.choice`` over them from the same ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    pos = np.empty(horizon + 1, dtype=np.int32)
    pos[0] = start
    for k in range(horizon):
        i = int(pos[k])
        if m == 2:
            nbrs = np.array([1 - i])
        else:
            nbrs = np.array(sorted(((i - 1) % m, (i + 1) % m)))
        pos[k + 1] = rng.choice(nbrs)
    return pos


# ---------------------------------------------------------------------------
# ClientPool: copy-on-write host slab store
# ---------------------------------------------------------------------------

def _host_array(t) -> np.ndarray:
    """A leaf as the numpy array the store keeps: bf16 as its raw int16
    bits (numpy has no bf16), everything else as itself."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy()
    return np.asarray(t)


class ClientPool:
    """Host-side parameter store for m logical clients, copy-on-write.

    ``template`` is ONE client's parameters (a flat dict of tensors or
    arrays, no client axis): the shared init every virgin client reads.
    A slab row is allocated the first time a client is written back, so
    host memory is O(materialized clients x d) whatever m is.
    ``versions[i]`` counts client i's write-backs and only grows.

    Each leaf's slab keeps the template in its row 0 and client i's
    parameters in row ``slot[i] + 1``, so a fetch is one row gather a leaf
    (a virgin client's slot -1 reads row 0). Checkpoints hold the
    materialized rows in slot order, the JAX package's layout.
    """

    def __init__(self, template: dict, m: int):
        if m < 1:
            raise ValueError("need m >= 1")
        self.m = int(m)
        self._names = sorted(template)
        self._dtypes = {n: (template[n].dtype if isinstance(
            template[n], torch.Tensor) else torch.from_numpy(
                np.asarray(template[n])).dtype) for n in self._names}
        self._template = [_host_array(template[n]) for n in self._names]
        self._slabs = [t[None].copy() for t in self._template]
        self._slot = np.full(m, -1, np.int64)
        self._n_slots = 0
        self.versions = np.zeros(m, np.int32)

    # -- introspection -----------------------------------------------------

    @property
    def names(self) -> list[str]:
        """Leaf names in flatten (sorted) order."""
        return list(self._names)

    @property
    def template(self) -> Params:
        """The shared init, one client's leaves as CPU tensors."""
        return {n: self._tensor(n, t.copy())
                for n, t in zip(self._names, self._template)}

    @property
    def materialized(self) -> int:
        """Number of clients holding their own slab row."""
        return self._n_slots

    @property
    def nbytes(self) -> int:
        """Host bytes HELD by materialized rows (the allocated capacity
        may be up to ~2x during geometric growth)."""
        return self._n_slots * sum(t.nbytes for t in self._template)

    @property
    def n_params(self) -> int:
        return int(sum(t.size for t in self._template))

    def _tensor(self, name: str, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        return (t.view(torch.bfloat16)
                if self._dtypes[name] == torch.bfloat16 else t)

    def consensus_distance(self) -> float:
        """(1/m) sum_i ||x(i) - xbar||^2 over the FULL logical population,
        in O(materialized x d) on the host: the m - n virgin clients sit
        at the template, one closed-form term. f64 accumulation."""
        n = self._n_slots
        total = 0.0
        for name, t, slab in zip(self._names, self._template, self._slabs):
            rows = self._tensor(name, slab[1:n + 1]).to(
                torch.float64).reshape(n, -1).numpy()
            tmpl = self._tensor(name, t.copy()).to(
                torch.float64).reshape(-1).numpy()
            mean = (rows.sum(axis=0) + (self.m - n) * tmpl) / self.m
            sq = float(((rows - mean) ** 2).sum())
            sq += (self.m - n) * float(((tmpl - mean) ** 2).sum())
            total += sq / self.m
        return total

    # -- fetch / write-back ------------------------------------------------

    def fetch_into(self, idx, out: dict) -> None:
        """Gather clients ``idx`` [k] into the first k rows of ``out``'s
        leaves (numpy arrays [>= k, ...], e.g. views of a pinned staging
        buffer); virgin clients read the template. One ``index_select`` a
        leaf on the slab's memory (torch's row copy releases the GIL and
        runs on the intra-op threads, so a gather on the prefetch's worker
        overlaps a write-back on the caller's thread)."""
        rows = torch.from_numpy(self._slot[np.asarray(idx, np.int64)] + 1)
        for name, slab in zip(self._names, self._slabs):
            torch.index_select(torch.from_numpy(slab), 0, rows,
                               out=torch.from_numpy(out[name][:rows.numel()]))

    def fetch(self, idx) -> Params:
        """Gather clients ``idx`` [k] into fresh CPU tensors [k, ...]."""
        idx = np.asarray(idx, np.int64)
        out = {n: np.empty((idx.size,) + t.shape, t.dtype)
               for n, t in zip(self._names, self._template)}
        self.fetch_into(idx, out)
        return {n: self._tensor(n, a) for n, a in out.items()}

    def _reserve(self, idx) -> None:
        """Give clients ``idx`` that hold no slab row one (growing the
        slabs geometrically). After it, writing ``idx`` back moves no slot
        and no slab, so a concurrent gather of other clients reads rows
        that stay put."""
        idx = np.asarray(idx, np.int64)
        new = idx[self._slot[idx] < 0]
        if not new.size:
            return
        need = self._n_slots + new.size
        cap = self._slabs[0].shape[0] - 1
        if need > cap:
            cap_next = max(min(max(need, 2 * cap, 64), self.m), need)
            for li, slab in enumerate(self._slabs):
                grown = np.empty((cap_next + 1,) + slab.shape[1:],
                                 slab.dtype)
                grown[:self._n_slots + 1] = slab[:self._n_slots + 1]
                self._slabs[li] = grown
        self._slot[new] = np.arange(self._n_slots, need)
        self._n_slots = need

    def writeback(self, idx, stacked: dict, mask=None) -> None:
        """Scatter stacked rows (leaves [k, ...], tensors or arrays) back
        to clients ``idx``, allocating slab rows for first-time writers
        and bumping each written client's version. ``mask`` [k] bool
        restricts the write (the async engine writes only the ready
        lanes). One ``index_copy_`` a leaf (see :meth:`fetch_into`)."""
        idx = np.asarray(idx, np.int64)
        leaves = [_host_array(stacked[n]) for n in self._names]
        if mask is not None:
            keep = np.asarray(mask, bool)
            idx = idx[keep]
            leaves = [a[:keep.size][keep] for a in leaves]
        else:
            leaves = [a[:idx.size] for a in leaves]
        if np.unique(idx).size != idx.size:
            raise ValueError("writeback cohort has duplicate client ids")
        self._reserve(idx)
        rows = torch.from_numpy(self._slot[idx] + 1)
        for slab, a in zip(self._slabs, leaves):
            a = np.asarray(a, slab.dtype)       # numpy's assignment cast
            if not a.flags.writeable:
                a = a.copy()
            torch.from_numpy(slab).index_copy_(0, rows, torch.from_numpy(a))
        self.versions[idx] += 1

    # -- checkpointing (checkpoint/io.py) ----------------------------------

    def save(self, ckpt_dir, step: int, extra: dict | None = None,
             keep: int = 3):
        """Write the pool with :func:`repro_torch.checkpoint.save_checkpoint`
        in the JAX package's layout: only the MATERIALIZED rows, in slot
        order. ``extra`` is a flat {name: array or tensor} dict of runner
        state (a key named ``rng`` is written as uint32)."""
        from ..checkpoint.io import save_checkpoint
        n = self._n_slots
        tree = {
            "pool": {
                "m": np.asarray(self.m, np.int64),
                "slot": self._slot.copy(),
                "versions": self.versions.copy(),
                "slabs": {f"{li:03d}": self._tensor(
                    name, slab[1:n + 1].copy())
                    for li, (name, slab) in enumerate(
                        zip(self._names, self._slabs))},
            },
            "extra": dict(extra or {}),
        }
        return save_checkpoint(ckpt_dir, step, tree, keep=keep)

    @classmethod
    def restore(cls, ckpt_dir, template: dict, step: int | None = None
                ) -> tuple["ClientPool", dict, int]:
        """Rebuild ``(pool, extra, step)`` from a :meth:`save` checkpoint
        of either package; ``template`` gives the leaves and dtypes (a
        bf16 slab, upcast on disk, is cast back). ``extra`` holds the raw
        arrays (a key as uint32)."""
        from ..checkpoint.io import read_checkpoint
        data, step = read_checkpoint(ckpt_dir, step)
        pool = cls(template, int(data["pool/m"]))
        pool._slot = data["pool/slot"].astype(np.int64)
        pool.versions = data["pool/versions"].astype(np.int32)
        n = int((pool._slot >= 0).sum())
        pool._n_slots = n
        for li, (name, t) in enumerate(zip(pool._names, pool._template)):
            rows = torch.from_numpy(np.ascontiguousarray(
                data[f"pool/slabs/{li:03d}"])).to(pool._dtypes[name])
            slab = np.empty((n + 1,) + t.shape, t.dtype)
            slab[0] = t
            slab[1:] = _host_array(rows)
            pool._slabs[li] = slab
        extra = {k[len("extra/"):]: v for k, v in data.items()
                 if k.startswith("extra/")}
        return pool, extra, step


# ---------------------------------------------------------------------------
# PoolSchedule: cohort sampling that replicates the resident draws
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class PoolSchedule:
    """Cohort sampler for pooled execution.

    Draws as the resident :class:`TopologySchedule` does — same
    ``_split_mix_key`` discipline, same ``permutation`` or walk — but
    returns the round's k-client cohort (ascending ids, the order of the
    resident skip path's lanes) and its [k, k] mixing submatrix, on the
    key's device. ``adj=None`` means a structural ring: the cohort's
    adjacency and the gossip plan come from index arithmetic, so nothing
    is O(m^2).

    Kinds: ``partial`` (exact cohorts, ``partial(..., exact=True)``) and
    ``random_walk`` (a precomputed path). i.i.d. or capped participation
    and stateful walks have no static cohort and are refused by
    :meth:`from_schedule`.
    """

    kind: str                      # "partial" | "random_walk"
    m: int
    cohort_size: int
    name: str = "pool"
    adj: np.ndarray | None = None  # dense base adjacency (small m only)
    walk: np.ndarray | None = None  # [horizon+1] precomputed walk path
    _tables: dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False, compare=False)

    def __post_init__(self):
        if self.kind not in ("partial", "random_walk"):
            raise ValueError(f"unknown pool schedule kind {self.kind!r}")
        if not 1 <= self.cohort_size <= self.m:
            raise ValueError("need 1 <= cohort_size <= m")
        if self.kind == "random_walk" and self.walk is None:
            raise ValueError("random_walk pool schedule needs the "
                             "precomputed path")

    # -- constructors ------------------------------------------------------

    @staticmethod
    def from_schedule(schedule: TopologySchedule) -> "PoolSchedule":
        """Wrap a resident schedule (its dense adjacency kept — small m):
        pooled rounds then draw the resident skip path's cohorts."""
        if schedule.kind == "partial" and schedule.n_active is not None:
            return PoolSchedule(kind="partial", m=schedule.m,
                                cohort_size=schedule.n_active,
                                name=f"pool[{schedule.name}]",
                                adj=np.asarray(schedule.adj))
        if schedule.kind == "random_walk" and schedule.walk is not None:
            return PoolSchedule(kind="random_walk", m=schedule.m,
                                cohort_size=2,
                                name=f"pool[{schedule.name}]",
                                adj=np.asarray(schedule.adj),
                                walk=np.asarray(schedule.walk))
        raise ValueError(
            f"pooled execution needs a statically sized cohort: "
            f"partial(..., exact=True) or a precomputed random walk, got "
            f"{schedule.name!r} (i.i.d./capped participation draws a "
            f"variable active set; stateful walks carry in-graph state)")

    @staticmethod
    def ring_partial(m: int, p_active: float) -> "PoolSchedule":
        """Structural-ring exact cohorts, no dense adjacency (usable at m
        ~ 10^6): the draws of ``TopologySchedule.partial(ring_graph(m),
        p_active, exact=True)``."""
        if not 0.0 < p_active <= 1.0:
            raise ValueError("need 0 < p_active <= 1")
        n_active = max(1, round(p_active * m))
        return PoolSchedule(kind="partial", m=m, cohort_size=n_active,
                            name=f"pool[partial[ring-{m},k={n_active}]]")

    @staticmethod
    def ring_random_walk(m: int, horizon: int = 4096, seed: int = 0,
                         start: int = 0) -> "PoolSchedule":
        """Structural-ring random walk: the path of
        ``TopologySchedule.random_walk(ring_graph(m), ...)``."""
        return PoolSchedule(kind="random_walk", m=m, cohort_size=2,
                            name=f"pool[random_walk[ring-{m}]]",
                            walk=_ring_walk(m, horizon, seed, start))

    # -- the resident key discipline ---------------------------------------

    @property
    def is_stochastic(self) -> bool:
        """Exact cohorts consume randomness; a precomputed walk does not."""
        return self.kind == "partial"

    def split_mix_key(self, key_mix: torch.Tensor):
        """``TopologySchedule._split_mix_key``: a stochastic kind splits
        (key_topo, key_q); a deterministic one uses key_mix for both."""
        if self.is_stochastic:
            key_topo, key_q = prng.split(key_mix)
            return key_topo, key_q
        return key_mix, key_mix

    def tables(self, device) -> dict[str, torch.Tensor]:
        """The schedule's device tables (the base adjacency, the walk),
        made once a device."""
        dev = torch.device(device)
        if dev not in self._tables:
            tab = {}
            if self.adj is not None:
                tab["adj"] = torch.as_tensor(np.asarray(self.adj),
                                             dtype=torch.float32, device=dev)
            if self.walk is not None:
                tab["walk"] = torch.as_tensor(self.walk.astype(np.int64),
                                              device=dev)
            self._tables[dev] = tab
        return self._tables[dev]

    # -- cohort and submatrix, on the device --------------------------------

    def cohort(self, key_topo: torch.Tensor, t) -> torch.Tensor:
        """Round t's cohort ids, int64 [k] ASCENDING, on the key's device
        (``t`` a host int or a 0-dim device tensor): the draws of
        ``TopologySchedule.sample_w``."""
        if self.kind == "partial":
            ids = prng.permutation(key_topo, self.m)[:self.cohort_size]
            return torch.sort(ids).values
        pos = self.tables(key_topo.device)["walk"]
        horizon = pos.shape[0] - 1
        if isinstance(t, torch.Tensor):
            i = (t.to(torch.int64) % horizon).reshape(1)
            pair = torch.cat([pos.index_select(0, i),
                              pos.index_select(0, i + 1)])
        else:
            pair = pos[int(t) % horizon:int(t) % horizon + 2]
        return torch.sort(pair).values

    def sub_adjacency(self, idx: torch.Tensor) -> torch.Tensor:
        """[k, k] f32 base adjacency of the cohort: gathered rows and
        columns of the dense base, or (structural ring) index
        arithmetic."""
        if self.adj is not None:
            a = self.tables(idx.device)["adj"]
            return a[idx][:, idx]
        d = (idx[:, None] - idx[None, :]) % self.m
        ring = (d == 1) if self.m == 2 else (d == 1) | (d == self.m - 1)
        return ring.to(torch.float32)

    def w_sub(self, idx: torch.Tensor) -> torch.Tensor:
        """The cohort's [k, k] rows and columns of the resident W_t: an
        exact cohort's live subgraph Metropolis-reweighted (the degrees
        are integers, so the sub-width sums are the full width's bit for
        bit), a walk round's pairwise average."""
        if self.kind == "partial":
            return metropolis_weights_from_adjacency(self.sub_adjacency(idx))
        return torch.full((2, 2), 0.5, dtype=torch.float32,
                          device=idx.device)

    # -- sparse plan -------------------------------------------------------

    def plan_src(self) -> np.ndarray:
        """The support plan's ``src`` steps [n_steps, m]: greedy matchings
        over the base adjacency, or the structural ring's
        :func:`ring_matching_src`."""
        if self.adj is not None:
            return matching_steps(np.asarray(self.adj) != 0)
        return ring_matching_src(self.m)

    # -- billing -----------------------------------------------------------

    def expected_directed_edges(self) -> float:
        """``TopologySchedule.expected_directed_edges`` for these kinds, in
        the same expressions, so the bills agree exactly."""
        if self.kind == "partial":
            base = (float(np.asarray(self.adj).sum()) if self.adj is not None
                    else float(2 * self.m if self.m > 2 else 2))
            k, m = self.cohort_size, self.m
            return k * (k - 1) / (m * (m - 1)) * base
        return 2.0

    def round_bits(self, n_params: int,
                   quant: QuantConfig | None = None) -> float:
        """Expected bits one pooled round moves: the live-directed-edge
        bill of :func:`repro_torch.core.comm_cost.schedule_round_bits`."""
        qc = quant if quant is not None else QuantConfig(bits=32)
        return message_bits(n_params, qc) * self.expected_directed_edges()


# ---------------------------------------------------------------------------
# Pooled round step (device side, cohort width)
# ---------------------------------------------------------------------------

class PooledRoundStep:
    """The two halves of a pooled round.

    ``inputs(rng, t)`` — the O(m) key work, on the key's device: the round
    keys exactly as the resident step splits them (``split(rng, 3)``,
    ``split(key_round, m)``), the cohort, its gathered client keys, the
    [k, k] submatrix and, for stochastic rounding, the per-leaf keys drawn
    at the full width and gathered. ``step(x_sub, batches, client_keys,
    W_sub, idx, key_q, leaf_keys=None)`` — the O(k) compute: local SGD on
    the cohort's lanes and the mix at cohort width. Metrics are the
    resident skip path's ``loss`` and ``active_frac`` (whole-population
    metrics need all m rows and are the pool's job)."""

    def __init__(self, inputs: Callable, step: Callable):
        self.inputs = inputs
        self.step = step


def _cohort_lane_map(src_full: torch.Tensor, idx: torch.Tensor,
                     W_sub: torch.Tensor):
    """The full-width plan steps remapped onto cohort lanes: for lane a
    (client idx[a]) and step s, a source at cohort lane p gives ``src =
    p`` with weight ``W_sub[a, p]``; an idle step (source = self) or a
    source outside the cohort reads the lane's own value at weight 0 (the
    resident W_t is 0 there too, so the accumulation chains stay term for
    term the same). Returns (lane_src int64 [n_steps, k], w_steps f32
    [n_steps, k])."""
    k = idx.shape[0]
    s = src_full[:, idx]
    pos = torch.clamp(torch.searchsorted(idx, s), 0, k - 1)
    hit = idx[pos] == s
    lane = torch.arange(k, device=idx.device)
    lane_src = torch.where(hit, pos, lane)
    self_edge = s == idx[None, :]
    w = W_sub[lane[None, :].expand_as(lane_src), lane_src]
    return lane_src, torch.where(hit & ~self_edge, w, 0.0)


def make_pooled_round_step(loss_fn: LossFn, cfg: DFedAvgMConfig,
                           psched: PoolSchedule, template: dict,
                           backend: str = "dense",
                           with_telemetry: bool = False,
                           device=None) -> PooledRoundStep:
    """Build the pooled round step for ``psched``'s cohorts on ``device``
    (CUDA unless ``"cpu"``).

    ``template`` is one client's parameters (it fixes the leaf count of
    the quantizer keys). ``backend``: ``"dense"`` is the resident dense
    mixer (``mix_dense`` / ``_mix_dense_quantized``) at [k, k];
    ``"sparse"`` is the plan realization (``execute_plan_reference``'s
    math) with the plan's full-width steps remapped onto the cohort's
    lanes on the device — one B1 encode and one B2 decode-apply at cohort
    width on a quantized wire, each lane's words those of the full width
    under the gathered keys. Local SGD is ``local_train`` (B3 a step).

    ``with_telemetry`` adds ``metrics["telemetry"]`` (a
    :class:`~repro_torch.telemetry.Telemetry`): the cohort's live edges
    and wire bits, ``cohort_size`` and, on a quantized wire, the
    quantizer's observed error against the Assumption-4 bound, replayed
    over ``QUANT_SAMPLE_LANES`` strided lanes under the same gathered
    keys. Whole-population fields need the host store and are the
    runner's (:meth:`PooledRunner.round` with ``telemetry=True``).
    """
    if backend not in ("dense", "sparse"):
        raise ValueError(f"unknown pooled backend {backend!r}")
    dev = resolve_device(device)
    m, k = psched.m, psched.cohort_size
    quant = cfg.quant
    n_leaves = len(template)
    stochastic_q = quant is not None and quant.enabled and quant.stochastic
    if backend == "sparse":
        src_np = psched.plan_src()
        ar = np.arange(m)
        live = [s for s in range(src_np.shape[0]) if (src_np[s] != ar).any()]
        src_full = torch.as_tensor(src_np[live].astype(np.int64), device=dev)
        lane_ids = torch.arange(k, device=dev)[None]
        ex = _make_lanes_mixer(k, quant, dev)
    ones = torch.ones(k, dtype=torch.float32, device=dev)
    # The resident ``active.mean()`` of k ones among m, computed once as
    # the resident computes it (the card's mean multiplies by 1/m).
    active = torch.zeros(m, dtype=torch.float32, device=dev)
    active[:k] = 1.0
    active_frac = active.mean()
    quant_on = quant is not None and quant.enabled
    if with_telemetry:
        from ..telemetry.metrics import (QUANT_SAMPLE_LANES, Telemetry,
                                         live_edge_count,
                                         quant_round_telemetry,
                                         sample_lane_ids, wire_bits_for)
        d_client = int(sum(t.numel() for t in template.values()))
        cohort_size = torch.full((), float(k), dtype=torch.float32,
                                 device=dev)
        sampled = (sample_lane_ids(k, QUANT_SAMPLE_LANES, dev) if quant_on
                   else None)

    def inputs(rng: torch.Tensor, t) -> dict:
        key_round, key_mix, key_next = prng.split(rng, 3)
        client_keys = prng.split(key_round, m)
        key_topo, key_q = psched.split_mix_key(key_mix)
        idx = psched.cohort(key_topo, t)
        out = {"idx": idx, "client_keys": client_keys[idx],
               "W_sub": psched.w_sub(idx), "key_q": key_q,
               "key_next": key_next}
        if stochastic_q:
            out["leaf_keys"] = _quant_leaf_keys(
                key_q, n_leaves, m)[:, idx].contiguous()
        return out

    def step(x_sub: Params, batches: Params, client_keys: torch.Tensor,
             W_sub: torch.Tensor, idx: torch.Tensor, key_q: torch.Tensor,
             leaf_keys: torch.Tensor | None = None):
        z_sub, losses = local_train(loss_fn, x_sub, batches, client_keys,
                                    eta=cfg.eta, theta=cfg.theta)
        if backend == "sparse":
            lane_src, w_steps = _cohort_lane_map(src_full, idx, W_sub)
            src = torch.cat([lane_ids, lane_src]).to(torch.int32)
            w = torch.cat([torch.diagonal(W_sub)[None], w_steps]).T
            x_next = ex(x_sub, z_sub, w.contiguous(), src, key_q,
                        leaf_keys=leaf_keys)
        elif quant is None or not quant.enabled:
            x_next = mix_dense(W_sub, z_sub)
        else:
            x_next = _mix_dense_quantized(W_sub, x_sub, z_sub, quant, key_q,
                                          leaf_keys=leaf_keys)
        # The resident skip path's formulas with every slot valid.
        metrics = {"loss": _weighted_mean(losses, ones),
                   "active_frac": active_frac}
        if with_telemetry:
            with record_function("round/telemetry"):
                live = live_edge_count(W_sub)
                fields = dict(live_edges=live,
                              wire_bits=wire_bits_for(d_client, quant, live),
                              cohort_size=cohort_size)
                if quant_on:
                    # Every cohort lane participates (no gate); the
                    # gathered keys replay the cohort mixer's draws.
                    qe, qb, qs = quant_round_telemetry(
                        x_sub, z_sub, quant, key_q, leaf_keys=leaf_keys,
                        sample_lanes=sampled)
                    fields.update(quant_err_sq=qe, quant_bound=qb,
                                  quant_sat_frac=qs)
                metrics["telemetry"] = Telemetry(**fields)
        return x_next, metrics

    return PooledRoundStep(inputs=inputs, step=step)


# ---------------------------------------------------------------------------
# Staging buffers and capture
# ---------------------------------------------------------------------------

class _Staging:
    """One allocation holding every leaf at ``rows`` rows ([rows, *shape]
    each, 256-byte aligned), so one copy moves a whole cohort; pinned on
    the host when asked, else on ``device``."""

    def __init__(self, shapes: dict, rows: int, device, pin: bool = False):
        offs, total = {}, 0
        for n, (shape, dtype) in shapes.items():
            nb = rows * math.prod(shape) * torch.empty((), dtype=dtype
                                                       ).element_size()
            offs[n] = (total, nb)
            total += -(-nb // 256) * 256
        self.buf = torch.empty(max(total, 1), dtype=torch.uint8,
                               device=device, pin_memory=pin)
        self.leaves = {n: self.buf[o:o + nb].view(shapes[n][1]).view(
            (rows,) + tuple(shapes[n][0])) for n, (o, nb) in offs.items()}
        self.host = {n: (t.view(torch.int16) if t.dtype == torch.bfloat16
                         else t).numpy() if not t.is_cuda else None
                     for n, t in self.leaves.items()}


class _StepState(NamedTuple):
    """A pooled step's inputs as one state, so ``capture_step`` gives
    every field a static buffer; the step returns ``params`` only."""

    params: Params
    client_keys: torch.Tensor | None = None
    W_sub: torch.Tensor | None = None
    idx: torch.Tensor | None = None
    key_q: torch.Tensor | None = None
    leaf_keys: torch.Tensor | None = None


class _EventState(NamedTuple):
    """The async pool's event inputs (see :class:`_StepState`)."""

    params: Params
    client_keys: torch.Tensor | None = None
    idx: torch.Tensor | None = None
    version: torch.Tensor | None = None
    ready: torch.Tensor | None = None
    valid: torch.Tensor | None = None
    ready_total: torch.Tensor | None = None
    key_q: torch.Tensor | None = None
    leaf_keys: torch.Tensor | None = None
    etas: torch.Tensor | None = None


def _leaf_shapes(pool: ClientPool) -> dict:
    return {n: (tuple(t.shape), pool._dtypes[n])
            for n, t in zip(pool.names, pool._template)}


# ---------------------------------------------------------------------------
# PooledRunner: the host loop with double-buffered prefetch
# ---------------------------------------------------------------------------

class PooledRunner:
    """Host orchestration of pooled synchronous rounds.

    A round: (1) cohort t's staged rows (prefetched last round, or fetched
    now); (2) slab rows for cohort t's first-time writers; (3) SUBMIT the
    prefetch of cohort t+1 to a worker thread; (4) the step on the compute
    stream; (5) write cohort t back to the pool; (6) join the prefetch;
    (7) PATCH the prefetched rows that cohort t+1 shares with t from round
    t's output, so the prefetch equals a fetch after the write-back bit
    for bit. The JAX package joins before its write-back; here the
    worker's gather runs under the write-back's scatter, the longest part
    of a round. Both copy rows with torch on the slabs' memory (the GIL
    released) and, after (2), the write-back moves no slot and no slab,
    so the worker reads other clients' rows where they stay; a row that
    both cohorts hold may be read half written, and (7) overwrites it.

    On the card the prefetch runs on a side stream: ``inputs`` (so the
    read of cohort t+1's ids waits for nothing of round t), the host
    gather into one of two pinned staging buffers, one copy to the card,
    the batches; the compute stream waits on its event. The step is one
    CUDA graph replay (``capture_step``, captured at the first round;
    ``capture=False`` keeps it eager). The write-back reads round t's
    output through a pinned buffer; the patch is a fixed-[k] scatter into
    the [k + 1]-row staging buffer whose spare row takes the rows cohort
    t+1 does not share. ``inputs`` stays eager: its only product the host
    waits for is the [k] id read, after a few tens of small launches.

    ``batch_fn(ids, t) -> batches`` gets the cohort's ids as an int64
    tensor [k] on the device (ascending) and returns leaves [k, K, ...]
    on the device. Key it on (client, t), never on the pool's versions:
    the prefetch of round t+1 runs while round t's write-back bumps them.

    ``telemetry=True`` builds the step with its in-graph telemetry and
    adds to each round's metrics its fields as host floats (one transfer)
    and the host's own: the whole population's ``consensus_dist``,
    ``pool_hit`` / ``pool_miss`` (cohort rows already held / read from
    the template), ``pool_materialized`` and ``pool_mbytes``. ``tracer``
    (a :class:`~repro_torch.telemetry.Tracer`) records the spans
    ``pool/prepare`` (on the thread that prepares), ``pool/step``,
    ``pool/writeback``, ``pool/join`` and ``pool/patch``; the step's span
    waits for the card only when the tracer is enabled.
    """

    def __init__(self, pool: ClientPool, psched: PoolSchedule,
                 loss_fn: LossFn, cfg: DFedAvgMConfig, batch_fn: Callable,
                 *, key: torch.Tensor, backend: str = "dense",
                 prefetch: bool = True, telemetry: bool = False,
                 tracer=None, device=None, capture: bool = True):
        if pool.m != psched.m:
            raise ValueError(f"pool has m={pool.m}, schedule {psched.m}")
        self.device = dev = resolve_device(device)
        self.pool, self.psched, self.cfg = pool, psched, cfg
        self.telemetry = bool(telemetry)
        if tracer is None:
            from ..telemetry.tracer import NULL_TRACER as tracer
        self.tracer = tracer
        self._rs = make_pooled_round_step(loss_fn, cfg, psched,
                                          pool.template, backend=backend,
                                          with_telemetry=self.telemetry,
                                          device=dev)
        self.rng = key.to(dev)
        self.t = 0
        self.batch_fn = batch_fn
        self.bits_per_round = psched.round_bits(pool.n_params, cfg.quant)
        self.comm_bits = 0.0
        self._pending = None
        self._exec = ThreadPoolExecutor(max_workers=1) if prefetch else None
        self._cuda = dev.type == "cuda"
        self._capture = capture and self._cuda
        self._run = None
        k = psched.cohort_size
        shapes = _leaf_shapes(pool)
        if self._cuda:
            self._side = torch.cuda.Stream(dev)
            self._host = [_Staging(shapes, k + 1, "cpu", pin=True)
                          for _ in range(2)]
            self._dev = [_Staging(shapes, k + 1, dev) for _ in range(2)]
            self._out = _Staging(shapes, k, "cpu", pin=True)
            self._ids = torch.empty(k, dtype=torch.int64, pin_memory=True)
            self._free = [torch.cuda.Event() for _ in range(2)]
            self._side.wait_stream(torch.cuda.current_stream(dev))
        else:
            self._host = self._dev = [_Staging(shapes, k + 1, "cpu")
                                      for _ in range(2)]

    def _stream(self):
        return (torch.cuda.stream(self._side) if self._cuda
                else contextlib.nullcontext())

    def _draw(self, rng: torch.Tensor, t: int) -> tuple[dict, np.ndarray]:
        """Cohort t's inputs and its ids on the host (the one read the host
        waits for; on the card it waits only for the side stream)."""
        inp = self._rs.inputs(rng, t)
        if not self._cuda:
            return inp, inp["idx"].numpy().copy()
        self._ids.copy_(inp["idx"], non_blocking=True)
        got = torch.cuda.Event()
        got.record(self._side)
        got.synchronize()
        return inp, self._ids.numpy().copy()

    def _gather(self, idx: np.ndarray, slot: int) -> None:
        """The cohort's rows from the slabs into staging buffer ``slot``."""
        self.pool.fetch_into(idx, self._host[slot].host)

    def _upload(self, slot: int) -> None:
        """Staging buffer ``slot`` to the card, one copy on the side stream
        once the step that last read its device buffer is done."""
        if self._cuda:
            self._side.wait_event(self._free[slot])
            self._dev[slot].buf.copy_(self._host[slot].buf,
                                      non_blocking=True)

    def _prepare(self, rng: torch.Tensor, t: int) -> dict:
        """Cohort t's inputs, rows (staging slot t % 2) and batches; on the
        card all on the side stream, ending in an event."""
        slot = t % 2
        k = self.psched.cohort_size
        with self.tracer.span("pool/prepare", t=t), self._stream():
            inp, idx = self._draw(rng, t)
            self._gather(idx, slot)
            self._upload(slot)
            batches = self.batch_fn(inp["idx"], t)
            ready = None
            if self._cuda:
                ready = torch.cuda.Event()
                ready.record(self._side)
        x = {n: v[:k] for n, v in self._dev[slot].leaves.items()}
        return {"inp": inp, "idx": idx, "slot": slot, "x": x,
                "batches": batches, "ready": ready}

    def _step_args(self, cur: dict) -> _StepState:
        inp = cur["inp"]
        return _StepState(params=cur["x"], client_keys=inp["client_keys"],
                          W_sub=inp["W_sub"], idx=inp["idx"],
                          key_q=inp["key_q"], leaf_keys=inp.get("leaf_keys"))

    def _state_step(self, s: _StepState, batches: Params):
        x_next, metrics = self._rs.step(s.params, batches, s.client_keys,
                                        s.W_sub, s.idx, s.key_q, s.leaf_keys)
        return _StepState(params=x_next), metrics

    def _step(self, cur: dict):
        if self._cuda:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(cur["ready"])
            for v in list(cur["inp"].values()) + list(
                    cur["batches"].values()):
                v.record_stream(compute)
        args = self._step_args(cur)
        if self._run is not None:
            out, metrics = self._run(args, cur["batches"])
        else:
            out, metrics = self._state_step(args, cur["batches"])
        if self._cuda:
            self._free[cur["slot"]].record(compute)
        return out.params, metrics

    def _copy_back(self, x_next: Params):
        """Start round t's output on its way to the pinned buffer (the
        compute stream, behind the step); returns what the write-back
        waits for."""
        if not self._cuda:
            return None
        for n, v in x_next.items():
            self._out.leaves[n].copy_(v, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return done

    def _writeback(self, cur: dict, x_next: Params, done) -> None:
        """Round t's rows into the slabs (versions bumped)."""
        if done is not None:
            done.synchronize()
        self.pool.writeback(cur["idx"],
                            self._out.host if done is not None else x_next)

    def _patch(self, cur: dict, nxt: dict, x_next: Params) -> None:
        """Cohort t+1's staged rows that cohort t shares take round t's
        output: a fixed-[k] scatter (both cohorts ascending) into the
        [k + 1]-row buffer, whose spare row takes the rest."""
        if self._cuda:
            torch.cuda.current_stream(self.device).wait_event(nxt["ready"])
        cur_j, nxt_j = cur["inp"]["idx"], nxt["inp"]["idx"]
        k = nxt_j.shape[0]
        pos = torch.clamp(torch.searchsorted(nxt_j, cur_j), 0, k - 1)
        p = torch.where(nxt_j[pos] == cur_j, pos, k)
        for n, buf in self._dev[nxt["slot"]].leaves.items():
            buf.index_copy_(0, p, x_next[n])

    def round(self) -> dict:
        """Run one pooled round; returns its metrics (0-dim tensors on the
        device; with ``telemetry`` also the host fields of the class
        docstring)."""
        cur = self._pending if self._pending is not None \
            else self._prepare(self.rng, self.t)
        self._pending = None
        if self._capture and self._run is None:
            # Before the worker starts: a capture must not overlap another
            # thread's CUDA calls.
            from .compiled import capture_step
            torch.cuda.current_stream(self.device).wait_event(cur["ready"])
            self._run = capture_step(self._state_step, self._step_args(cur),
                                     cur["batches"])
        if self.telemetry:     # before the slots the write-back reserves
            pool_hit = int((self.pool._slot[cur["idx"]] >= 0).sum())
        fut = None
        if self._exec is not None:
            self.pool._reserve(cur["idx"])
            fut = self._exec.submit(self._prepare, cur["inp"]["key_next"],
                                    self.t + 1)
        with self.tracer.span("pool/step", t=self.t):
            x_next, metrics = self._step(cur)
            if self.tracer.enabled and self._cuda:
                # Only when tracing: the span then covers the step's
                # device work (else the host runs ahead, as it does).
                torch.cuda.current_stream(self.device).synchronize()
        with self.tracer.span("pool/writeback"):
            done = self._copy_back(x_next)
            self._writeback(cur, x_next, done)
        with self.tracer.span("pool/join"):
            nxt = fut.result() if fut is not None else None
        if nxt is not None:
            with self.tracer.span("pool/patch"):
                self._patch(cur, nxt, x_next)
            self._pending = nxt
        self.rng = cur["inp"]["key_next"]
        self.t += 1
        self.comm_bits += self.bits_per_round
        if self.telemetry:
            from ..telemetry.metrics import telemetry_host
            metrics = dict(metrics)
            tel = metrics.pop("telemetry", None)
            if tel is not None:
                metrics.update(telemetry_host(tel))
            metrics.update(
                consensus_dist=self.pool.consensus_distance(),
                pool_hit=pool_hit,
                pool_miss=self.psched.cohort_size - pool_hit,
                pool_materialized=self.pool.materialized,
                pool_mbytes=self.pool.nbytes / 2**20)
        return metrics

    def run(self, n_rounds: int) -> list:
        return [self.round() for _ in range(n_rounds)]

    def close(self) -> None:
        """Join the prefetch's worker thread (the runner can still run
        rounds after, without prefetch)."""
        if self._exec is not None:
            self._exec.shutdown(wait=True)
            self._exec = None
            self._pending = None

    @property
    def graph(self):
        """The captured step's ``torch.cuda.CUDAGraph`` (None if eager)."""
        return None if self._run is None else self._run.graph

    # -- checkpoint interop ------------------------------------------------

    def save(self, ckpt_dir, step: int | None = None, keep: int = 3):
        """Checkpoint the pool, the key chain and the round counter (a
        prefetched buffer is a function of those and is rebuilt)."""
        return self.pool.save(
            ckpt_dir, self.t if step is None else step,
            extra={"rng": self.rng, "round": np.asarray(self.t, np.int64)},
            keep=keep)

    @classmethod
    def restore(cls, ckpt_dir, template: dict, psched: PoolSchedule,
                loss_fn: LossFn, cfg: DFedAvgMConfig, batch_fn: Callable,
                *, step: int | None = None, **kwargs) -> "PooledRunner":
        """Rebuild a runner mid-training; it continues bit for bit as the
        uninterrupted run (a checkpoint of either package)."""
        pool, extra, _ = ClientPool.restore(ckpt_dir, template, step=step)
        key = torch.from_numpy(np.asarray(extra["rng"]).astype(np.int64))
        runner = cls(pool, psched, loss_fn, cfg, batch_fn, key=key,
                     **kwargs)
        runner.t = int(extra["round"])
        runner.comm_bits = runner.bits_per_round * runner.t
        return runner


# ---------------------------------------------------------------------------
# Pooled asynchronous engine: ready-set cohorts
# ---------------------------------------------------------------------------

class PooledAsyncRunner:
    """Event-driven async gossip over a pooled population (dense mix).

    Each event materializes the READY clients and their graph neighbours
    (the closure: every client whose ``W_eff`` row is not ``e_i`` and
    every value those rows read), padded to the static ``capacity`` with
    the sentinel m. The event replays the resident
    ``make_async_round_step`` on that closure: the same key chain, the
    clock's durations drawn at the full width on the device,
    ``staleness_weights`` on the gathered versions, the eta decay through
    B3's lane entry, and a write-back of the ready lanes only. The read of
    the ready set is a host sync an event: the host must know which rows
    to fetch. On the card the event body is one CUDA graph replay,
    captured once at ``capacity``.

    ``spec`` (a :class:`MixingSpec`, small m) or ``ring_self_weight`` (the
    structural ring, any m) fixes the base W. ``batch_fn(ids, versions)
    -> batches`` gets int64 ids [capacity] and int32 versions [capacity]
    on the device (padded lanes repeat client m-1) and must key on the
    versions: padded and neighbour lanes train throwaway copies, as the
    resident engine trains busy lanes.

    ``telemetry=True`` adds the host's event telemetry to each event's
    metrics: ``cohort_size``, ``wire_bits``, the ``staleness_hist`` of
    the post-event versions, ``mean_staleness`` / ``max_staleness``,
    ``pool_materialized`` and ``pool_mbytes``. ``tracer`` records the
    spans ``pool/fetch``, ``pool/step`` (waiting for the card only when
    enabled) and ``pool/writeback``.
    """

    def __init__(self, pool: ClientPool, loss_fn: LossFn,
                 cfg: DFedAvgMConfig, async_cfg: AsyncConfig,
                 batch_fn: Callable, *, key: torch.Tensor, capacity: int,
                 spec: MixingSpec | None = None,
                 ring_self_weight: float | None = None,
                 telemetry: bool = False, tracer=None, device=None,
                 capture: bool = True):
        if (spec is None) == (ring_self_weight is None):
            raise ValueError("pass exactly one of spec / ring_self_weight")
        self.device = dev = resolve_device(device)
        self.pool, self.cfg, self.async_cfg = pool, cfg, async_cfg
        self.batch_fn = batch_fn
        self.telemetry = bool(telemetry)
        if tracer is None:
            from ..telemetry.tracer import NULL_TRACER as tracer
        self.tracer = tracer
        m = self.m = pool.m
        C = self.capacity = int(capacity)
        self._spec_W = (torch.as_tensor(spec.W, dtype=torch.float32,
                                        device=dev)
                        if spec is not None else None)
        self._adj_np = (np.asarray(spec.graph.adj, bool)
                        if spec is not None else None)
        self._sw = ring_self_weight
        quant = cfg.quant
        self._stochastic_q = (quant is not None and quant.enabled
                              and quant.stochastic)
        self._n_leaves = len(pool.names)

        # init_async_state's clock chain, on the device
        self.rng = key.to(dev)
        k_dur, self.clock_rng = prng.split(
            prng.fold_in(self.rng, _CLOCK_SALT))
        speed = async_cfg.speed
        if not speed.is_constant:
            speed.multipliers_on(m, dev)
        self.next_ready = speed.draw(k_dur, m)
        self.version = torch.zeros(m, dtype=torch.int32, device=dev)
        self.clock = 0.0
        self.round = 0

        eta_decay = async_cfg.eta_staleness_decay
        eyeC = torch.eye(C, dtype=torch.float32, device=dev)
        off_diag = 1.0 - eyeC
        if ring_self_weight is not None:
            w_nb = float(np.float32((1.0 - self._sw)
                                    / (2.0 if m > 2 else 1.0)))
            self_w = float(np.float32(self._sw)) * eyeC

        def event_body(s: _EventState, batches: Params):
            eta = s.etas if eta_decay > 0.0 else cfg.eta
            z_sub, losses = local_train(loss_fn, s.params, batches,
                                        s.client_keys, eta=eta,
                                        theta=cfg.theta)
            both = s.valid[:, None] * s.valid[None, :]
            if self._spec_W is not None:
                safe = torch.clamp(s.idx, max=m - 1)
                W_base = self._spec_W[safe][:, safe] * both
            else:
                d = (s.idx[:, None] - s.idx[None, :]) % m
                ring = (d == 1) | (d == m - 1) if m > 2 else (d == 1)
                W_base = ring.to(torch.float32) * both * w_nb + self_w
            v_next = s.version + s.ready.to(torch.int32)
            W_eff = staleness_weights(W_base, v_next, s.ready, async_cfg)
            z_eff = {n: torch.where(s.ready.reshape(
                (-1,) + (1,) * (z.dim() - 1)) > 0, z, s.params[n])
                for n, z in z_sub.items()}
            if quant is None or not quant.enabled:
                x_next = mix_dense(W_eff, z_eff)
            else:
                x_next = _mix_dense_quantized(W_eff, s.params, z_eff, quant,
                                              s.key_q,
                                              leaf_keys=s.leaf_keys)
            metrics = {"loss": (losses * s.ready).sum() / s.ready_total,
                       "live_edges": ((W_eff * off_diag) != 0.0).sum()}
            return _EventState(params=x_next), metrics

        self._body = event_body
        self._capture = capture and dev.type == "cuda"
        self._run = None
        shapes = _leaf_shapes(pool)
        if dev.type == "cuda":
            self._host = _Staging(shapes, C, "cpu", pin=True)
            self._dev = _Staging(shapes, C, dev)
            self._out = _Staging(shapes, C, "cpu", pin=True)
            self._ids = torch.empty(C, dtype=torch.int64, pin_memory=True)
        else:
            self._host = self._dev = self._out = _Staging(shapes, C, "cpu")
            self._ids = torch.empty(C, dtype=torch.int64)

    def _neighbors(self, ids: np.ndarray) -> np.ndarray:
        if self._adj_np is not None:
            return np.nonzero(self._adj_np[ids].any(axis=0))[0]
        if self.m == 2:
            return 1 - ids
        return np.concatenate([(ids - 1) % self.m, (ids + 1) % self.m])

    @property
    def graph(self):
        """The captured event's ``torch.cuda.CUDAGraph`` (None if eager)."""
        return None if self._run is None else self._run.graph

    def step_event(self) -> dict:
        """Process one event; returns its metrics (``loss``, ``clock``
        and ``live_edges`` as 0-dim device tensors, ``ready_frac`` a host
        float)."""
        m, C, dev = self.m, self.capacity, self.device
        key_round, key_mix, key_next = prng.split(self.rng, 3)
        t_now, ready = next_event(self.next_ready)
        ready_ids = torch.nonzero(ready)[:, 0].cpu().numpy()
        cohort = np.unique(np.concatenate(
            [ready_ids, self._neighbors(ready_ids)]))
        if cohort.size > C:
            raise RuntimeError(
                f"async cohort of {cohort.size} clients exceeds the "
                f"resident capacity {C}; raise capacity (many clients "
                f"fired simultaneously — e.g. a constant speed model "
                f"needs capacity = m)")
        idx = np.full(C, m, np.int64)
        idx[:cohort.size] = cohort
        safe = np.minimum(idx, m - 1)

        with self.tracer.span("pool/fetch", event=self.round):
            self.pool.fetch_into(safe, self._host.host)
            self._ids.numpy()[:] = idx
            if dev.type == "cuda":
                self._dev.buf.copy_(self._host.buf, non_blocking=True)
                idx_d = self._ids.to(dev, non_blocking=True)
            else:
                idx_d = self._ids.clone()
        safe_d = torch.clamp(idx_d, max=m - 1)
        valid = (idx_d < m).to(torch.float32)
        ready_sub = ready[safe_d] * valid
        v_sub = self.version[safe_d]
        batches = self.batch_fn(safe_d, v_sub)
        key_q = key_mix        # a static spec: no topology split
        etas = None
        if self.async_cfg.eta_staleness_decay > 0.0:
            etas = staleness_eta(self.cfg.eta, self.version,
                                 self.async_cfg.eta_staleness_decay)[safe_d]
        s = _EventState(
            params=dict(self._dev.leaves),
            client_keys=prng.split(key_round, m)[safe_d], idx=idx_d,
            version=v_sub, ready=ready_sub, valid=valid,
            ready_total=ready.sum(), key_q=key_q,
            leaf_keys=(_quant_leaf_keys(key_q, self._n_leaves, m)[
                :, safe_d].contiguous() if self._stochastic_q else None),
            etas=etas)
        if self._capture and self._run is None:
            from .compiled import capture_step
            self._run = capture_step(self._body, s, batches)
        with self.tracer.span("pool/step", event=self.round):
            out, metrics = (self._run or self._body)(s, batches)
            if self.tracer.enabled and dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()

        # advance the full-width clock state (the resident chain)
        self.version = self.version + ready.to(torch.int32)
        k_dur, self.clock_rng = prng.split(self.clock_rng)
        durations = self.async_cfg.speed.draw(k_dur, m)
        self.next_ready = torch.where(ready > 0, t_now + durations,
                                      self.next_ready)

        with self.tracer.span("pool/writeback"):
            if dev.type == "cuda":
                for n, v in out.params.items():
                    self._out.leaves[n].copy_(v, non_blocking=True)
                torch.cuda.current_stream(dev).synchronize()
                rows = self._out.host
            else:
                rows = out.params
            wmask = np.isin(safe, ready_ids) & (idx < m)
            self.pool.writeback(idx, rows, mask=wmask)
        self.clock = float(t_now)
        self.rng = key_next
        self.round += 1
        metrics = dict(metrics)
        metrics["clock"] = t_now
        metrics["ready_frac"] = float(ready_ids.size / m)
        if self.telemetry:
            # The host-side event telemetry (the clock and versions live
            # outside the captured body): one transfer of the versions
            # and the event's live-edge count.
            S = self.async_cfg.max_staleness
            host = torch.cat([self.version.to(torch.int64),
                              metrics["live_edges"].reshape(1).to(
                                  torch.int64)]).cpu().numpy()
            version, live = host[:-1], float(host[-1])
            lag = version.max() - version
            metrics.update(
                cohort_size=int(cohort.size),
                wire_bits=float(message_bits(
                    self.pool.n_params,
                    self.cfg.quant or QuantConfig(bits=32)) * live),
                staleness_hist=[int(c) for c in np.bincount(
                    np.clip(lag, 0, S + 1), minlength=S + 2)],
                mean_staleness=float(lag.mean()),
                max_staleness=int(lag.max()),
                pool_materialized=self.pool.materialized,
                pool_mbytes=self.pool.nbytes / 2**20)
        return metrics

    def run(self, n_events: int) -> list:
        return [self.step_event() for _ in range(n_events)]
