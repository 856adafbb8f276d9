"""GossipPlan: the permutation-step program of one gossip round — the
static part of the JAX package's ``core/gossip_plan.py``, numpy for numpy.

    x'(i) = w_self(i) * z(i) + sum_k w_k(i) * z(src_k(i))

Each step k is a full permutation ``src_k`` of the m clients. On a mesh
the JAX package realizes a step as one ``ppermute``; on one device the
port realizes it as an index gather. ``src_k(i) == i`` marks an idle slot
(no wire, weight forced to 0).

Invariants (as in the JAX package):

  * EXACT EDGE COVER: every directed support edge appears in exactly one
    step (``_check_exact_cover``), so a gathered weight is applied once.
  * Ring steps are the two cyclic shifts, torus steps the four axis
    shifts; any other graph lowers to greedy matchings (involutions).

A static spec bakes its weights into the plan (``plan_from_spec``,
``plan_from_matrix``); a schedule's plan is structure only
(``plan_from_support``) and each round gathers its weights from the
sampled ``W_t`` on the device (``gather_weights``).

BLOCK SHARDING: on a client mesh of ``n_shards`` shards, shard ``s``
holds the contiguous lane block ``[s * m_local, (s+1) * m_local)``.
:meth:`GossipPlan.block_plan` splits every step into intra-shard lane
gathers (no wire) and boundary sub-steps at shard granularity
(:class:`BlockPlan`); a :class:`Placement` (``compute_placement``)
relabels lanes so that fewer edges cross a shard boundary
(:meth:`GossipPlan.placed`). All of it is numpy, the reference's own
code, so plans and placements equal the JAX package's exactly.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["GossipPlan", "BlockSubStep", "BlockPlan", "Placement",
           "compile_block_plan", "compute_placement", "plan_from_spec",
           "plan_from_support", "plan_from_matrix", "ring_steps",
           "torus_steps", "matching_steps"]


@dataclasses.dataclass(frozen=True)
class GossipPlan:
    """Permutation-step program for one gossip round.

    src:     [n_steps, m] int32 — in step k, client i receives from
             ``src[k, i]``; ``src[k, i] == i`` is an idle slot.
    w_self / w_steps: static weights (diag(W) and W[i, src[k, i]]),
             present when compiled from a static MixingSpec; None for a
             schedule's plan, whose weights are gathered each round.
    lane_to_client: [m] int32 — set on PLACED plans (:meth:`placed`):
             lane ``p`` carries original client ``lane_to_client[p]``;
             ``None`` is the identity. ``src`` and the static weights of
             a placed plan are in lane space; a weight gather from a
             client-space ``W_t`` maps both endpoints through it.
    """

    m: int
    src: np.ndarray
    name: str = "plan"
    w_self: np.ndarray | None = None      # [m] float64
    w_steps: np.ndarray | None = None     # [n_steps, m] float64
    lane_to_client: np.ndarray | None = None  # [m] int32, placed plans

    def __post_init__(self):
        src = np.asarray(self.src, dtype=np.int32)
        if src.ndim != 2 or src.shape[1] != self.m:
            raise ValueError(f"src must be [n_steps, {self.m}], "
                             f"got {src.shape}")
        ref = np.arange(self.m)
        for k in range(src.shape[0]):
            if not np.array_equal(np.sort(src[k]), ref):
                raise ValueError(f"step {k} is not a permutation of "
                                 f"range({self.m})")
        object.__setattr__(self, "src", src)
        if self.lane_to_client is not None:
            lane = np.asarray(self.lane_to_client, np.int32)
            if not np.array_equal(np.sort(lane), ref):
                raise ValueError("lane_to_client must be a permutation "
                                 f"of range({self.m})")
            object.__setattr__(self, "lane_to_client", lane)
        if (self.w_self is None) != (self.w_steps is None):
            raise ValueError("w_self and w_steps must be set together")
        if self.w_self is not None:
            ws = np.asarray(self.w_self, np.float64)
            wk = np.asarray(self.w_steps, np.float64)
            if ws.shape != (self.m,) or wk.shape != src.shape:
                raise ValueError("static weight shapes do not match plan")
            object.__setattr__(self, "w_self", ws)
            object.__setattr__(self, "w_steps", wk)

    @property
    def n_steps(self) -> int:
        return int(self.src.shape[0])

    @property
    def is_static(self) -> bool:
        return self.w_self is not None

    @property
    def num_directed_wire_edges(self) -> int:
        """Directed messages ONE round of the plan moves — what
        :func:`~repro_torch.core.comm_cost.plan_round_bits` bills."""
        return int((self.src != np.arange(self.m)[None, :]).sum())

    @property
    def max_degree(self) -> int:
        return int((self.src != np.arange(self.m)[None, :])
                   .sum(axis=0).max(initial=0))

    def wire_pairs(self, k: int) -> list[tuple[int, int]]:
        """(source, target) pairs step k actually moves (idle slots
        dropped)."""
        return [(int(self.src[k, i]), i) for i in range(self.m)
                if int(self.src[k, i]) != i]

    def gather_weights(self, W) -> tuple[torch.Tensor, torch.Tensor]:
        """W [m, m] -> (w_self [m], w_steps [n_steps, m]) as f32 on W's
        device, idle slots forced to weight 0: the per-round weights of a
        time-varying W_t. ``W`` is a tensor (used where it lies) or numpy
        (taken to the CPU). A placed plan reads ``W`` in client space:
        lane p's step-k weight is ``W[client(p), client(src[k, p])]``."""
        Wt = torch.as_tensor(W).to(torch.float32)
        idx = torch.arange(self.m, device=Wt.device)
        src = torch.as_tensor(self.src, device=Wt.device).to(torch.int64)
        if self.lane_to_client is None:
            w_self = Wt[idx, idx]
            w_steps = Wt[idx[None, :], src]
        else:
            lane = torch.as_tensor(self.lane_to_client,
                                   device=Wt.device).to(torch.int64)
            w_self = Wt[lane, lane]
            w_steps = Wt[lane[None, :], lane[src]]
        w_steps = torch.where(src == idx[None, :], 0.0, w_steps)
        return w_self, w_steps

    def static_weights(self) -> tuple[np.ndarray, np.ndarray]:
        if not self.is_static:
            raise ValueError(f"plan {self.name!r} has no static weights")
        return self.w_self, self.w_steps

    def as_matrix(self) -> np.ndarray:
        """The dense W a static plan realizes (exact: the weights were
        gathered from it). A placed plan reconstructs in client space, so
        ``as_matrix`` does not depend on the placement."""
        w_self, w_steps = self.static_weights()
        lane = (np.arange(self.m) if self.lane_to_client is None
                else self.lane_to_client)
        W = np.zeros((self.m, self.m), dtype=np.float64)
        W[lane, lane] = w_self
        for k in range(self.n_steps):
            for p in range(self.m):
                j = int(self.src[k, p])
                if j != p:
                    W[lane[p], lane[j]] += w_steps[k, p]
        return W

    def placed(self, placement: "Placement | None") -> "GossipPlan":
        """Apply a :class:`Placement`: relabel every step by conjugation
        (``src'[k, p] = inv[src[k, perm[p]]]``) and permute static
        weights, so lane ``p`` carries original client ``perm[p]`` and
        the block compiler's contiguous blocks ARE the partition's
        blocks. Step order and each lane's accumulation order are
        preserved exactly — a placed lane computes bit-identical
        arithmetic to its original client. ``None`` returns ``self``."""
        if placement is None:
            return self
        if placement.m != self.m:
            raise ValueError(f"placement is over m={placement.m}, "
                             f"plan has m={self.m}")
        if self.lane_to_client is not None:
            raise ValueError(f"plan {self.name!r} is already placed")
        perm, inv = placement.perm, placement.inv
        src_p = inv[self.src[:, perm]]
        w_self = None if self.w_self is None else self.w_self[perm]
        w_steps = None if self.w_steps is None else self.w_steps[:, perm]
        return GossipPlan(m=self.m, src=src_p,
                          name=f"{self.name}@{placement.name}",
                          w_self=w_self, w_steps=w_steps,
                          lane_to_client=perm.copy())

    def block_plan(self, n_shards: int,
                   placement: "Placement | None" = None) -> "BlockPlan":
        """Compile this plan for a mesh of ``n_shards`` shards, each
        holding a contiguous block of ``m // n_shards`` clients — see
        :func:`compile_block_plan`. A :class:`Placement` relabels lanes
        first (:meth:`placed`); default None keeps the contiguous
        client -> lane identity."""
        return compile_block_plan(self, n_shards, placement=placement)


# ---------------------------------------------------------------------------
# Block-sharded realization: m_local clients per shard
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BlockSubStep:
    """One shard-level transfer of a plan step's boundary lanes (the
    reference's masked ``ppermute``; a device copy a pair in the port).

    pairs:      (src_shard, dst_shard) device pairs — a partial
                permutation (each shard sends to at most one shard and
                receives from at most one shard).
    width:      lanes in the permuted buffer (the widest pair; narrower
                pairs pad with lane 0 / drop on scatter).
    send_lanes: [n_shards, width] int32 — local lanes shard s packs into
                its send buffer (0-padded; non-senders pack lane 0 and
                the collective discards it).
    recv_lanes: [n_shards, width] int32 — destination local lane of each
                received buffer row on shard s; ``m_local`` marks a
                padded row (scattered with mode="drop").
    """

    pairs: tuple
    width: int
    send_lanes: np.ndarray
    recv_lanes: np.ndarray


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """A :class:`GossipPlan` partitioned for block-sharded clients.

    Step ``k``'s receive ``recv(i) = z(src[k, i])`` decomposes per shard
    into an intra-shard lane gather (``intra_src``) plus zero or more
    :class:`BlockSubStep` boundary ``ppermute``s; lanes a sub-step fills
    overwrite the (identity) intra gather, and idle lanes keep weight 0,
    so one weighted accumulation per step consumes both halves.

    intra_src: [n_steps, n_shards, m_local] int32 — local source lane of
               lane ``l`` on shard ``s`` (identity at inter-shard / idle
               lanes).
    substeps:  per-step tuples of :class:`BlockSubStep`.
    """

    m: int
    n_shards: int
    m_local: int
    intra_src: np.ndarray
    substeps: tuple

    @property
    def n_steps(self) -> int:
        return int(self.intra_src.shape[0])

    @property
    def num_wire_lane_slots(self) -> int:
        """Total boundary lanes ONE round actually ships across shards —
        ``sum_k sum_u width_u * len(pairs_u)`` (padded slots included).
        The block-sharded analogue of ``num_directed_wire_edges``: for a
        contiguous-blocked ring this is ``2 * n_shards`` regardless of
        ``m``, the O(n_shards * boundary_degree) wire bound."""
        return int(sum(sub.width * len(sub.pairs)
                       for subs in self.substeps for sub in subs))

    @property
    def num_collectives(self) -> int:
        """Sub-steps per round (the reference's ppermute launches; the
        port issues one copy a sub-step and (src, dst) pair) —
        intra-shard traffic launches none."""
        return int(sum(len(subs) for subs in self.substeps))


def compile_block_plan(plan: GossipPlan, n_shards: int,
                       placement: "Placement | None" = None) -> BlockPlan:
    """Partition ``plan`` for a mesh whose shard ``s`` holds the
    contiguous client block ``[s * m_local, (s+1) * m_local)``.

    Per step, inter-shard lanes are grouped by (src_shard, dst_shard)
    pair and the pairs greedily colored into partial shard permutations
    (each color = one masked ``ppermute``); pairs are seeded widest-first
    so buffers of similar width share a launch and padding stays small.
    Locality is free by construction: edges that stay inside a block
    never touch the wire. An optional :class:`Placement` relabels lanes
    before blocking (``plan.placed(placement)``), so the partition's
    blocks — not the raw client-id blocks — become the contiguous
    shards.
    """
    if placement is not None:
        plan = plan.placed(placement)
    m = plan.m
    if n_shards < 1 or m % n_shards:
        raise ValueError(f"plan m={m} does not block over {n_shards} shards")
    m_local = m // n_shards
    intra = np.tile(np.arange(m_local, dtype=np.int32),
                    (plan.n_steps, n_shards, 1))
    all_substeps = []
    for k in range(plan.n_steps):
        by_pair: dict[tuple[int, int], list[tuple[int, int]]] = {}
        for i in range(m):
            j = int(plan.src[k, i])
            if j == i:
                continue
            s_dst, l_dst = divmod(i, m_local)
            s_src, l_src = divmod(j, m_local)
            if s_src == s_dst:
                intra[k, s_dst, l_dst] = l_src
            else:
                by_pair.setdefault((s_src, s_dst), []).append((l_src, l_dst))
        # Greedy color the shard-pair multigraph into partial permutations.
        # {pairs: {(s_src, s_dst): lanes}, src: set, dst: set}
        colors: list[dict] = []
        for (s_src, s_dst), lanes in sorted(
                by_pair.items(), key=lambda kv: -len(kv[1])):
            for c in colors:
                if s_src not in c["src"] and s_dst not in c["dst"]:
                    break
            else:
                c = {"pairs": {}, "src": set(), "dst": set()}
                colors.append(c)
            c["pairs"][(s_src, s_dst)] = lanes
            c["src"].add(s_src)
            c["dst"].add(s_dst)
        substeps = []
        for c in colors:
            width = max(len(v) for v in c["pairs"].values())
            send = np.zeros((n_shards, width), np.int32)
            recv = np.full((n_shards, width), m_local, np.int32)  # drop
            for (s_src, s_dst), lanes in c["pairs"].items():
                for b, (l_src, l_dst) in enumerate(lanes):
                    send[s_src, b] = l_src
                    recv[s_dst, b] = l_dst
            substeps.append(BlockSubStep(
                pairs=tuple(sorted(c["pairs"])), width=width,
                send_lanes=send, recv_lanes=recv))
        all_substeps.append(tuple(substeps))
    return BlockPlan(m=m, n_shards=n_shards, m_local=m_local,
                     intra_src=intra, substeps=tuple(all_substeps))


# ---------------------------------------------------------------------------
# Placement: locality-aware client -> lane relabeling
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Placement:
    """A compile-time client -> lane relabeling for block sharding.

    perm: [m] int32 — lane ``p`` carries original client ``perm[p]``
          (the gather order for everything client-indexed entering the
          round step: params, batches, per-client PRNG keys).
    inv:  [m] int32 — derived inverse: client ``c`` lives at lane
          ``inv[c]`` (and therefore on shard ``inv[c] // m_local``).

    Applied once at plan compile (:meth:`GossipPlan.placed`); execution
    is bitwise identical to the unplaced layout — only which edges cross
    a shard boundary (and therefore the wire bill) changes.
    """

    perm: np.ndarray
    n_shards: int
    name: str = "partition"
    inv: np.ndarray | None = None        # derived in __post_init__

    def __post_init__(self):
        perm = np.asarray(self.perm, np.int32)
        m = perm.shape[0]
        if not np.array_equal(np.sort(perm), np.arange(m)):
            raise ValueError(f"placement perm must be a permutation of "
                             f"range({m})")
        if self.n_shards < 1 or m % self.n_shards:
            raise ValueError(f"m={m} does not block over "
                             f"{self.n_shards} shards")
        inv = np.empty(m, np.int32)
        inv[perm] = np.arange(m, dtype=np.int32)
        object.__setattr__(self, "perm", perm)
        object.__setattr__(self, "inv", inv)

    @property
    def m(self) -> int:
        return int(self.perm.shape[0])

    @property
    def m_local(self) -> int:
        return self.m // self.n_shards

    @property
    def is_identity(self) -> bool:
        return bool(np.array_equal(self.perm, np.arange(self.m)))

    def shard_of(self) -> np.ndarray:
        """[m] int32 — shard each ORIGINAL client id lands on."""
        return (self.inv // self.m_local).astype(np.int32)

    def boundary_edges(self, adj) -> int:
        """Directed support edges crossing a shard boundary under this
        placement — the placed analogue of
        ``Graph.block_boundary_edges``."""
        shard = self.shard_of()
        a = np.asarray(adj, dtype=bool)
        return int((a & (shard[:, None] != shard[None, :])).sum())

    @staticmethod
    def contiguous(m: int, n_shards: int) -> "Placement":
        """The identity placement — the blind ``c // m_local`` split
        every plan gets by default."""
        return Placement(perm=np.arange(m, dtype=np.int32),
                         n_shards=n_shards, name="contiguous")


def _grow_blocks(adj: np.ndarray, deg: np.ndarray, n_shards: int,
                 m_local: int, rot: int) -> np.ndarray:
    """Greedy BFS block growing (GGGP): seed each block at a peripheral
    unassigned vertex (min degree, rotated by ``rot`` across restarts)
    and grow it by repeatedly absorbing the unassigned vertex with the
    most links into the block (ties: fewest external links, then lowest
    id — fully deterministic)."""
    m = adj.shape[0]
    assign = np.full(m, -1, np.int32)
    for b in range(n_shards):
        un = np.nonzero(assign < 0)[0]
        order = un[np.lexsort((un, deg[un]))]      # min degree, min id
        seed = int(order[rot % len(order)])
        assign[seed] = b
        conn = adj[seed].astype(np.int64)          # links into block b
        for _ in range(m_local - 1):
            cand = np.nonzero(assign < 0)[0]
            g = conn[cand]
            # max gain, then min external degree, then min id
            best = int(cand[np.lexsort((cand, deg[cand] - g, -g))[0]])
            assign[best] = b
            conn = conn + adj[best]
    return assign


def _kl_refine(adj: np.ndarray, assign: np.ndarray, n_shards: int,
               passes: int) -> np.ndarray:
    """Kernighan-Lin-style refinement: greedy pairwise swaps between
    blocks, accepting any swap that STRICTLY reduces the cut (block
    sizes stay balanced by construction), until a full pass finds no
    improving swap or ``passes`` passes elapse."""
    m = adj.shape[0]
    assign = assign.copy()
    A = adj.astype(np.int64)
    # conn[i, b] = links of vertex i into block b
    conn = np.stack([A[:, assign == b].sum(axis=1)
                     for b in range(n_shards)], axis=1)
    for _ in range(passes):
        improved = False
        for u in range(m):
            for v in range(u + 1, m):
                a, b = int(assign[u]), int(assign[v])
                if a == b:
                    continue
                gain = (conn[u, b] - conn[u, a]
                        + conn[v, a] - conn[v, b] - 2 * A[u, v])
                if gain > 0:                       # cut drops by gain
                    assign[u], assign[v] = b, a
                    conn[:, a] += A[:, v] - A[:, u]
                    conn[:, b] += A[:, u] - A[:, v]
                    improved = True
        if not improved:
            break
    return assign


def _cut(adj: np.ndarray, assign: np.ndarray) -> int:
    return int((adj & (assign[:, None] != assign[None, :])).sum())


def compute_placement(graph, n_shards: int, *, restarts: int = 3,
                      refine_passes: int = 8) -> Placement:
    """Partition a support graph into ``n_shards`` balanced
    ``m_local``-blocks minimizing the directed boundary cut, and return
    the lane :class:`Placement` realizing it.

    ``graph`` is a ``topology.Graph`` or a boolean adjacency matrix
    (symmetrized; the cut it minimizes is the DIRECTED boundary edge
    count, i.e. 2x the undirected crossing edges). Candidates — the
    contiguous identity plus ``restarts`` greedy-BFS block growings
    (:func:`_grow_blocks`) — are each refined with strict-improvement KL
    swaps (:func:`_kl_refine`); the best final cut wins, with the
    contiguous candidate first, so the result is NEVER worse than the
    blind contiguous split (rings/tori keep their optimal layout). Pure
    numpy, deterministic, O(restarts * passes * m^2) at compile time —
    fine for resident populations (m up to a few thousand)."""
    adj = np.asarray(getattr(graph, "adj", graph), dtype=bool).copy()
    adj |= adj.T
    np.fill_diagonal(adj, False)
    m = adj.shape[0]
    if n_shards < 1 or m % n_shards:
        raise ValueError(f"m={m} does not block over {n_shards} shards")
    m_local = m // n_shards
    if n_shards == 1 or m_local == 1:
        # One block, or one client per shard: every balanced assignment
        # has the same cut — keep the identity.
        return Placement(perm=np.arange(m, dtype=np.int32),
                         n_shards=n_shards)
    deg = adj.sum(axis=1).astype(np.int64)
    contiguous = (np.arange(m) // m_local).astype(np.int32)
    candidates = [contiguous] + [
        _grow_blocks(adj, deg, n_shards, m_local, rot)
        for rot in range(restarts)]
    best_assign, best_cut = None, None
    for cand in candidates:
        refined = _kl_refine(adj, cand, n_shards, refine_passes)
        cut = _cut(adj, refined)
        if best_cut is None or cut < best_cut:
            best_assign, best_cut = refined, cut
    perm = np.concatenate([np.nonzero(best_assign == b)[0]
                           for b in range(n_shards)]).astype(np.int32)
    return Placement(perm=perm, n_shards=n_shards)


def ring_steps(m: int) -> np.ndarray:
    """Ring decomposition: receive-from-left, receive-from-right (which
    coincide at m == 2 — one step)."""
    if m < 2:
        raise ValueError("ring plan needs m >= 2")
    left = np.array([(i - 1) % m for i in range(m)], np.int32)
    if m == 2:
        return left[None, :]
    right = np.array([(i + 1) % m for i in range(m)], np.int32)
    return np.stack([left, right])


def torus_steps(rows: int, cols: int) -> np.ndarray:
    """Torus decomposition: row shifts then column shifts, +-1 each (a
    length-2 axis has coinciding +-1 shifts: one step, so every directed
    edge is covered exactly once)."""
    m = rows * cols

    def idx(r, c):
        return (r % rows) * cols + (c % cols)

    steps = []
    for s in (1, -1) if rows > 2 else ((1,) if rows == 2 else ()):
        steps.append(np.array([idx(i // cols + s, i % cols)
                               for i in range(m)], np.int32))
    for s in (1, -1) if cols > 2 else ((1,) if cols == 2 else ()):
        steps.append(np.array([idx(i // cols, i % cols + s)
                               for i in range(m)], np.int32))
    if not steps:
        raise ValueError(f"degenerate torus {rows}x{cols}")
    return np.stack(steps)


def matching_steps(adj: np.ndarray) -> np.ndarray:
    """Greedy edge coloring of an arbitrary adjacency into matchings —
    each color class is an involution permutation. Uses at most
    2*max_degree - 1 colors."""
    a = np.asarray(adj, dtype=bool)
    m = a.shape[0]
    ii, jj = np.nonzero(np.triu(a, k=1))
    colors_at = [set() for _ in range(m)]
    steps: list[np.ndarray] = []
    for i, j in zip(ii.tolist(), jj.tolist()):
        c = 0
        while c in colors_at[i] or c in colors_at[j]:
            c += 1
        while c >= len(steps):
            steps.append(np.arange(m, dtype=np.int32))
        steps[c][i], steps[c][j] = j, i
        colors_at[i].add(c)
        colors_at[j].add(c)
    if not steps:  # edgeless support: a single idle step keeps shapes sane
        steps = [np.arange(m, dtype=np.int32)]
    return np.stack(steps)


def _check_exact_cover(src: np.ndarray, adj: np.ndarray) -> None:
    """Every directed edge of ``adj`` must appear exactly once across the
    steps (double coverage would double-count gathered weights)."""
    m = src.shape[1]
    count = np.zeros((m, m), dtype=np.int64)
    for k in range(src.shape[0]):
        rows = np.nonzero(src[k] != np.arange(m))[0]
        np.add.at(count, (rows, src[k][rows]), 1)
    if not np.array_equal(count, np.asarray(adj, dtype=np.int64)):
        raise ValueError("plan steps do not cover the support graph's "
                         "directed edges exactly once")


def _steps_for_graph(graph, kind: str | None,
                     torus_shape: tuple[int, int] | None) -> np.ndarray:
    if kind == "ring":
        return ring_steps(graph.m)
    if kind == "torus":
        return torus_steps(*torus_shape)
    return matching_steps(graph.adj)


def _baked(src: np.ndarray, W: np.ndarray, name: str) -> GossipPlan:
    """A static plan of ``src`` with its weights gathered from ``W``."""
    W = np.asarray(W, np.float64)
    m = W.shape[0]
    w_self = np.diag(W).copy()
    w_steps = W[np.arange(m)[None, :], src].copy()
    w_steps[src == np.arange(m)[None, :]] = 0.0
    return GossipPlan(m=m, src=src, name=name, w_self=w_self,
                      w_steps=w_steps)


def plan_from_spec(spec) -> GossipPlan:
    """Static MixingSpec -> plan with baked weights gathered from spec.W
    (ring and torus use their shifts; any other graph uses matchings)."""
    src = _steps_for_graph(spec.graph, spec.kind, spec.torus_shape)
    _check_exact_cover(src, spec.graph.adj)
    return _baked(src, spec.W, f"plan[{spec.graph.name}]")


def plan_from_matrix(W: np.ndarray, name: str = "matrix") -> GossipPlan:
    """Dense mixing matrix -> static plan over its own support
    (matchings) with baked weights: a cycle's plan for one member."""
    W = np.asarray(W, np.float64)
    adj = (W - np.diag(np.diag(W))) != 0
    src = matching_steps(adj)
    _check_exact_cover(src, adj)
    return _baked(src, W, f"plan[{name}]")


def plan_from_support(graph, name: str = "support",
                      kind: str | None = None,
                      torus_shape: tuple[int, int] | None = None
                      ) -> GossipPlan:
    """Support graph (a schedule's union of possible edges) ->
    structure-only plan; the weights are gathered from each round's W_t."""
    src = _steps_for_graph(graph, kind, torus_shape)
    _check_exact_cover(src, graph.adj)
    return GossipPlan(m=graph.m, src=src, name=f"plan[{name}]")
