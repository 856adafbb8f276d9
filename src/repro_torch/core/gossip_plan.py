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

Block sharding and placement (``block_plan``, ``placed``, ``Placement``)
wait for the multi-device slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["GossipPlan", "plan_from_spec", "plan_from_support",
           "plan_from_matrix", "ring_steps", "torus_steps",
           "matching_steps"]


@dataclasses.dataclass(frozen=True)
class GossipPlan:
    """Permutation-step program for one gossip round.

    src:     [n_steps, m] int32 — in step k, client i receives from
             ``src[k, i]``; ``src[k, i] == i`` is an idle slot.
    w_self / w_steps: static weights (diag(W) and W[i, src[k, i]]),
             present when compiled from a static MixingSpec; None for a
             schedule's plan, whose weights are gathered each round.
    """

    m: int
    src: np.ndarray
    name: str = "plan"
    w_self: np.ndarray | None = None      # [m] float64
    w_steps: np.ndarray | None = None     # [n_steps, m] float64

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
        (taken to the CPU)."""
        Wt = torch.as_tensor(W).to(torch.float32)
        idx = torch.arange(self.m, device=Wt.device)
        src = torch.as_tensor(self.src, device=Wt.device).to(torch.int64)
        w_self = Wt[idx, idx]
        w_steps = Wt[idx[None, :], src]
        w_steps = torch.where(src == idx[None, :], 0.0, w_steps)
        return w_self, w_steps

    def static_weights(self) -> tuple[np.ndarray, np.ndarray]:
        if not self.is_static:
            raise ValueError(f"plan {self.name!r} has no static weights")
        return self.w_self, self.w_steps

    def as_matrix(self) -> np.ndarray:
        """The dense W a static plan realizes (exact: the weights were
        gathered from it)."""
        w_self, w_steps = self.static_weights()
        W = np.diag(w_self).astype(np.float64)
        for k in range(self.n_steps):
            for p in range(self.m):
                j = int(self.src[k, p])
                if j != p:
                    W[p, j] += w_steps[k, p]
        return W


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
