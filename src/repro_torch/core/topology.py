"""Communication graphs and mixing matrices (paper §2, Definition 1) — the
static half of the JAX package's ``core/topology.py``, copied numpy for
numpy (it never touched JAX arrays).

A mixing matrix ``W`` for a connected undirected graph ``G=(V,E)`` must
satisfy (Definition 1):

  1. (Graph)      w_ij = 0 iff i != j and (i,j) not in E, else w_ij > 0
  2. (Symmetry)   W = W^T
  3. (Null space) null(I - W) = span(1)
  4. (Spectral)   I >= W > -I

Time-varying schedules (``TopologySchedule``) are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np

__all__ = ["Graph", "ring_graph", "complete_graph", "metropolis_hastings",
           "max_degree_weights", "lazy_uniform", "check_mixing_matrix",
           "MixingSpec"]


@dataclasses.dataclass(frozen=True)
class Graph:
    """Undirected graph on m nodes stored as a boolean adjacency matrix.

    ``adj`` excludes self-loops; every mixing-matrix constructor adds the
    diagonal itself.
    """

    adj: np.ndarray  # [m, m] bool, symmetric, zero diagonal
    name: str = "custom"

    def __post_init__(self):
        a = np.asarray(self.adj, dtype=bool)
        if a.ndim != 2 or a.shape[0] != a.shape[1]:
            raise ValueError(f"adjacency must be square, got {a.shape}")
        if not np.array_equal(a, a.T):
            raise ValueError("adjacency must be symmetric (undirected graph)")
        if a.diagonal().any():
            raise ValueError("adjacency must have zero diagonal")
        object.__setattr__(self, "adj", a)

    @property
    def m(self) -> int:
        return self.adj.shape[0]

    def degrees(self) -> np.ndarray:
        return self.adj.sum(axis=1)

    def edges(self) -> Iterable[tuple[int, int]]:
        ii, jj = np.nonzero(np.triu(self.adj, k=1))
        return list(zip(ii.tolist(), jj.tolist()))

    def num_directed_edges(self) -> int:
        """sum_i deg(i) — what the paper's comm-cost formulas count."""
        return int(self.adj.sum())


def ring_graph(m: int) -> Graph:
    """The paper's experimental topology: a simple ring (§6)."""
    if m < 2:
        raise ValueError("ring needs m >= 2")
    adj = np.zeros((m, m), dtype=bool)
    for i in range(m):
        adj[i, (i + 1) % m] = True
        adj[(i + 1) % m, i] = True
    if m == 2:  # the two "edges" coincide
        adj = np.array([[False, True], [True, False]])
    return Graph(adj, name=f"ring{m}")


def complete_graph(m: int) -> Graph:
    """All-to-all: gossip degenerates to exact averaging each round."""
    adj = ~np.eye(m, dtype=bool)
    return Graph(adj, name=f"complete{m}")


def metropolis_hastings(graph: Graph) -> np.ndarray:
    """Metropolis–Hastings weights: w_ij = 1 / (1 + max(deg_i, deg_j)) on
    edges, the diagonal fills the slack."""
    deg = graph.degrees()
    m = graph.m
    W = np.zeros((m, m), dtype=np.float64)
    for i, j in graph.edges():
        w = 1.0 / (1.0 + max(deg[i], deg[j]))
        W[i, j] = W[j, i] = w
    np.fill_diagonal(W, 1.0 - W.sum(axis=1))
    return W


def max_degree_weights(graph: Graph) -> np.ndarray:
    """Maximum-degree weights: w_ij = 1/(1+deg_max) on edges."""
    dmax = int(graph.degrees().max())
    W = np.where(graph.adj, 1.0 / (dmax + 1.0), 0.0)
    np.fill_diagonal(W, 1.0 - W.sum(axis=1))
    return W


def lazy_uniform(graph: Graph, self_weight: float = 1.0 / 3.0) -> np.ndarray:
    """Uniform neighbor weights with a fixed self-weight (regular graphs).

    For a ring with self_weight=1/3 this is the classic (1/3,1/3,1/3)
    gossip matrix used in the paper's experiments.
    """
    deg = graph.degrees().astype(np.float64)
    if (deg == 0).any():
        raise ValueError("graph has isolated nodes")
    W = np.where(graph.adj, ((1.0 - self_weight) / deg)[:, None], 0.0)
    if not np.allclose(W, W.T):
        raise ValueError("lazy_uniform requires a regular graph; "
                         "use metropolis_hastings instead")
    np.fill_diagonal(W, self_weight)
    return W


def check_mixing_matrix(W: np.ndarray, graph: Graph | None = None,
                        atol: float = 1e-10) -> None:
    """Raise if W violates Definition 1."""
    W = np.asarray(W, dtype=np.float64)
    m = W.shape[0]
    if W.shape != (m, m):
        raise ValueError("W must be square")
    if not np.allclose(W, W.T, atol=atol):
        raise ValueError("W must be symmetric")
    if not np.allclose(W.sum(axis=1), 1.0, atol=1e-8):
        raise ValueError("rows of W must sum to 1")
    ev = np.linalg.eigvalsh(W)
    if ev.min() <= -1.0 + 1e-12:
        raise ValueError("need W > -I (smallest eigenvalue > -1)")
    if ev.max() > 1.0 + 1e-8:
        raise ValueError("need I >= W")
    if np.sum(np.abs(ev - 1.0) < 1e-8) != 1:
        raise ValueError("eigenvalue 1 of W must be simple "
                         "(is the graph connected?)")
    if graph is not None:
        off = ~np.eye(m, dtype=bool)
        if np.any((W != 0) & off & ~graph.adj):
            raise ValueError("W has weight on a non-edge")
        if np.any((np.abs(W) < atol) & graph.adj):
            raise ValueError("W must be strictly positive on edges")


@dataclasses.dataclass(frozen=True)
class MixingSpec:
    """A graph + mixing matrix bundle consumed by ``core.mixing``.

    ``kind`` records whether the ring plan (two shifts) may be used.
    """

    graph: Graph
    W: np.ndarray
    kind: str  # "ring" | "dense"

    @property
    def m(self) -> int:
        return self.graph.m

    @staticmethod
    def ring(m: int, self_weight: float = 1.0 / 3.0) -> "MixingSpec":
        g = ring_graph(m)
        if m == 2:
            W = np.array([[self_weight, 1 - self_weight],
                          [1 - self_weight, self_weight]])
        else:
            W = lazy_uniform(g, self_weight=self_weight)
        check_mixing_matrix(W, g)
        return MixingSpec(graph=g, W=W, kind="ring")

    @staticmethod
    def dense(graph: Graph, scheme: str = "metropolis") -> "MixingSpec":
        if scheme == "metropolis":
            W = metropolis_hastings(graph)
        elif scheme == "max_degree":
            W = max_degree_weights(graph)
        else:
            raise ValueError(f"unknown scheme {scheme!r}")
        check_mixing_matrix(W, graph)
        return MixingSpec(graph=graph, W=W, kind="dense")

    @staticmethod
    def complete(m: int) -> "MixingSpec":
        """W = 11^T/m — makes DFedAvgM coincide with (all-client) FedAvg."""
        g = complete_graph(m)
        W = np.full((m, m), 1.0 / m)
        check_mixing_matrix(W, g)
        return MixingSpec(graph=g, W=W, kind="dense")

    def gossip_plan(self):
        """Compile this static spec into a :class:`~repro_torch.core.
        gossip_plan.GossipPlan` with baked weights."""
        from .gossip_plan import plan_from_spec
        return plan_from_spec(self)
