"""Communication graphs and mixing matrices (paper §2, Definition 1) — the
static half of the JAX package's ``core/topology.py``, copied numpy for
numpy (it never touched JAX arrays).

A mixing matrix ``W`` for a connected undirected graph ``G=(V,E)`` must
satisfy (Definition 1):

  1. (Graph)      w_ij = 0 iff i != j and (i,j) not in E, else w_ij > 0
  2. (Symmetry)   W = W^T
  3. (Null space) null(I - W) = span(1)
  4. (Spectral)   I >= W > -I

The key scalar is ``lambda(W) = max(|lambda_2|, |lambda_m|)``, which
controls the gossip mixing speed (Lemma 1).

Time-varying topologies (``TopologySchedule``): the constructors and the
bill stay numpy, as in the JAX package; a round's event (``sample_w``,
``round_event``, ``token_event``) is a handful of torch operations on the
key's device, over tables (``base_W``, ``adj``, the walk, the cycle's
``Ws``) that go to that device once (``TopologySchedule.tables``), so a
round copies nothing from the host and can be captured in a CUDA graph.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np
import torch

from .. import prng

__all__ = ["Graph", "ring_graph", "chain_graph", "torus_graph",
           "complete_graph", "star_graph", "erdos_renyi_graph",
           "metropolis_hastings", "max_degree_weights", "lazy_uniform",
           "spectral_gap", "mixing_lambda", "check_mixing_matrix",
           "MixingSpec", "TopologySchedule",
           "metropolis_weights_from_adjacency"]


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

    def neighbors(self, i: int) -> np.ndarray:
        return np.nonzero(self.adj[i])[0]

    def edges(self) -> Iterable[tuple[int, int]]:
        ii, jj = np.nonzero(np.triu(self.adj, k=1))
        return list(zip(ii.tolist(), jj.tolist()))

    def num_directed_edges(self) -> int:
        """sum_i deg(i) — what the paper's comm-cost formulas count."""
        return int(self.adj.sum())

    def block_boundary_edges(self, clients_per_shard: int,
                             perm=None) -> int:
        """Directed edges that CROSS a contiguous client-block boundary
        when client ``c`` lives on shard ``c // clients_per_shard`` — the
        only edges the block-sharded sparse backend ships over the wire
        (intra-block edges are on-device lane gathers). For a ring this
        is ``2 * n_shards`` regardless of ``m``: the O(n_shards *
        boundary_degree) scaling that lets ``m`` grow past the device
        count.

        ``perm`` bills a PLACED layout instead: a lane->client
        permutation (or a ``gossip_plan.Placement``, whose ``.perm`` is
        used) under which client ``perm[p]`` occupies lane ``p``, i.e.
        shard ``p // clients_per_shard`` — the cut ``--placement
        partition`` actually ships."""
        if clients_per_shard < 1 or self.m % clients_per_shard:
            raise ValueError(f"clients_per_shard={clients_per_shard} "
                             f"must divide m={self.m}")
        if perm is None:
            shard = np.arange(self.m) // clients_per_shard
        else:
            p = np.asarray(getattr(perm, "perm", perm), dtype=np.int64)
            if not np.array_equal(np.sort(p), np.arange(self.m)):
                raise ValueError("perm must be a permutation of "
                                 f"range({self.m})")
            shard = np.empty(self.m, dtype=np.int64)
            shard[p] = np.arange(self.m) // clients_per_shard
        return int((self.adj & (shard[:, None] != shard[None, :])).sum())

    def is_connected(self) -> bool:
        m = self.m
        seen = np.zeros(m, dtype=bool)
        stack = [0]
        seen[0] = True
        while stack:
            u = stack.pop()
            for v in np.nonzero(self.adj[u])[0]:
                if not seen[v]:
                    seen[v] = True
                    stack.append(int(v))
        return bool(seen.all())


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


def chain_graph(m: int) -> Graph:
    """Path 0-1-...-m-1: the worst-diameter connected topology."""
    adj = np.zeros((m, m), dtype=bool)
    for i in range(m - 1):
        adj[i, i + 1] = adj[i + 1, i] = True
    return Graph(adj, name=f"chain{m}")


def torus_graph(rows: int, cols: int) -> Graph:
    """2-D torus: the graph of every 2-D topology study."""
    m = rows * cols
    adj = np.zeros((m, m), dtype=bool)

    def idx(r, c):
        return (r % rows) * cols + (c % cols)

    for r in range(rows):
        for c in range(cols):
            u = idx(r, c)
            for v in (idx(r + 1, c), idx(r, c + 1)):
                if u != v:
                    adj[u, v] = adj[v, u] = True
    return Graph(adj, name=f"torus{rows}x{cols}")


def complete_graph(m: int) -> Graph:
    """All-to-all: gossip degenerates to exact averaging each round."""
    adj = ~np.eye(m, dtype=bool)
    return Graph(adj, name=f"complete{m}")


def star_graph(m: int) -> Graph:
    """Node 0 is the hub: the centralized FedAvg topology as a graph."""
    adj = np.zeros((m, m), dtype=bool)
    adj[0, 1:] = True
    adj[1:, 0] = True
    return Graph(adj, name=f"star{m}")


def erdos_renyi_graph(m: int, p: float, seed: int = 0) -> Graph:
    """Random G(m, p), resampled until connected (bounded retries); the
    same ``default_rng`` draws as the JAX package, so the same graph."""
    rng = np.random.default_rng(seed)
    for _ in range(256):
        u = rng.random((m, m))
        adj = np.triu(u < p, k=1)
        adj = adj | adj.T
        g = Graph(adj, name=f"er{m}_p{p}")
        if g.is_connected():
            return g
    raise RuntimeError(f"could not sample a connected G({m},{p})")


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


def mixing_lambda(W: np.ndarray) -> float:
    """lambda(W) = max(|lambda_2|, |lambda_m|) (paper §2)."""
    ev = np.sort(np.linalg.eigvalsh(np.asarray(W, dtype=np.float64)))[::-1]
    return float(max(abs(ev[1]), abs(ev[-1])))


def spectral_gap(W: np.ndarray) -> float:
    """1 - lambda(W): the denominators of Thm 1 / Lemma 4."""
    return 1.0 - mixing_lambda(W)


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

    ``kind`` records whether the ring plan (two shifts) or the torus plan
    (four shifts) may be used.
    """

    graph: Graph
    W: np.ndarray
    kind: str  # "ring" | "torus" | "dense"
    torus_shape: tuple[int, int] | None = None

    @property
    def m(self) -> int:
        return self.graph.m

    @property
    def lam(self) -> float:
        return mixing_lambda(self.W)

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

    @staticmethod
    def torus(rows: int, cols: int,
              self_weight: float = 0.2) -> "MixingSpec":
        """2-D torus with uniform neighbour weights (four shifts a round;
        a much smaller lambda than a ring of the same size)."""
        g = torus_graph(rows, cols)
        deg = g.degrees()
        if not (deg == deg[0]).all():
            raise ValueError("torus must be regular")
        w_nb = (1.0 - self_weight) / float(deg[0])
        W = np.where(g.adj, w_nb, 0.0)
        np.fill_diagonal(W, self_weight)
        check_mixing_matrix(W, g)
        return MixingSpec(graph=g, W=W, kind="torus",
                          torus_shape=(rows, cols))


# ---------------------------------------------------------------------------
# Time-varying topologies: a round-indexed schedule of mixing events
# ---------------------------------------------------------------------------

def metropolis_weights_from_adjacency(adj) -> torch.Tensor:
    """Metropolis–Hastings reweighting of a 0/1 adjacency, f32 on its
    device: ``w_ij = a_ij / (1 + max(deg_i, deg_j))``, the diagonal fills
    the slack. For any symmetric zero-diagonal ``adj`` (connected or not)
    the result is symmetric and doubly stochastic; rows of isolated nodes
    are ``e_i``. ``adj`` is an [m, m] tensor (or numpy, taken to the
    CPU)."""
    a = torch.as_tensor(adj).to(torch.float32)
    deg = a.sum(dim=1)
    pair = 1.0 + torch.maximum(deg[:, None], deg[None, :])
    W = a / pair
    return W + torch.diag(1.0 - W.sum(dim=1))


def _at(table: torch.Tensor, t, n: int) -> torch.Tensor:
    """``table[t % n]`` for a host int ``t`` (a view) or a 0-dim integer
    tensor on the table's device (one gather, no sync): the round index a
    captured round reads from a device buffer."""
    if isinstance(t, torch.Tensor):
        if t.device != table.device:
            raise ValueError(f"the round index must be on {table.device}, "
                             f"got {t.device}")
        return table.index_select(0, (t.to(torch.int64) % n).reshape(1))[0]
    return table[int(t) % n]


def _on(x: torch.Tensor, dev: torch.device, what: str) -> torch.Tensor:
    """Refuse a tensor that is not on ``dev`` (never copy it over)."""
    if x.device != dev:
        raise ValueError(f"{what} must be on {dev}, got {x.device}")
    return x


@dataclasses.dataclass(frozen=True)
class TopologySchedule:
    """A round-indexed sequence of mixing events ``(W_t, active_t)``.

    Generalizes a static :class:`MixingSpec` to time-varying gossip: each
    round ``t`` draws a doubly-stochastic ``W_t`` (and a mask of the
    participating clients) from a key, on the key's device. Inactive
    clients hold their parameters and send nothing: their ``W_t`` rows
    are ``e_i`` and the mixer gates their freshly trained ``z`` back to
    ``x``.

    Kinds (as in the JAX package):
      * ``constant``     — ``W_t = W`` every round (the static mixer).
      * ``edge_sample``  — each base-graph edge kept i.i.d. with
                           probability ``p_edge``, the surviving subgraph
                           Metropolis-reweighted.
      * ``partial``      — each client participates i.i.d. with
                           probability ``p_active``; ``exact=True`` draws
                           exactly ``round(p_active * m)`` (a static
                           count), ``cap_slack=c`` caps the i.i.d. draw at
                           ``ceil(p_active * m) + c`` (a key-derived
                           random subset of an overflow is clamped).
      * ``random_walk``  — a token walks the base graph; round ``t``
                           pairwise-averages its current and next node. The
                           path is precomputed from ``seed``, or with
                           ``stateful=True`` the position is round state
                           (``RoundState.token``) and each round draws the
                           next neighbour.
      * ``cycle``        — a deterministic cycle over mixing matrices.

    Every sampled ``W_t`` is symmetric, doubly stochastic and zero off
    the active edge set.
    """

    kind: str        # constant | edge_sample | partial | random_walk | cycle
    m: int
    name: str = "schedule"
    base_W: np.ndarray | None = None      # constant
    adj: np.ndarray | None = None         # edge_sample / partial / random_walk
    p_edge: float = 1.0                   # edge_sample
    p_active: float = 1.0                 # partial
    n_active: int | None = None           # partial(exact=True): cohort size
    n_cap: int | None = None              # partial(cap_slack=...): iid cap
    walk: np.ndarray | None = None        # random_walk: [horizon+1] int32
                                          #   (None = stateful token)
    start: int = 0                        # random_walk(stateful): token 0
    Ws: np.ndarray | None = None          # cycle: [n, m, m]
    _tables: dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False, compare=False)

    _KINDS = ("constant", "edge_sample", "partial", "random_walk", "cycle")

    def __post_init__(self):
        if self.kind not in self._KINDS:
            raise ValueError(f"unknown schedule kind {self.kind!r}")

    # -- properties the mixer / ledger dispatch on ------------------------

    @property
    def is_stochastic(self) -> bool:
        """Whether sampling round t's event consumes randomness."""
        return self.kind in ("edge_sample", "partial") or self.is_stateful

    @property
    def is_stateful(self) -> bool:
        """Whether the schedule carries state across rounds (the walk
        token, threaded through ``RoundState.token``): it samples through
        :meth:`token_event`, not :meth:`sample_w`."""
        return self.kind == "random_walk" and self.walk is None

    @property
    def gates_participation(self) -> bool:
        """Whether some clients may sit a round out (the mixer gates z)."""
        return self.kind in ("partial", "random_walk")

    @property
    def static_active_count(self) -> int | None:
        """Static upper bound on the participating clients a round, or
        None: exact for cohorts and walks (2), the cap for capped i.i.d.
        participation. A bound below m lets the round step train just the
        active lanes (a gather of k, a scatter back)."""
        if self.kind == "random_walk":
            return 2
        if self.kind == "partial" and self.n_active is not None:
            return self.n_active
        if self.kind == "partial" and self.n_cap is not None:
            return self.n_cap
        return None

    def expected_directed_edges(self, t: int | None = None) -> float:
        """E[#directed edges carrying a message in round t] (exact for the
        deterministic kinds; for a cycle, pass ``t`` for that round)."""
        if self.kind == "constant":
            return float(np.count_nonzero(
                self.base_W - np.diag(np.diag(self.base_W))))
        if self.kind == "cycle":
            counts = [float(np.count_nonzero(W - np.diag(np.diag(W))))
                      for W in self.Ws]
            if t is not None:
                return counts[int(t) % len(counts)]
            return float(np.mean(counts))
        base = float(self.adj.sum())
        if self.kind == "edge_sample":
            return self.p_edge * base
        if self.kind == "partial":
            if self.n_active is not None:
                k, m = self.n_active, self.m
                return k * (k - 1) / (m * (m - 1)) * base
            return self.p_active ** 2 * base
        return 2.0  # random_walk: one undirected edge a round

    # -- the device tables ---------------------------------------------------

    def tables(self, device) -> dict[str, torch.Tensor]:
        """The schedule's tables on ``device``, made on the first call for
        that device and kept: the mixers call this when they are built, so
        a round never copies a table from the host."""
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev not in self._tables:
            f32 = dict(dtype=torch.float32, device=dev)
            tab = {"ones": torch.ones(self.m, **f32),
                   "zeros": torch.zeros(self.m, **f32),
                   "arange": torch.arange(self.m, device=dev)}
            if self.kind == "constant":
                tab["base_W"] = torch.as_tensor(self.base_W, **f32)
            elif self.kind == "cycle":
                tab["Ws"] = torch.as_tensor(self.Ws, **f32)
            else:
                tab["adj"] = torch.as_tensor(self.adj, **f32)
            if self.kind == "random_walk":
                tab["eye"] = torch.eye(self.m, **f32)
                if self.walk is not None:
                    pos = torch.as_tensor(self.walk.astype(np.int64),
                                          device=dev)
                    tab["walk_pairs"] = torch.stack([pos[:-1], pos[1:]], 1)
            self._tables[dev] = tab
        return self._tables[dev]

    # -- sampling on the device -------------------------------------------

    def sample_w(self, key: torch.Tensor, t):
        """(key, round) -> (W_t [m, m] f32, active [m] f32) on the key's
        device. ``t`` is a host int or a 0-dim integer tensor there."""
        tab = self.tables(key.device)
        if self.kind == "constant":
            return tab["base_W"], tab["ones"]
        if self.kind == "cycle":
            return _at(tab["Ws"], t, len(self.Ws)), tab["ones"]
        if self.kind == "edge_sample":
            u = torch.triu(prng.uniform(key, (self.m, self.m)), diagonal=1)
            u = u + u.T   # one uniform per undirected edge, symmetric
            keep = (u < self.p_edge).to(torch.float32) * tab["adj"]
            return metropolis_weights_from_adjacency(keep), tab["ones"]
        if self.kind == "partial":
            m = self.m
            if self.n_active is not None:
                cohort = prng.permutation(key, m)[: self.n_active]
                active = tab["zeros"].index_fill(0, cohort, 1.0)
            else:
                active = (prng.uniform(key, (m,))
                          < self.p_active).to(torch.float32)
                if self.n_cap is not None and self.n_cap < m:
                    # Overflow rounds clamp a key-derived random subset
                    # of the extras (by client index would bias the cap).
                    perm = prng.permutation(prng.fold_in(key, 1), m)
                    keep_perm = torch.cumsum(active[perm], 0) <= self.n_cap
                    keep = torch.empty_like(active).scatter_(
                        0, perm, keep_perm.to(torch.float32))
                    active = active * keep
            live = tab["adj"] * active[:, None] * active[None, :]
            return metropolis_weights_from_adjacency(live), active
        if self.is_stateful:
            raise ValueError(
                "stateful random_walk has no precomputed path: its token "
                "position is round state — sample via token_event "
                "(make_round_step threads RoundState.token)")
        pair = _at(tab["walk_pairs"], t, len(self.walk) - 1)
        return self._token_pair_event(tab, pair[0], pair[1])

    def _token_pair_event(self, tab: dict, i: torch.Tensor,
                          j: torch.Tensor):
        """W_t and active for a pairwise average across edge (i, j) (i !=
        j): ``I - (e_i - e_j)(e_i - e_j)^T / 2``, exact in f32."""
        oh_i = (tab["arange"] == i).to(torch.float32)
        oh_j = (tab["arange"] == j).to(torch.float32)
        d = oh_i - oh_j
        W = tab["eye"] - 0.5 * (d[:, None] * d[None, :])
        return W, torch.maximum(oh_i, oh_j)

    # -- stateful (token-carrying) sampling --------------------------------

    def init_token(self) -> torch.Tensor:
        """The walk's first position (``init_round_state`` moves it to the
        parameters' device)."""
        if not self.is_stateful:
            raise ValueError(f"schedule {self.name!r} carries no token")
        return torch.tensor(self.start, dtype=torch.int64)

    def sample_w_token(self, key: torch.Tensor, token: torch.Tensor):
        """(key, token) -> (W_t, active, token_next): one step of the walk,
        the next position drawn from the current node's neighbours with
        ``prng.choice``."""
        tab = self.tables(key.device)
        _on(token, key.device, "the walk token")
        row = tab["adj"].index_select(0, token.reshape(1).to(torch.int64))[0]
        nxt = prng.choice(key, self.m, p=row / row.sum())
        W, active = self._token_pair_event(tab, token, nxt)
        return W, active, nxt

    def support_graph(self) -> Graph:
        """The union of every edge any round can sample: the static
        support the plan realization compiles against (each round's W_t
        then masks the unsampled edges to 0)."""
        if self.kind == "constant":
            adj = (self.base_W - np.diag(np.diag(self.base_W))) != 0
        elif self.kind == "cycle":
            adj = np.zeros((self.m, self.m), dtype=bool)
            for W in self.Ws:
                adj |= (W - np.diag(np.diag(W))) != 0
        else:
            adj = np.asarray(self.adj) != 0
        return Graph(adj, name=f"support[{self.name}]")

    def gossip_plan(self):
        """Structure-only plan over :meth:`support_graph`; each round's
        weights are gathered from its W_t."""
        from .gossip_plan import plan_from_support
        return plan_from_support(self.support_graph(), name=self.name)

    def gossip_plans(self) -> list:
        """Per-round plans: a cycle compiles one static plan per member
        (its own support, baked weights); every other kind the single
        support plan."""
        if self.kind != "cycle":
            return [self.gossip_plan()]
        from .gossip_plan import plan_from_matrix
        return [plan_from_matrix(W, name=f"{self.name}[{k}]")
                for k, W in enumerate(self.Ws)]

    def _split_mix_key(self, key_mix: torch.Tensor):
        if self.is_stochastic:
            key_topo, key_q = prng.split(key_mix)
            return key_topo, key_q
        return key_mix, key_mix

    def round_event(self, key_mix: torch.Tensor, t):
        """Round t's (W_t, active, key_quant) from the round's mixing key:
        how the key is split, for the mixers, the round step and tests."""
        key_topo, key_q = self._split_mix_key(key_mix)
        W, active = self.sample_w(key_topo, t)
        return W, active, key_q

    def token_event(self, key_mix: torch.Tensor, token: torch.Tensor):
        """The stateful analogue of :meth:`round_event`: (W_t, active,
        key_quant, token_next) from the mixing key and the token."""
        key_topo, key_q = self._split_mix_key(key_mix)
        W, active, token_next = self.sample_w_token(key_topo, token)
        return W, active, key_q, token_next

    # -- constructors -----------------------------------------------------

    @staticmethod
    def constant(spec: MixingSpec) -> "TopologySchedule":
        """The trivial schedule: the static W every round."""
        return TopologySchedule(kind="constant", m=spec.m,
                                name=f"constant[{spec.graph.name}]",
                                base_W=np.asarray(spec.W, np.float64))

    @staticmethod
    def edge_sample(graph: Graph, p_edge: float) -> "TopologySchedule":
        if not 0.0 < p_edge <= 1.0:
            raise ValueError("need 0 < p_edge <= 1")
        return TopologySchedule(kind="edge_sample", m=graph.m,
                                name=f"edge_sample[{graph.name},p={p_edge}]",
                                adj=graph.adj.astype(np.float64),
                                p_edge=float(p_edge))

    @staticmethod
    def partial(graph: Graph, p_active: float, exact: bool = False,
                cap_slack: int | None = None) -> "TopologySchedule":
        """``exact=False``: each client participates i.i.d. w.p.
        ``p_active``; ``exact=True``: exactly ``round(p_active * m)``
        clients a round; ``cap_slack`` (i.i.d. only): at most
        ``ceil(p_active * m) + cap_slack``."""
        if not 0.0 < p_active <= 1.0:
            raise ValueError("need 0 < p_active <= 1")
        n_active = n_cap = None
        tag = f"p={p_active}"
        if exact:
            if cap_slack is not None:
                raise ValueError("cap_slack applies to i.i.d. partial "
                                 "participation; exact cohorts already "
                                 "have a static count")
            n_active = max(1, round(p_active * graph.m))
            tag = f"k={n_active}"
        elif cap_slack is not None:
            if cap_slack < 0:
                raise ValueError("need cap_slack >= 0")
            n_cap = min(graph.m,
                        int(np.ceil(p_active * graph.m)) + int(cap_slack))
            tag = f"p={p_active},cap={n_cap}"
        return TopologySchedule(kind="partial", m=graph.m,
                                name=f"partial[{graph.name},{tag}]",
                                adj=graph.adj.astype(np.float64),
                                p_active=float(p_active), n_active=n_active,
                                n_cap=n_cap)

    @staticmethod
    def random_walk(graph: Graph, horizon: int = 4096, seed: int = 0,
                    start: int = 0, stateful: bool = False
                    ) -> "TopologySchedule":
        """``stateful=False``: a ``horizon``-step walk precomputed from
        ``seed`` (numpy, the JAX package's draws), wrapping modulo
        horizon; ``stateful=True``: the position is round state."""
        if not graph.is_connected():
            raise ValueError("random walk needs a connected base graph")
        if stateful:
            return TopologySchedule(
                kind="random_walk", m=graph.m,
                name=f"random_walk[{graph.name},stateful]",
                adj=graph.adj.astype(np.float64), start=int(start))
        rng = np.random.default_rng(seed)
        pos = np.empty(horizon + 1, dtype=np.int32)
        pos[0] = start
        for k in range(horizon):
            pos[k + 1] = rng.choice(graph.neighbors(int(pos[k])))
        return TopologySchedule(kind="random_walk", m=graph.m,
                                name=f"random_walk[{graph.name}]",
                                adj=graph.adj.astype(np.float64), walk=pos)

    @staticmethod
    def cycle(specs: Sequence[MixingSpec]) -> "TopologySchedule":
        """Deterministic cycle W_t = specs[t mod n].W."""
        if not specs:
            raise ValueError("cycle needs at least one MixingSpec")
        m = specs[0].m
        if any(s.m != m for s in specs):
            raise ValueError("all specs in a cycle must have the same m")
        Ws = np.stack([np.asarray(s.W, np.float64) for s in specs])
        names = "/".join(s.graph.name for s in specs)
        return TopologySchedule(kind="cycle", m=m, name=f"cycle[{names}]",
                                Ws=Ws)
