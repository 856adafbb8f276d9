"""Collective traffic of a port program (the roofline's collective term)
— the port of the JAX package's ``launch/hlo_stats.py``.

The reference parses the compiled, SPMD-partitioned HLO text for its
collectives and reads loop trip counts from the ``while`` conditions.
The port has no HLO: its cross-device transfers are explicit, and each
reports itself, while it runs, to every recorder that
:func:`collect_collectives` holds open:

  * each payload of a gossip round (``core.mixing._exchange``) as a
    ``collective-permute`` of its bytes;
  * the column group's operations of the tensor-parallel local step
    (``sharding.tensor_parallel.ColumnGroup``): ``broadcast`` and
    ``gather`` as an ``all-gather`` of the tensor every column ends with,
    ``reduce_sum`` and ``all_sum`` as an ``all-reduce`` of one partial,
    each with its group size; their backward passes as the adjoint
    collective (``all-reduce`` for a broadcast's, ``all-gather`` for a
    ``reduce_sum``'s, ``all-reduce`` for an ``all_sum``'s,
    ``reduce-scatter`` of a slice for a gather's);
  * a serving row's transfers (``launch.build``'s prefill and decode on a
    ``launch.mesh.ServeMesh``): its column group's operations as above
    (the cached attention's partial scores summed across a head_dim-cut
    cache, the vocabulary-cut logits joined at home), and each weight
    cut over the data axis gathered at its use
    (``sharding.tensor_parallel.gather_data``) as an ``all-gather`` over
    its data column, each row recording its own cell's share;
  * the train step of strategies B, B2 and B3 on a ``ServeMesh``
    (``core.local_sgd.local_train_rows``): its rows' column-group
    operations and data gathers as above, a gather's backward under a
    cut batch as a ``reduce-scatter`` of one cell's block (the row's
    share), the data column's sum of every other gradient as an
    ``all-reduce`` of a cell's block a column, and under B the copy of
    row 0's gradient of a leaf the data axis does not cut to each other
    row as a ``collective-permute``; an SSM inner dim cut over ``("data",
    "model")`` and re-cut to contiguous channels is gathered from the
    cells that hold its column's channels, recorded as the same
    ``all-gather`` (and its backward's ``reduce-scatter``) over dp
    blocks; a MoE routed as one group over a cut batch
    (``models.moe.RowRouting``) as an ``all-gather`` of every row's
    per-expert counts a layer; on the pod mesh the ring's payloads over
    ``"pod"`` as above, one a cell (f32 rows, or words, scales and
    ``lemma5`` replicas), or the dense mix's blocks of a ``(data,
    model)`` position as an ``all-gather`` over the pods;
  * an SSM's cached mixer whose inner dim is cut across heads: the
    columns' new sub-head states as an ``all-gather`` onto every
    column's copy of the replicated state.

A recorder sees every trip of every loop, so no trip-count pass (the
reference's ``collect_collectives_looped``) has a counterpart, and the
text parser is not ported. Each op is sized by the reference's ring
formulas (:func:`_wire_bytes`, per participating device) and recorded
as the bytes all its participants send: ``g`` times the formula for a
group op, the payload once for a permute. ``wire_bytes`` is therefore
the whole mesh's send volume; a device's share is ``wire_bytes /
n_devices``. Transfers the port makes outside these (joining a row's
cells for an opaque loss, a metric's mean over the shards) are not
recorded.
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict

__all__ = ["CollectiveStats", "collect_collectives", "record",
           "traced_flops"]

# The open recorders (CollectiveStats), innermost last.
RECORDERS: list = []


@dataclasses.dataclass
class CollectiveStats:
    """The collectives a recorder saw: total wire bytes, wire bytes and counts
    by kind, and each operation's record."""
    wire_bytes: float = 0.0
    by_kind: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    counts: dict = dataclasses.field(
        default_factory=lambda: defaultdict(int))
    per_op: list = dataclasses.field(default_factory=list)
    # (kind, wire_bytes) per op in program order — lets callers separate
    # payload-sized permutes from small ones


def _wire_bytes(kind: str, result_bytes: int, g: int) -> float:
    g = max(g, 1)
    if kind == "all-gather":
        return result_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return result_bytes * (g - 1)
    if kind == "all-reduce":
        return 2.0 * result_bytes * (g - 1) / g
    if kind == "all-to-all":
        return result_bytes * (g - 1) / g
    if kind == "collective-permute":
        return float(result_bytes)
    return float(result_bytes)


def record(kind: str, result_bytes: int, g: int,
           senders: int | None = None) -> None:
    """Record one collective of ``kind`` over ``g`` devices whose result
    (per device) is ``result_bytes``, in every open recorder. ``senders``
    (default: 1 for a permute, else g) is how many of its participants'
    shares the record covers: a serving row's gather of a weight over its
    data column records its own cell's share (1), so that the rows of
    the column together record the whole op."""
    if not RECORDERS:
        return
    if senders is None:
        senders = 1 if kind == "collective-permute" else max(g, 1)
    wb = senders * _wire_bytes(kind, result_bytes, g)
    for stats in RECORDERS:
        stats.wire_bytes += wb
        stats.by_kind[kind] += wb
        stats.counts[kind] += 1
        stats.per_op.append((kind, wb))


def replay(kind: str, wire_bytes: float) -> None:
    """Record again an op an open recorder saw (``per_op``'s ``(kind,
    wire_bytes)``): ``cost_model.repeats_on_meta``'s replay of a call."""
    for stats in RECORDERS:
        stats.wire_bytes += wire_bytes
        stats.by_kind[kind] += wire_bytes
        stats.counts[kind] += 1
        stats.per_op.append((kind, wire_bytes))


@contextlib.contextmanager
def collect_collectives():
    """Record the collectives run inside the ``with`` block; yields the
    :class:`CollectiveStats` they fill."""
    stats = CollectiveStats()
    RECORDERS.append(stats)
    try:
        yield stats
    finally:                          # by identity: equal stats may be open
        RECORDERS[:] = [r for r in RECORDERS if r is not stats]


def traced_flops(fn, *args, matmul_only: bool = False) -> float:
    """FLOP count of ``fn(*args)`` (args may be tensors or ``meta``
    tensors); ``matmul_only``: its matmul and convolution FLOPs alone.
    Thin forwarding of ``cost_model.structural_costs`` so compute-skip
    assertions live next to the other accounting — e.g. gating inactive
    clients' local SGD out of the round step must show up here as a
    ~k/m FLOP reduction."""
    from .cost_model import structural_costs
    costs = structural_costs(fn, *args)
    return costs.matmul_flops if matmul_only else costs.flops
