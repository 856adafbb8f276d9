"""Structural cost model: FLOPs and bytes of what a port program runs —
the port of the JAX package's ``launch/cost_model.py``.

The reference walks the jaxpr of ``fn``. The port has no jaxpr: it runs
``fn`` once under a ``TorchDispatchMode`` and counts every aten
operation that reaches the dispatcher (after autograd, so a backward
pass and a ``torch.utils.checkpoint`` recompute are counted as they
run):

  matmul / conv:  the reference's ``_dot_flops`` (2 * numel(out) *
                  contraction) and ``_conv_flops`` (2 * numel(out) *
                  kernel_spatial * in_ch / groups), as
                  ``torch.utils.flop_counter``'s formulas give them for
                  ``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``convolution``
                  and its backward (``matmul``, ``einsum`` and ``linear``
                  reach the dispatcher as these)
  other ops:      numel(out[0]) FLOPs (elementwise estimate)
  kernel entries: one ``native.KernelRecord`` each (the bytes of the
                  kernel's tensor operands and outputs, the reference's
                  ``pallas_call`` rule); the aten operations inside an
                  entry (its plain version on a CPU tensor, its checks and
                  allocations on the card) are not counted again, and its
                  arithmetic adds no FLOPs
  collectives:    the transfers ``hlo_stats.collect_collectives`` records
                  while ``fn`` runs (``coll_bytes``, ``coll_by_kind``)

Bytes are every counted operation's operand plus output buffers, an
unfused upper bound on HBM traffic, as in the reference. Views and bare
allocations (``empty``, ``empty_strided``) move no data and count
nothing. The reference multiplies a ``scan`` body by its length and
counts a ``while`` body once; the port's loops are Python loops, so the
mode sees every trip and no multiplier has a counterpart. ``args`` may
be ``meta`` tensors (every kernel entry answers them with ``meta``
outputs and the same record), so nothing is allocated.

``matmul_flops`` keeps the matmul and convolution FLOPs apart: the
elementwise counts of aten and of a jaxpr do not decompose alike, the
contractions do.

On ``meta`` tensors a mesh's cells and shards repeat the same work on
the same shapes, and the evaluation is Python dispatch, op by op. Two
memos keep the counts and cut the time: a functional operation's output
metadata (its meta kernel skipped on a repeat), and, for a function
marked :func:`repeats_on_meta` (a shard's local training, a serving
row's step), a whole call's counts, kernel records, recorded collectives and outputs, replayed
when a later call's arguments have the same metadata. Both are exact:
on ``meta`` the outputs and the costs depend on the arguments' metadata
alone.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..kernels import native
from . import hlo_stats

__all__ = ["Costs", "structural_costs", "analytic_hbm_bytes", "uncounted"]

_aten = torch.ops.aten
_NO_DATA = {_aten.empty.memory_format, _aten.empty_strided.default,
            _aten.empty_like.default, _aten.new_empty.default,
            _aten.new_empty_strided.default, _aten.detach.default,
            _aten.lift_fresh.default, _aten.sym_size.int,
            _aten.sym_stride.int, _aten.sym_numel.default,
            _aten.sym_storage_offset.default, _aten.is_same_size.default}


# Depth of ``uncounted`` blocks on the stack; the open counters,
# innermost last.
_UNCOUNTED = [0]
_COUNTERS: list = []


@contextlib.contextmanager
def uncounted():
    """A block whose aten operations are not counted: laying a program's
    inputs out on its mesh (``mesh.shard``), the counterpart of the
    reference's ``in_shardings``, which are not part of its jaxpr."""
    _UNCOUNTED[0] += 1
    try:
        yield
    finally:
        _UNCOUNTED[0] -= 1


@dataclasses.dataclass
class Costs:
    # Integer counts (exact in any order, past 2^53); coll_bytes and
    # coll_by_kind are the recorder's float ring formulas.
    """A step's structural costs: FLOPs and bytes of every operation, matmul
    FLOPs, kernel bytes and records, and the recorded collectives' wire bytes
    (total and by kind)."""
    flops: int = 0
    bytes: int = 0
    coll_bytes: float = 0.0
    coll_by_kind: dict = dataclasses.field(default_factory=dict)
    matmul_flops: int = 0
    kernel_bytes: int = 0
    # kernel name -> {"calls", "launches", "bytes"}
    kernels: dict = dataclasses.field(default_factory=dict)

    def kernel(self, rec: native.KernelRecord) -> None:
        """Count one kernel entry's record."""
        self.bytes += rec.bytes
        self.kernel_bytes += rec.bytes
        k = self.kernels.setdefault(
            rec.name, {"calls": 0, "launches": 0, "bytes": 0})
        k["calls"] += 1
        k["launches"] += rec.launches
        k["bytes"] += rec.bytes


def _tensors(values, acc: list) -> list:
    """The tensors among ``values`` and in their lists and tuples (an
    aten operation's arguments nest no deeper)."""
    for v in values:
        if isinstance(v, torch.Tensor):
            acc.append(v)
        elif isinstance(v, (list, tuple)):
            acc.extend(t for t in v if isinstance(t, torch.Tensor))
    return acc


# func -> (counted, its FLOP formula or None, whether its meta output
# may be memoized), looked up once a func.
_RULES: dict = {}


def _rule(func):
    rule = _RULES.get(func)
    if rule is None:
        schema = func._schema
        functional = not schema.is_mutable and all(
            r.alias_info is None for r in schema.returns)
        rule = _RULES[func] = (func not in _NO_DATA and not func.is_view,
                               flop_registry.get(func._overloadpacket),
                               functional)
    return rule


def _meta_key(x):
    """A hashable key of an argument's metadata: a tensor's device type,
    dtype, shape and strides (all a meta kernel reads of it)."""
    if isinstance(x, torch.Tensor):
        return (x.device.type, x.dtype, tuple(x.shape), x.stride())
    if isinstance(x, (list, tuple)):
        return tuple(_meta_key(y) for y in x)
    return x


def _meta_call(memo: dict, func, args, kwargs):
    """``func`` on all-``meta`` arguments, its output's metadata memoized:
    a functional operation's output on ``meta`` depends on its arguments'
    metadata alone, and a mesh's cells repeat the same operations on the
    same shapes, whose meta kernels (Python, for most elementwise
    operations) dominate an evaluation. A hit makes empty ``meta``
    tensors of the memoized shapes, strides and dtypes."""
    try:
        key = (func, _meta_key(args), _meta_key(tuple(kwargs.items())))
        hit = memo.get(key)
    except TypeError:                     # an unhashable argument
        return func(*args, **kwargs)
    if hit is None:
        out = func(*args, **kwargs)
        single = isinstance(out, torch.Tensor)
        outs = (out,) if single else out
        if isinstance(outs, (tuple, list)) and all(
                isinstance(t, torch.Tensor) and t.device.type == "meta"
                for t in outs):
            memo[key] = (single, [(t.shape, t.stride(), t.dtype)
                                  for t in outs])
        return out
    single, metas = hit
    outs = [torch.empty_strided(shape, stride, dtype=dtype, device="meta")
            for shape, stride, dtype in metas]
    return outs[0] if single else tuple(outs)


class _Counter(TorchDispatchMode):
    def __init__(self, costs: Costs):
        super().__init__()
        self.costs = costs
        self.memo: dict = {}          # op key -> its output's metadata
        self.calls: dict = {}         # repeats_on_meta: call key -> replay

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # Nothing here is compiled: keep the handler unwrapped (the
        # wrapper's frame switching costs more than the handler itself).
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        counted, formula, functional = _rule(func)
        if not counted:                   # a view or a bare allocation
            return func(*args, **kwargs)
        tensors = _tensors(args, [])
        if functional and tensors and all(t.device.type == "meta"
                                          for t in tensors):
            out = _meta_call(self.memo, func, args, kwargs)
        else:
            out = func(*args, **kwargs)
        if native.in_kernel_entry() or _UNCOUNTED[0]:
            return out
        ins = _tensors(kwargs.values(), tensors)
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,),
                        [])
        costs = self.costs
        if formula is not None:
            f = int(formula(*args, **kwargs, out_val=out))
            costs.flops += f
            costs.matmul_flops += f
        elif outs:
            costs.flops += outs[0].numel()
        costs.bytes += sum(t.numel() * t.element_size() for t in ins) + sum(
            t.numel() * t.element_size() for t in outs)
        return out


def _call_key(x):
    """A hashable key of a call's arguments: tensors by their metadata,
    a column group by its devices and cuts, a data-cut weight by its
    blocks, its cut and whether its gradient keeps one block (which one
    changes no count), containers by their items, anything else as
    itself (functions by identity)."""
    from ..sharding.tensor_parallel import ColumnGroup, DataCut
    if isinstance(x, torch.Tensor):
        return _meta_key(x)
    if isinstance(x, DataCut):
        return ("datacut", x.axis, str(x.device), x.own is None,
                tuple(_meta_key(p) for p in x.parts))
    if isinstance(x, dict):
        return tuple((k, _call_key(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return (type(x).__name__,) + tuple(_call_key(v) for v in x)
    if isinstance(x, ColumnGroup):
        return ("group", tuple(map(str, x.devices)),
                tuple(sorted(x.dims.items())))
    return x


def _nested_tensors(x) -> list:
    from ..sharding.tensor_parallel import DataCut
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, DataCut):
        return list(x.parts)
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _nested_tensors(v)]
    return []


def _rebuild(x):
    """Fresh empty ``meta`` tensors in the place of every tensor of
    ``x``, each of its shape, strides and dtype."""
    if isinstance(x, torch.Tensor):
        return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                                   device="meta")
    if isinstance(x, dict):
        return {k: _rebuild(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_rebuild(v) for v in x)
    return x


def repeats_on_meta(fn):
    """Mark ``fn`` as a call whose outputs and costs follow from its
    arguments' metadata on ``meta`` tensors (no output needing a
    gradient): inside :func:`structural_costs`, a call on ``meta``
    arguments whose key (:func:`_call_key`) an earlier call had replays
    that call's counts, kernel records and collectives and returns fresh
    ``meta`` outputs of its shapes. Outside a count, or on real tensors,
    ``fn`` runs as it is."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        if not _COUNTERS or _UNCOUNTED[0] or native.in_kernel_entry():
            return fn(*args, **kwargs)
        tensors = _nested_tensors((args, kwargs))
        if not tensors or any(t.device.type != "meta" for t in tensors):
            return fn(*args, **kwargs)
        counter = _COUNTERS[-1]
        try:
            key = (fn, torch.is_grad_enabled(), _call_key(args),
                   _call_key(kwargs))
            hit = counter.calls.get(key)
        except TypeError:                 # an unhashable argument
            return fn(*args, **kwargs)
        costs = counter.costs
        if hit is not None:
            (flops, matmul, aten_bytes), kernels, colls, out = hit
            costs.flops += flops
            costs.matmul_flops += matmul
            costs.bytes += aten_bytes
            for rec in kernels:
                for r in list(native.RECORDERS):
                    r(rec)
            for kind, wb in colls:
                hlo_stats.replay(kind, wb)
            return _rebuild(out)
        before = (costs.flops, costs.matmul_flops, costs.bytes,
                  costs.kernel_bytes)
        kernels = []
        native.RECORDERS.append(kernels.append)
        try:
            with hlo_stats.collect_collectives() as colls:
                out = fn(*args, **kwargs)
        finally:
            native.RECORDERS.remove(kernels.append)
        if not any(t.requires_grad for t in _nested_tensors(out)):
            counter.calls[key] = (
                (costs.flops - before[0], costs.matmul_flops - before[1],
                 (costs.bytes - before[2])
                 - (costs.kernel_bytes - before[3])),
                kernels, list(colls.per_op), _rebuild(out))
        return out
    return call


def structural_costs(fn, *args) -> Costs:
    """Costs of ``fn(*args)`` — args may be ``meta`` tensors (nothing is
    allocated), or tensors on the CPU or the card (the program runs).

    These are the costs of the whole program: on a client mesh every
    cell's work is counted, so divide by the chip count for per-device
    roofline terms. ``coll_bytes`` sums the bytes every device sends
    (``hlo_stats.collect_collectives``)."""
    costs = Costs()
    counter = _Counter(costs)
    native.RECORDERS.append(costs.kernel)
    _COUNTERS.append(counter)
    try:
        with hlo_stats.collect_collectives() as coll, counter:
            fn(*args)
    finally:
        _COUNTERS.remove(counter)
        native.RECORDERS.remove(costs.kernel)
    costs.coll_bytes = coll.wire_bytes
    costs.coll_by_kind = dict(coll.by_kind)
    return costs


def analytic_hbm_bytes(cfg, meta: dict, n_chips: int) -> float:
    """Coarse-but-consistent per-step HBM traffic (GLOBAL; divide by chips
    for the per-device roofline term) — the reference's arithmetic.

    The structural byte count treats every intermediate as HBM traffic,
    but fused kernels keep chunk buffers (attention scores,
    online-softmax accumulators, SSD chunk states) on chip. This model
    counts what genuinely crosses HBM:

      weights  — reads/writes per use (train: fwd read + bwd read + grad
                 write + momentum r/w + weight r/w per local step, plus
                 gossip r/w once per round)
      acts     — residual-stream-sized buffers per layer slot
                 (C_fwd=8 fwd; x2.5 with remat'd backward)
      logits   — tokens x vocab (fwd + bwd)
      caches   — decode: read + write once per step
    """
    del n_chips
    dt = 2 if cfg.dtype == "bfloat16" else 4
    n_full = cfg.n_params()
    n_active = cfg.n_active_params()
    d = cfg.d_model
    n_slots = len(cfg.block_pattern())
    kind = meta["kind"]
    tokens = meta["tokens_per_step"]

    if kind == "train":
        m = meta["m"]
        k = meta["K"]
        w = m * n_full * dt * (6.0 * k + 3.0)
        act = tokens * n_slots * 8 * 2.5 * d * dt
        logits = tokens * cfg.vocab_size * 4 * 2      # f32 fwd+bwd
        return w + act + logits
    if kind == "prefill":
        w = n_full * dt
        act = tokens * n_slots * 8 * d * dt
        return w + act
    # decode
    w = n_active * dt
    cache = meta.get("cache_bytes", 0) * 2.0          # read + write
    act = tokens * n_slots * 8 * d * dt
    logits = tokens * cfg.vocab_size * dt
    return w + cache + act + logits
