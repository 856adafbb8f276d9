"""Multi-pod dry-run: what a step of every registered architecture should
cost on the reference's deployment meshes — the port of the JAX
package's ``launch/dryrun.py``.

The reference fakes 512 XLA host devices, lowers and compiles each step
and reads XLA's cost and memory analyses and the partitioned HLO. The
port evaluates the step (``launch.build``) once on ``meta`` tensors
under ``cost_model.structural_costs`` and ``hlo_stats`` 's recorder: a
strategy-A train step runs on the ``ClientMesh`` of the production
mesh's cells (every cell's work, Python loop by loop), so its FLOPs,
bytes, kernel records and collective bytes are the whole program's.
The serving steps (prefill, decode, long_500k) run model-sharded on the
mesh's ``meta`` cells (``launch.build``, a ``launch.mesh.ServeMesh``),
every data row a column group, the rows after the first replayed from
its counts. Nothing is allocated. The roofline terms use the H100's
constants (``launch.mesh``):

  compute    = FLOPs / (chips * PEAK_FLOPS_BF16)   [structural, global]
  memory     = bytes / (chips * HBM_BW)            [analytic HBM model;
               the structural byte count, an unfused upper bound, is
               reported beside it]
  collective = (recorded wire bytes / chips) / NVLINK_BW

A serving row's collective term is the port's own transfers (the
column sums, the logits join, the head_dim-cut cache's score sums, the
data-axis weight gathers), not the reference's GSPMD choices. A train
step under strategies B, B2 and B3 runs on the mesh's ``meta`` cells too
(``core.local_sgd.local_train_rows``: each data row a column group, the
rows after the first replayed), its collective term the port's
transfers: the data-axis weight gathers, their backward's
reduce-scatters, the data column's all-reduces of the other gradients
and the column groups' operations, and on the multi-pod mesh the ring's
payloads over ``"pod"`` (f32 rows, or words, scales and ``lemma5``
replicas: ``core.mixing._exchange``), fp32 or quantized. The fields
only XLA gives are left out: ``xla_flops_per_device_loops_x1``,
``xla_bytes_per_device_loops_x1``, ``collective_flat`` (the flat HLO
pass) and ``compile_s`` / ``lower_s``. ``memory_analysis`` gives the
argument and output bytes of the meta tensors (every cell's buffers);
``temp_size_in_bytes`` is null, as there is no compiled buffer
assignment to read it from.

Records go to ``experiments/dryrun_torch/`` (git-ignored), never to the
reference's ``experiments/dryrun/``:

    python -m repro_torch.launch.dryrun [--arch a,b] [--shape s]
        [--mesh single|multi|both] [--strategy A|B|B2|B3] [--tag T]
        [--bits 8] [--mixer ring] [--local-steps 2] [--eta 1e-3]
    python -m repro_torch.launch.dryrun --validate-sharding
        [--model-parallels 2,4,8]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
import types
from pathlib import Path

import numpy as np

from ..configs import INPUT_SHAPES, get_config, list_archs
from .build import build_step, skip_reason
from .cost_model import analytic_hbm_bytes, structural_costs
from .mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16, make_production_mesh

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

__all__ = ["validate_sharding", "model_flops", "roofline_terms", "run_one",
           "main"]


def validate_sharding(archs=None, model_parallels=(2, 4, 8),
                      clients=2, strategy_rules=None, verbose=True):
    """Shardability pre-flight for the 2D ``(clients, model)`` mesh: for
    every registered config, evaluate the parameter dict on ``meta`` (no
    allocation) and build its PartitionSpecs under the strategy-A rules at
    each ``model_parallel`` degree, reporting which rule-covered dims FALL
    BACK TO REPLICATED (a dim that doesn't divide the model axis, e.g.
    smollm's 9 heads over model=2). A config whose spec construction
    RAISES is a hard failure.

    Only mesh axis names/sizes are consulted (a stand-in object), so this
    runs on any host. Returns a list of per-(arch, mp) record dicts
    (leaves by the port's flat names); ``record["error"]`` is set on
    failure.
    """
    from ..models import model as M
    from ..sharding.rules import (RULES_A, shapes_and_axes, specs_for_tree,
                                  stack_shapes)

    rules = strategy_rules or RULES_A
    archs = list(archs) if archs else list_archs()
    records = []
    for arch in archs:
        cfg = get_config(arch)
        try:
            shapes, axes = shapes_and_axes(
                lambda k, cfg=cfg: (M.init_model(k, cfg, device="meta"),
                                    M.model_axes(cfg)))
            stacked = stack_shapes(shapes, clients)
        except Exception as e:  # noqa: BLE001
            for mp in model_parallels:
                records.append({"arch": arch, "model_parallel": mp,
                                "error": f"init on meta: {e!r}"})
            continue
        for mp in model_parallels:
            fake_mesh = types.SimpleNamespace(
                axis_names=("clients", "model"),
                devices=np.empty((clients, mp)))
            rec = {"arch": arch, "model_parallel": mp,
                   "n_leaves": len(axes)}
            try:
                specs = specs_for_tree(axes, stacked, rules, fake_mesh,
                                       leading_client=("clients",))
            except Exception as e:  # noqa: BLE001
                rec["error"] = repr(e)
                records.append(rec)
                continue
            sharded, fallbacks = 0, []
            for name, names in axes.items():
                spec = specs[name]
                for i, dim in enumerate(names):
                    if dim is None or dim not in rules or dim == "layers":
                        continue
                    if "model" in spec.names(i + 1):
                        sharded += 1
                    else:
                        fallbacks.append({
                            "leaf": name, "dim": dim,
                            "size": int(stacked[name].shape[i + 1])})
            rec.update(sharded_dims=sharded, replicated_fallbacks=fallbacks)
            records.append(rec)
            if verbose:
                fb = ", ".join(f"{f['leaf']}:{f['dim']}={f['size']}"
                               for f in fallbacks) or "none"
                print(f"[shard-ok] {arch} @ model_parallel={mp}: "
                      f"{sharded} dims sharded, replicated fallbacks: {fb}")
    return records


def model_flops(cfg, meta) -> float:
    """Analytic MODEL_FLOPS: 6*N_active*D (train) / 2*N_active*D (serve)."""
    n = cfg.n_active_params()
    d = meta["tokens_per_step"]
    return (6.0 if meta["kind"] == "train" else 2.0) * n * d


def roofline_terms(cfg, meta: dict, struct, n_chips: int
                   ) -> tuple[dict, str]:
    """The three roofline terms (seconds) of one step from its
    structural costs on ``n_chips`` H100s, and the dominant one: compute
    = FLOPs / (chips * PEAK_FLOPS_BF16), memory = the analytic HBM bytes
    / (chips * HBM_BW), collective = a device's share of the recorded
    wire bytes / NVLINK_BW."""
    hbm_bytes = analytic_hbm_bytes(cfg, meta, n_chips)
    terms = {"compute_s": struct.flops / (n_chips * PEAK_FLOPS_BF16),
             "memory_s": hbm_bytes / (n_chips * HBM_BW),
             "collective_s": struct.coll_bytes / n_chips / NVLINK_BW}
    dom = max(terms, key=terms.get)
    return terms, dom


def _nbytes(tree) -> int:
    """Bytes of every tensor in a nest of dicts, lists and tuples."""
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    return 0


def _save(rec: dict) -> None:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    out = OUT_DIR / (f"{rec['arch']}__{rec['shape']}__{rec['mesh']}__"
                     f"{rec['tag']}.json")
    out.write_text(json.dumps(rec, indent=2, default=str))


def run_one(arch: str, shape_name: str, *, multi_pod: bool,
            strategy: str | None = None, tag: str = "baseline",
            dfed=None, save: bool = True,
            cfg_overrides: dict | None = None) -> dict:
    """Build one (arch, shape, mesh) row on ``meta`` cells, count one
    evaluation's costs and collectives, and return (and save, unless
    ``save`` is False) its record with the H100 roofline terms; a skipped
    row records the reason."""
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    reason = skip_reason(cfg, shape_name)
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "tag": tag}
    if reason:
        rec["skipped"] = reason
        if save:
            _save(rec)
        print(f"[skip] {arch} x {shape_name} x {mesh_name}: {reason}")
        return rec

    mesh = make_production_mesh(multi_pod=multi_pod)
    n_chips = mesh.devices.size
    t0 = time.time()
    kw = {"strategy": strategy} if INPUT_SHAPES[shape_name].kind == "train" \
        else {}
    if dfed is not None and INPUT_SHAPES[shape_name].kind == "train":
        kw["dfed"] = dfed
    built = build_step(cfg, mesh, shape_name, **kw)
    t_build = time.time() - t0

    # Structural costs and recorded collectives of one evaluation on meta.
    t1 = time.time()
    outs = []
    struct = structural_costs(lambda *a: outs.append(built.fn(*a)),
                              *built.args)
    t_struct = time.time() - t1

    mf = model_flops(cfg, built.meta)
    hbm_bytes = analytic_hbm_bytes(cfg, built.meta, n_chips)
    terms, dom = roofline_terms(cfg, built.meta, struct, n_chips)
    compute_t, memory_t, coll_t = (terms["compute_s"], terms["memory_s"],
                                   terms["collective_s"])
    wire_per_dev = struct.coll_bytes / n_chips

    rec.update({
        "meta": built.meta,
        "n_chips": n_chips,
        "build_s": round(t_build, 2),
        "struct_s": round(t_struct, 2),
        "struct_flops_global": struct.flops,
        "struct_matmul_flops_global": struct.matmul_flops,
        "struct_bytes_global_unfused_ub": struct.bytes,
        "struct_kernel_bytes_global": struct.kernel_bytes,
        "struct_kernels": struct.kernels,
        "analytic_hbm_bytes_global": hbm_bytes,
        "struct_coll_bytes_per_dev": wire_per_dev,
        "struct_coll_by_kind": {
            k: v / n_chips for k, v in struct.coll_by_kind.items()},
        "collective_looped": {
            "wire_bytes": wire_per_dev,
            "by_kind": {k: v / n_chips
                        for k, v in struct.coll_by_kind.items()}},
        "memory_analysis": {
            "argument_size_in_bytes": _nbytes(built.args),
            "output_size_in_bytes": _nbytes(outs[0]),
            "temp_size_in_bytes": None,
            "generated_code_size_in_bytes": None,
            "scope": "global: every cell's buffers",
            "temp_null_reason": "no compiled buffer assignment to read "
                                "temporaries from (meta evaluation)"},
        "model_flops_total": mf,
        "useful_flops_ratio": (mf / struct.flops if struct.flops else None),
        "roofline": terms,
        "dominant": dom,
    })
    if save:
        _save(rec)
    coll_ms = f"{coll_t * 1e3:.1f}"
    print(f"[ok] {arch} x {shape_name} x {mesh_name} ({tag}): "
          f"struct={t_struct:.1f}s "
          f"Gflops/dev={struct.flops / n_chips / 1e9:.1f} "
          f"GB/dev={struct.bytes / n_chips / 1e9:.2f} "
          f"wire/dev={wire_per_dev / 1e9:.3f}GB "
          f"terms(ms)=[{compute_t * 1e3:.1f}/{memory_t * 1e3:.1f}/"
          f"{coll_ms}] dominant={dom} "
          f"useful={rec['useful_flops_ratio'] and round(rec['useful_flops_ratio'], 3)}",
          flush=True)
    return rec


def main(argv=None):
    """The dry-run's command line: every selected (arch, shape, mesh) row
    through :func:`run_one`, records under ``OUT_DIR``."""
    ap = argparse.ArgumentParser(description="multi-pod dry-run")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--strategy", default=None,
                    choices=[None, "A", "B", "B2", "B3"])
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--bits", type=int, default=32,
                    help="gossip wire quantization (train shapes)")
    ap.add_argument("--mixer", default=None,
                    choices=[None, "ring", "torus", "sparse", "dense"])
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--eta", type=float, default=1e-3)
    ap.add_argument("--validate-sharding", action="store_true",
                    help="2D-mesh pre-flight only: check every config's "
                         "parameters shard under the rule set at each "
                         "--model-parallels degree, report replicated "
                         "fallbacks, exit 1 on any failure")
    ap.add_argument("--model-parallels", default="2,4,8",
                    help="comma-separated model_parallel degrees for "
                         "--validate-sharding")
    args = ap.parse_args(argv)

    if args.validate_sharding:
        archs = None if args.arch == "all" else args.arch.split(",")
        mps = tuple(int(v) for v in args.model_parallels.split(","))
        records = validate_sharding(archs=archs, model_parallels=mps)
        errors = [r for r in records if r.get("error")]
        if errors:
            print(f"\n{len(errors)} SHARDING FAILURES:")
            for r in errors:
                print(f"  {r['arch']} @ model_parallel="
                      f"{r['model_parallel']}: {r['error']}")
            raise SystemExit(1)
        print(f"\nall {len(records)} (arch, model_parallel) combinations "
              f"shard cleanly")
        return

    dfed = None
    if args.bits < 32 or args.mixer is not None or args.local_steps != 2:
        from ..core import DFedAvgMConfig, QuantConfig
        dfed = DFedAvgMConfig(
            eta=args.eta, theta=0.9, local_steps=args.local_steps,
            quant=QuantConfig(bits=args.bits) if args.bits < 32 else None,
            mixer_impl=args.mixer or "auto")

    archs = list_archs() if args.arch == "all" else args.arch.split(",")
    shapes = list(INPUT_SHAPES) if args.shape == "all" \
        else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    run_one(arch, shape, multi_pod=mp,
                            strategy=args.strategy, tag=args.tag,
                            dfed=dfed)
                except Exception as e:  # noqa: BLE001
                    failures.append((arch, shape, mp, repr(e)))
                    print(f"[FAIL] {arch} x {shape} x multi={mp}: {e}")
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nall dry-runs passed")


if __name__ == "__main__":
    main()
