"""The port's build and dry-run layer (``repro_torch.launch.build``,
``launch.dryrun``, ``launch.mesh.make_production_mesh``, ``bench.roofline``
and ``launch.report``'s roofline mode) against the JAX package's, on the
CPU.

The reference's builds run in one subprocess with 8 XLA host devices on
its ``(4, 2)`` ``("data", "model")`` test mesh, build only (no lower, no
compile); the port builds on the same mesh of ``meta`` cells.

* ``validate_sharding``: every arch at mp 2, 4 and 8 gives the
  reference's leaf count, sharded dims and replicated fallbacks (leaf
  names mapped to the port's flat names);
* ``skip_reason``, ``model_flops`` and ``analytic_hbm_bytes`` equal the
  reference's for every arch x ``INPUT_SHAPES``, exactly;
* ``build_train_step`` / ``build_prefill_step`` / ``build_decode_step``
  of one reduced arch of each family (and mixtral's strategy B): the
  ``meta`` dict, every argument's shape and dtype (the PRNG key int64
  [2], the port's layout of the reference's uint32 [2]) and the param,
  batch and cache specs equal the reference's, leaf by leaf;
* the reduced SmolLM train step's matmul FLOPs (structural, on ``meta``)
  exactly twice the reference's ``dot_general`` FLOPs (jaxpr, scans
  multiplied): a shard's one client runs as two lanes; its strategy-B
  build on the mesh's cells (no lone lane; every one of the dp = 4 data
  rows runs the whole batch) within 2 % of dp times them; its recorded
  permutes exact;
* ``run_one`` records: the H100 terms from the record's own counts (a
  model-sharded decode row's and a strategy-B train row's collective
  term from its recorded bytes), a multi-pod strategy-B row with a null
  collective term and its reason;
* ``bench.roofline.run`` and the report's table give the reference's
  rows from the same two JSON records.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import (INPUT_SHAPES, get_config,  # noqa: E402
                                 list_archs, reduced)
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import build as B  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.cost_model import (analytic_hbm_bytes,  # noqa: E402
                                           structural_costs)
from repro_torch.launch.mesh import make_named_mesh  # noqa: E402

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FAMILIES = ("smollm-135m", "qwen3-moe-30b-a3b", "mamba2-780m", "zamba2-1.2b",
            "whisper-tiny", "llama-3.2-vision-11b", "mixtral-8x22b")
SHAPES = {"train": ("t", 32, 8, "train"), "prefill": ("p", 32, 8, "prefill"),
          "decode": ("d", 32, 8, "decode")}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_REFERENCE = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec
    from repro.configs import get_config, reduced
    from repro.configs.base import InputShape
    from repro.launch import build as B
    from repro.launch.cost_model import (_conv_flops, _dot_flops,
                                         _sub_jaxprs)
    from repro.launch.mesh import make_test_mesh
    from repro_torch.convert import index_key

    FAMILIES, SHAPES = json.loads(sys.argv[1]), json.loads(sys.argv[2])

    def flat(tree, prefix=""):
        if tree is None:
            return {}
        if isinstance(tree, (NamedSharding, PartitionSpec)):
            spec = tree.spec if isinstance(tree, NamedSharding) else tree
            return {prefix[:-1]: [list(e) if isinstance(e, tuple) else e
                                  for e in spec]}
        if hasattr(tree, "shape") and hasattr(tree, "dtype"):
            return {prefix[:-1]: [list(tree.shape), str(tree.dtype)]}
        if hasattr(tree, "_asdict"):
            items = tree._asdict().items()
        elif isinstance(tree, dict):
            items = tree.items()
        else:
            items = ((index_key(i, len(tree)), a) for i, a in enumerate(tree))
        out = {}
        for k, a in items:
            out.update(flat(a, f"{prefix}{k}/"))
        return out

    def dot_flops(jaxpr):
        total = 0.0
        for e in jaxpr.eqns:
            name = e.primitive.name
            if name == "dot_general":
                total += _dot_flops(e)
            elif name == "conv_general_dilated":
                total += _conv_flops(e)
            elif name == "scan":
                total += dot_flops(e.params["jaxpr"].jaxpr) * e.params["length"]
            elif name == "shard_map":
                nd = float(np.prod(e.params["mesh"].axis_sizes))
                total += dot_flops(e.params["jaxpr"]) * nd
            elif name == "while":
                total += dot_flops(e.params["body_jaxpr"].jaxpr)
            elif name == "cond":
                total += max(dot_flops(b.jaxpr) for b in e.params["branches"])
            else:
                for sub in _sub_jaxprs(e):
                    total += dot_flops(sub.jaxpr)
        return total

    mesh = make_test_mesh((4, 2), ("data", "model"))
    out = {}
    for arch in FAMILIES:
        cfg = reduced(get_config(arch))
        for kind, shp in SHAPES.items():
            b = {"train": B.build_train_step, "prefill": B.build_prefill_step,
                 "decode": B.build_decode_step}[kind](
                cfg, mesh, InputShape(*shp))
            ji = b.fn._jit_info
            ins = jax.tree.unflatten(ji.in_shardings_treedef,
                                     ji.in_shardings_leaves)
            rec = {"meta": json.loads(json.dumps(b.meta)),
                   "args": flat(b.args), "specs": flat(ins)}
            if arch == "smollm-135m" and kind == "train":
                rec["dot_flops"] = dot_flops(
                    jax.make_jaxpr(b.fn)(*b.args).jaxpr)
            out[f"{arch}/{kind}"] = rec
    print("JSON::" + json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference():
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")])}
    res = subprocess.run(
        [sys.executable, "-c", _REFERENCE, json.dumps(FAMILIES),
         json.dumps(SHAPES)], capture_output=True, text=True, timeout=600,
        env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-4000:]
    line = next(ln for ln in res.stdout.splitlines()
                if ln.startswith("JSON::"))
    return json.loads(line[len("JSON::"):])


def _flat(tree, prefix=""):
    """The port's built arguments / specs as the subprocess flattens the
    reference's: flat name -> [shape, dtype] or a spec's entries."""
    from repro_torch.convert import index_key
    from repro_torch.sharding import P
    if tree is None:
        return {}
    if isinstance(tree, P):
        return {prefix[:-1]: [list(e) if isinstance(e, tuple) else e
                              for e in tree]}
    if isinstance(tree, torch.Tensor):
        return {prefix[:-1]: [list(tree.shape),
                              str(tree.dtype).replace("torch.", "")]}
    if hasattr(tree, "_asdict"):
        items = tree._asdict().items()
    elif isinstance(tree, dict):
        items = tree.items()
    else:
        items = ((index_key(i, len(tree)), a) for i, a in enumerate(tree))
    out = {}
    for k, a in items:
        out.update(_flat(a, f"{prefix}{k}/"))
    return out


MESH = make_named_mesh((4, 2), ("data", "model"), device="meta")


def _port_build(arch, kind):
    fn = {"train": B.build_train_step, "prefill": B.build_prefill_step,
          "decode": B.build_decode_step}[kind]
    return fn(reduced(get_config(arch)), MESH, InputShape(*SHAPES[kind]))


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("kind", list(SHAPES))
def test_builds_equal_the_reference(reference, arch, kind):
    ref = reference[f"{arch}/{kind}"]
    built = _port_build(arch, kind)
    assert json.loads(json.dumps(built.meta)) == ref["meta"]
    got = _flat(built.args)
    want = dict(ref["args"])
    if kind == "train":                  # the key's layout, not its value
        assert want.pop("0/rng") == [[2], "uint32"]
        assert got.pop("0/rng") == [[2], "int64"]
    assert got == want
    assert _flat(built.specs[0]) == ref["specs"]


def test_reduced_smollm_train_step_counts_against_the_reference(reference):
    """The reduced SmolLM round on the (4, 2) mesh of meta cells (one
    client a shard): matmul FLOPs exactly twice the reference's
    dot_general FLOPs, since the port runs a lone lane as two
    (``core.local_sgd.loss_and_grad``: cuBLAS splits a batch of one
    differently); the strategy-B build of the same step (two clients, the
    same tokens, no lone lane) on the mesh's cells within 2 % of dp = 4
    times the reference's: under B the batch is not cut, so each of the
    4 data rows runs the whole batch on its column group (the rows'
    products are column-parallel splits of the one program's, so each
    row's FLOPs are the reference's); its kernel records (B3 once a
    local step a cell) and its recorded permutes (each cell's fp32
    stream to its column's two ring neighbours)."""
    built = _port_build("smollm-135m", "train")
    costs = structural_costs(built.fn, *built.args)
    want = reference["smollm-135m/train"]["dot_flops"]
    assert costs.matmul_flops == 2 * want, (costs.matmul_flops, want)
    cells = B.build_train_step(reduced(get_config("smollm-135m")), MESH,
                               InputShape(*SHAPES["train"]), strategy="B")
    assert cells.meta["tokens_per_step"] == built.meta["tokens_per_step"]
    assert cells.mesh is MESH
    dp = MESH.sizes["data"]
    c_costs = structural_costs(cells.fn, *cells.args)
    assert abs(c_costs.matmul_flops - dp * want) / (dp * want) < 0.02, (
        c_costs.matmul_flops, want)
    n_shards, mp = 4, 2
    assert costs.kernels["momentum_sgd"]["calls"] == n_shards * mp * 2
    # The fp32 ring: every cell ships its whole stream (its leaves, cut
    # or replicated) to its two neighbours' cells in its column.
    cells = built.mesh.shard(built.args[0].params, built.specs[0][0].params)
    assert costs.coll_by_kind["collective-permute"] == 2 * sum(
        t.numel() * t.element_size() for c in cells for t in c.values())
    assert costs.coll_by_kind["all-reduce"] > 0
    assert costs.coll_by_kind["all-gather"] > 0


def test_validate_sharding_equals_the_reference():
    code = textwrap.dedent("""
        import json
        from repro.launch.dryrun import validate_sharding
        recs = validate_sharding(verbose=False)
        print("JSON::" + json.dumps(recs))
    """)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")])}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-4000:]
    want = json.loads(next(ln for ln in res.stdout.splitlines()
                           if ln.startswith("JSON::"))[len("JSON::"):])
    got = dryrun.validate_sharding(verbose=False)
    assert len(got) == len(want) == 3 * len(list_archs())

    def ref_name(keystr):
        # "['stages'][3]['attn']['wq']" -> "stages/3/attn/wq"
        return "/".join(p.strip("'") for p in keystr[1:-1].split("]["))

    def port_name(name):
        # "stages/03/attn/wq" -> "stages/3/attn/wq"
        return "/".join(str(int(p)) if p.isdigit() else p
                        for p in name.split("/"))

    for g, w in zip(got, want):
        assert (g["arch"], g["model_parallel"], g["n_leaves"],
                g["sharded_dims"]) == (w["arch"], w["model_parallel"],
                                       w["n_leaves"], w["sharded_dims"])
        assert sorted((port_name(f["leaf"]), f["dim"], f["size"])
                      for f in g["replicated_fallbacks"]) == sorted(
            (ref_name(f["leaf"]), f["dim"], f["size"])
            for f in w["replicated_fallbacks"])


def _meta_of(cfg, shape_name):
    """A build's meta dict for the analytic models, without building:
    the production mesh's strategy-A m, K = 2, and the decode cache's
    bytes from the port's cache shapes."""
    from repro_torch.models import model as M
    shape = INPUT_SHAPES[shape_name]
    if shape.kind == "train":
        m = 2 if cfg.name.startswith("mixtral") else 16
        local_bs = max(1, shape.global_batch // m)
        return {"kind": "train", "m": m, "K": 2,
                "tokens_per_step": m * 2 * local_bs * shape.seq_len}
    if shape.kind == "prefill":
        return {"kind": "prefill",
                "tokens_per_step": shape.global_batch * shape.seq_len}
    caches = M.init_decode_caches(cfg, shape.global_batch, shape.seq_len,
                                  device="meta")
    return {"kind": "decode", "tokens_per_step": shape.global_batch,
            "cache_bytes": sum(t.numel() * t.element_size() for c in caches
                               if c is not None for t in c.values())}


def test_skips_and_analytic_models_equal_the_reference():
    from repro.configs import get_config as r_get_config
    from repro.launch import build as r_build
    from repro.launch import cost_model as r_cost

    code = textwrap.dedent("""
        import json, sys
        from repro.configs import get_config
        from repro.launch.dryrun import model_flops
        cases = json.loads(sys.argv[1])
        print("JSON::" + json.dumps([model_flops(get_config(a), m)
                                     for a, m in cases]))
    """)
    cases = []
    for arch in list_archs():
        cfg, rcfg = get_config(arch), r_get_config(arch)
        for shape in INPUT_SHAPES:
            assert B.skip_reason(cfg, shape) == r_build.skip_reason(rcfg,
                                                                    shape)
            meta = _meta_of(cfg, shape)
            assert analytic_hbm_bytes(cfg, meta, 256) == \
                r_cost.analytic_hbm_bytes(rcfg, meta, 256), (arch, shape)
            cases.append((arch, meta))
    # repro.launch.dryrun sets XLA_FLAGS at import: its own process.
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    res = subprocess.run([sys.executable, "-c", code, json.dumps(cases)],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-4000:]
    want = json.loads(next(ln for ln in res.stdout.splitlines()
                           if ln.startswith("JSON::"))[len("JSON::"):])
    assert [dryrun.model_flops(get_config(a), m) for a, m in cases] == want


def test_run_one_records(tmp_path, monkeypatch):
    """A decode row (model-sharded on the production mesh's cells) and
    mixtral's strategy-B train row (one layer, on the mesh's cells): the
    H100 terms from the record's own counts, each row's collective term
    from its recorded bytes, the dominant term, the memory analysis's
    scope, and the saved JSON; the multi-pod strategy-B train row (on
    the pod mesh's cells) with its ring's payloads over "pod" in its
    collective term."""
    from repro_torch.launch import mesh as LM
    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    rec = dryrun.run_one("smollm-135m", "decode_32k", multi_pod=False,
                         cfg_overrides={"n_layers": 2})
    assert rec["n_chips"] == 256 and rec["meta"]["kind"] == "decode"
    t = rec["roofline"]
    assert t["compute_s"] == rec["struct_flops_global"] / (
        256 * LM.PEAK_FLOPS_BF16)
    assert t["memory_s"] == rec["analytic_hbm_bytes_global"] / (
        256 * LM.HBM_BW)
    assert rec["struct_coll_bytes_per_dev"] > 0
    assert t["collective_s"] == rec["struct_coll_bytes_per_dev"] / \
        LM.NVLINK_BW
    assert rec["dominant"] == max(t, key=t.get)
    assert rec["memory_analysis"]["temp_size_in_bytes"] is None
    saved = json.loads((tmp_path / "smollm-135m__decode_32k__16x16__"
                        "baseline.json").read_text())
    assert saved["roofline"] == t
    b = dryrun.run_one("mixtral-8x22b", "train_4k", multi_pod=False,
                       save=False, cfg_overrides={"n_layers": 1})
    assert b["meta"]["strategy"] == "B" and b["meta"]["mixer"] == "dense"
    assert b["struct_coll_bytes_per_dev"] > 0
    assert b["roofline"]["collective_s"] == b["struct_coll_bytes_per_dev"] \
        / LM.NVLINK_BW
    assert b["struct_coll_by_kind"]["all-gather"] > 0
    assert b["struct_flops_global"] > 0 and b["useful_flops_ratio"] > 0
    pods = dryrun.run_one("mixtral-8x22b", "train_4k", multi_pod=True,
                          save=False, cfg_overrides={"n_layers": 1})
    assert tuple(pods["meta"]["client_axes"]) == ("pod",)
    assert pods["meta"]["mixer"] == "ring" and pods["n_chips"] == 512
    assert pods["struct_coll_by_kind"]["collective-permute"] > 0
    assert pods["roofline"]["collective_s"] == \
        pods["struct_coll_bytes_per_dev"] / LM.NVLINK_BW
    skip = dryrun.run_one("smollm-135m", "long_500k", multi_pod=False,
                          save=False)
    assert skip["skipped"].startswith("full-attention arch")


def _records():
    ok = {"arch": "smollm-135m", "shape": "train_4k", "mesh": "16x16",
          "tag": "baseline", "compile_s": 1.5,
          "roofline": {"compute_s": 0.0123, "memory_s": 0.0456,
                       "collective_s": 0.0012},
          "dominant": "memory_s", "useful_flops_ratio": 0.7361,
          "collective_looped": {"wire_bytes": 1.25e9}}
    skip = {"arch": "gemma-7b", "shape": "long_500k", "mesh": "16x16",
            "tag": "baseline",
            "skipped": "full-attention arch: 512k dense KV decode has no "
                       "sub-quadratic path (DESIGN.md §5)"}
    return ok, skip


def test_roofline_rows_and_report_equal_the_reference(tmp_path,
                                                      monkeypatch):
    from benchmarks import bench_roofline as r_roof
    from repro.launch import report as r_report
    from repro_torch.bench import roofline, timevarying
    from repro_torch.launch import report

    for i, rec in enumerate(_records()):
        (tmp_path / f"r{i}.json").write_text(json.dumps(rec))
    fused = {"fused": {
        "bits": 8, "bytes_min_per_round": 1.0e7,
        "unfused": {"bytes_moved_per_round": 9.0e7, "roofline_ratio": 9.0,
                    "us_per_round": 120.5},
        "fused": {"bytes_moved_per_round": 8.0e7, "roofline_ratio": 8.0,
                  "us_per_round": 100.25},
        "tail_kernel_bytes": {"unfused": 983192.0, "fused": 786584.0},
        "tail_kernel_bytes_saved_frac": 0.2}}
    gossip = tmp_path / "bench" / "gossip.json"
    gossip.parent.mkdir()
    gossip.write_text(json.dumps(fused))
    monkeypatch.setattr(r_roof, "OUT", tmp_path)
    monkeypatch.setattr(r_roof, "GOSSIP", gossip)
    monkeypatch.setattr(roofline, "OUT", tmp_path)
    monkeypatch.setattr(timevarying, "GOSSIP_JSON", gossip)
    assert roofline.run() == r_roof.run()
    monkeypatch.setattr(r_report, "OUT_DIR", tmp_path)
    monkeypatch.setattr(report, "OUT_DIR", tmp_path)
    assert report.markdown_table(report.load()) == \
        r_report.markdown_table(r_report.load())
    assert report.markdown_table(report.load(mesh="2x16x16")) == \
        r_report.markdown_table(r_report.load(mesh="2x16x16"))
    monkeypatch.setattr(roofline, "OUT", tmp_path / "none")
    monkeypatch.setattr(r_roof, "OUT", tmp_path / "none")
    port_rows, ref_rows = roofline.run(), r_roof.run()
    assert port_rows[:-1] == ref_rows[:-1]
    assert port_rows[-1][:2] == ref_rows[-1][:2] == (
        "roofline/no-dryrun-data", 0.0)


def test_production_mesh_and_constants():
    from repro_torch.launch.mesh import (HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16,
                                         make_production_mesh)
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (one.devices.shape, one.axis_names) == ((16, 16),
                                                   ("data", "model"))
    assert (two.devices.shape, two.axis_names) == ((2, 16, 16),
                                                   ("pod", "data", "model"))
    assert {str(d) for d in two.devices.flat} == {"meta"}
    assert (HBM_BW, PEAK_FLOPS_BF16, NVLINK_BW) == (3.35e12, 989e12, 450e9)
    assert np.asarray(one.devices).size == 256
