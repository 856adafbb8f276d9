"""The train step of strategies B, B2 and B3 on the multi-pod mesh, with
a quantized wire, with the fused round on one pod, and B2 on the SSM
families (``repro_torch.launch.build.build_train_step`` on a
``launch.mesh.ServeMesh``), against the JAX package's own
``build_train_step`` on 8 forced host devices, on the CPU.

* One round of reduced SmolLM-135M and reduced Mixtral-8x22B under B, B2
  and B3 on (2, 2, 2) ``("pod", "data", "model")`` cells (fp32: the ring
  over ``"pod"``); B3 with the 8-bit ``lemma5`` wire on (2, 2, 2) and on
  (4, 2) ``("data", "model")`` (the dense mix); B2 fused on (4, 2), and
  B3 fused with 8 bits there; B2 on
  reduced Mamba2-780M and Zamba2-1.2B on (4, 2), their inner dim cut over
  ``("data", "model")`` and re-cut on head boundaries. The reference's
  parameters and tokens come across as numpy. fp32: the loss,
  ``consensus_dist``, ``local_drift`` and every leaf within rtol 1e-5,
  atol 1e-6 of the reference's step; 8 bits: the loss and
  ``local_drift`` so, ``consensus_dist`` within rtol 1e-3 and every
  leaf within one quantizer step of the reference (the largest scale
  the round used for that leaf: a value whose rounding flips moves by
  a step). Every block that no cut tells apart is bitwise equal on the
  cells that hold it.
* The 8-bit mix alone, given the same x and z (numpy from a seed), on
  the pod ring (B and B2 specs: two dims cut by different axes, a dim
  cut over ``("data", "model")``) and the dense mix on (4, 2): every
  dequantized delta bitwise the reference quantizer's, the output
  within four ulp of the leaf's largest value of the reference's mixer.
* A round's recorded collectives (the pod ring's payloads over "pod"
  included) and kernel records on the CPU cells equal the same build's
  on ``meta`` cells.
* What stays refused: the fused round on the pod mesh (the reference's
  reason), an MLP whose weights cut their hidden dim unalike.
"""
import os
import shutil
import subprocess
import sys
import tempfile
import textwrap
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import prng  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.core import (DFedAvgMConfig, MixingSpec,  # noqa: E402
                              QuantConfig, RoundState)
from repro_torch.core import mixing as MX  # noqa: E402
from repro_torch.core.wire_layout import WireLayout  # noqa: E402
from repro_torch.launch import build as B  # noqa: E402
from repro_torch.launch.mesh import Cells, make_named_mesh  # noqa: E402
from repro_torch.sharding import P  # noqa: E402

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = ("t", 16, 8, "train")          # seq 16, global batch 8
RTOL, ATOL = 1e-5, 1e-6
Q8_CONSENSUS_RTOL = 1e-3
MIX_ULP = 4
AXES = {"2x2x2": ("pod", "data", "model"), "4x2": ("data", "model")}

# arch, strategy, mesh, bits, fused
ROUNDS = ([(a, s, "2x2x2", 32, 0) for a in ("smollm-135m", "mixtral-8x22b")
           for s in ("B", "B2", "B3")]
          + [("smollm-135m", "B3", "2x2x2", 8, 0),
             ("smollm-135m", "B3", "4x2", 8, 0),
             ("smollm-135m", "B2", "4x2", 32, 1),
             ("smollm-135m", "B3", "4x2", 8, 1),
             ("mamba2-780m", "B2", "4x2", 32, 0),
             ("zamba2-1.2b", "B2", "4x2", 32, 0)])
# strategy, mesh of the 8-bit mix alone
MIXES = [("B", "2x2x2"), ("B2", "2x2x2"), ("B", "4x2"), ("B2", "4x2")]
N_REFERENCE_PROCS = 4

_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as JP
    from repro.configs import get_config, reduced
    from repro.configs.base import InputShape
    from repro.core import (DFedAvgMConfig, MixingSpec, QuantConfig,
                            RoundState)
    from repro.core.mixing import (MixerConfig, _mix_dense_quantized,
                                   _quant_leaf_keys, make_mixer)
    from repro.core.quantize import dequantize_int, quantize_int
    from repro.launch import build as B
    from repro.launch.mesh import make_test_mesh
    from repro.models import model as RM
    from repro.sharding.rules import (ShardingStrategy, shapes_and_axes,
                                      specs_for_tree, stack_shapes)

    AXES = {"2x2x2": ("pod", "data", "model"), "4x2": ("data", "model")}

    def flat(tree, prefix=""):
        # repro_torch.convert's names: keys joined by "/", a list index
        # zero-padded to the width of the list's last index
        if isinstance(tree, dict):
            items = tree.items()
        elif isinstance(tree, (list, tuple)):
            w = len(str(max(len(tree) - 1, 0)))
            items = ((f"{i:0{w}d}", t) for i, t in enumerate(tree))
        else:
            return {prefix[:-1]: np.asarray(tree)}
        out = {}
        for k, t in items:
            out.update(flat(t, f"{prefix}{k}/"))
        return out

    def mesh_of(name):
        shape = tuple(int(v) for v in name.split("x"))
        return make_test_mesh(shape, AXES[name])

    def save(out, name, res):
        with open(f"{out}/{name}.part", "wb") as f:
            np.savez(f, **res)
        os.replace(f"{out}/{name}.part", f"{out}/{name}.npz")

    def leaves(prefix, tree):
        return {prefix + n.replace("/", "|"): a
                for n, a in flat(tree).items()}

    def round_case(case, shape, out):
        arch, s, mname, bits, fused = case.split(":")
        rc = reduced(get_config(arch))
        mesh = mesh_of(mname)
        pods = "pod" in mesh.axis_names
        dfed = DFedAvgMConfig(
            eta=1e-3, theta=0.9, local_steps=2,
            quant=QuantConfig(bits=8) if bits == "8" else None,
            fuse_round=fused == "1", mixer_impl="ring" if pods else "dense")
        b = B.build_train_step(rc, mesh, shape, strategy=s, dfed=dfed)
        m, k, bs, seq = (b.meta[n] for n in ("m", "K", "local_bs", "seq"))
        ps = [RM.init_model(jax.random.PRNGKey(10 + i), rc)[0]
              for i in range(m)]
        stacked = jax.tree.map(lambda *a: jnp.stack(a), *ps)
        tok = np.random.default_rng(7).integers(
            0, rc.vocab_size, (m, k, bs, seq + 1)).astype(np.int32)
        state = RoundState(params=stacked, rng=jax.random.PRNGKey(1),
                           round=jnp.int32(0))
        new, met = b.fn(state, {"tokens": tok[..., :-1],
                                "targets": tok[..., 1:]})
        res = {"tokens": tok, "mixer": np.asarray(b.meta["mixer"]),
               **{f"m:{n}": np.asarray(v) for n, v in met.items()}}
        res.update(leaves("in:", stacked))
        res.update(leaves("out:", new.params))
        save(out, case.replace(":", "_"), res)

    def mix_case(case, shape, out):
        s, mname = case.split(":")[1:]
        rc = reduced(get_config("smollm-135m"))
        mesh = mesh_of(mname)
        strat = ShardingStrategy.for_arch(rc.name, mesh, strategy=s)
        m = strat.num_clients
        shapes, axes = shapes_and_axes(lambda k: RM.init_model(k, rc))
        stacked = stack_shapes(shapes, m)
        pspecs = specs_for_tree(axes, stacked, strat.rules, mesh,
                                leading_client=strat.client_axes)
        rng = np.random.default_rng(11)
        x = jax.tree.map(lambda t: (0.02 * rng.standard_normal(t.shape))
                         .astype(np.float32), stacked)
        z = jax.tree.map(lambda t: t + (1e-3 * rng.standard_normal(
            t.shape)).astype(np.float32), x)
        quant = QuantConfig(bits=8)
        key = jax.random.PRNGKey(5)
        spec = MixingSpec.ring(m)
        ns = jax.tree.map(lambda p: NamedSharding(mesh, p), pspecs,
                          is_leaf=lambda p: isinstance(p, JP))
        if strat.client_axes:
            mixer = make_mixer(spec, MixerConfig("ring", quant=quant), mesh,
                               client_axes=strat.client_axes,
                               param_specs=pspecs)
            fn = jax.jit(lambda a, b, k: mixer(a, b, k),
                         in_shardings=(ns, ns, None), out_shardings=ns)
        else:
            fn = jax.jit(lambda a, b, k: _mix_dense_quantized(
                spec.W, a, b, quant, k), in_shardings=(ns, ns, None),
                out_shardings=ns)
        got = fn(x, z, key)
        lx, treedef = jax.tree.flatten(x)
        lz = treedef.flatten_up_to(z)
        keys = _quant_leaf_keys(key, len(lx), m)
        q = []
        for li, (xl, zl) in enumerate(zip(lx, lz)):
            d = (zl - xl).astype(jnp.float32)
            q.append(jnp.stack([dequantize_int(*quantize_int(
                d[i].reshape(-1), quant, keys[li, i])).reshape(d.shape[1:])
                for i in range(m)]))
        res = {}
        res.update(leaves("x:", x))
        res.update(leaves("z:", z))
        res.update(leaves("out:", got))
        res.update(leaves("q:", jax.tree.unflatten(treedef, q)))
        save(out, case.replace(":", "_"), res)

    cases, out = sys.argv[1].split(","), sys.argv[2]
    shape = InputShape(sys.argv[3], int(sys.argv[4]), int(sys.argv[5]),
                       sys.argv[6])
    for case in cases:
        (mix_case if case.startswith("mix:") else round_case)(
            case, shape, out)
""")


def _round_name(case):
    return ":".join(map(str, case))


def _mix_name(case):
    return "mix:" + ":".join(case)


@pytest.fixture(scope="module", autouse=True)
def reference():
    """The reference's results for every case, computed by
    N_REFERENCE_PROCS subprocesses started with the module (the port's
    other tests run meanwhile); ``reference(name)`` waits for its
    file."""
    out = tempfile.mkdtemp(prefix="pods_ref_")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")])}
    names = [_round_name(c) for c in ROUNDS] + [_mix_name(c) for c in MIXES]
    procs = {}
    for k in range(N_REFERENCE_PROCS):
        cases = names[k::N_REFERENCE_PROCS]
        log = open(os.path.join(out, f"ref{k}.log"), "w")
        p = subprocess.Popen(
            [sys.executable, "-c", _REFERENCE, ",".join(cases), out,
             *map(str, SHAPE)],
            stdout=subprocess.DEVNULL, stderr=log, env=env, cwd=ROOT)
        log.close()
        for c in cases:
            procs[c] = (p, k)

    def get(name):
        p, k = procs[name]
        path = os.path.join(out, name.replace(":", "_") + ".npz")
        deadline = time.monotonic() + 600
        while not os.path.exists(path):
            if p.poll() is not None or time.monotonic() > deadline:
                with open(os.path.join(out, f"ref{k}.log")) as f:
                    raise AssertionError(f"no reference for {name} "
                                         f"(rc {p.poll()}):\n"
                                         f"{f.read()[-4000:]}")
            time.sleep(0.1)
        with np.load(path) as z:
            return dict(z)

    yield get
    for p, _ in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()
    shutil.rmtree(out, ignore_errors=True)


def _mesh(name):
    return make_named_mesh(tuple(int(v) for v in name.split("x")),
                           AXES[name], device="cpu")


def _tree(ref, prefix):
    return {n[len(prefix):].replace("|", "/"): torch.from_numpy(a)
            for n, a in ref.items() if n.startswith(prefix)}


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


def _replicas_bitwise(mesh, specs, cells):
    """Every block that no cut tells apart equal bitwise on every cell
    that holds it; returns how many copies were held."""
    coords = list(np.ndindex(mesh.devices.shape))
    checked = 0
    for n, spec in specs.items():
        used = {a for i in range(len(spec)) for a in spec.names(i)}
        groups = {}
        for coord, cell in zip(coords, cells):
            key = tuple(v for a, v in zip(mesh.axis_names, coord)
                        if a in used)
            groups.setdefault(key, []).append(cell[n])
        for blocks in groups.values():
            for b in blocks[1:]:
                assert torch.equal(b, blocks[0]), n
                checked += 1
    return checked


def _scales_seen(monkeypatch):
    """Record every per-leaf scale table the wire derives (by leaf
    name, the largest)."""
    seen: dict = {}
    real = WireLayout.scales_from_amax

    def spy(self, amax, quant):
        s = real(self, amax, quant)
        for li, n in enumerate(self.names):
            v = float(s[..., li].max())
            seen[n] = max(seen.get(n, 0.0), v)
        return s

    monkeypatch.setattr(WireLayout, "scales_from_amax", spy)
    return seen


@pytest.mark.parametrize("case", ROUNDS, ids=_round_name)
def test_round_matches_the_reference(reference, monkeypatch, case):
    """One round on the CPU cells against the reference's step on 8 host
    devices (module docstring)."""
    arch, strategy, mname, bits, fused = case
    ref = reference(_round_name(case))
    cfg = reduced(get_config(arch))
    mesh = _mesh(mname)
    pods = "pod" in mesh.axis_names
    dfed = DFedAvgMConfig(eta=1e-3, theta=0.9, local_steps=2,
                          quant=QuantConfig(bits=8) if bits == 8 else None,
                          fuse_round=bool(fused),
                          mixer_impl="ring" if pods else "dense")
    built = B.build_train_step(cfg, mesh, InputShape(*SHAPE),
                               strategy=strategy, dfed=dfed)
    assert built.mesh is mesh and built.fn.step.local_step == "cells"
    assert built.meta["mixer"] == str(ref["mixer"])
    seen = _scales_seen(monkeypatch) if bits == 8 else None
    params = _tree(ref, "in:")
    tok = torch.as_tensor(ref["tokens"])
    batches = {"tokens": tok[..., :-1].contiguous(),
               "targets": tok[..., 1:].contiguous()}
    new, met = built.fn(RoundState(params=params, rng=prng.PRNGKey(1),
                                   round=0), batches)
    assert isinstance(new.params, Cells) and len(new.params) == 8
    specs = built.specs[0][0].params
    got = mesh.gather(new.params, specs)
    want = _tree(ref, "out:")
    assert sorted(want) == sorted(got)
    for k in ("loss", "local_drift"):
        _close(met[k], ref[f"m:{k}"], k)
    _close(met["consensus_dist"], ref["m:consensus_dist"], "consensus_dist",
           rtol=RTOL if bits == 32 else Q8_CONSENSUS_RTOL)
    for n in want:
        if bits == 32:
            _close(got[n], want[n], n)
        else:
            step = seen[n]
            err = float((got[n] - want[n]).abs().max())
            assert err <= step + ATOL, (n, err, step)
    held = _replicas_bitwise(mesh, specs, new.params)
    assert held > 0


def _cells_of(mesh, specs, tree):
    return mesh.shard({n: t.clone() for n, t in tree.items()}, specs)


@pytest.mark.parametrize("case", MIXES, ids=_mix_name)
def test_8bit_mix_matches_the_reference(reference, monkeypatch, case):
    """The 8-bit ``lemma5`` mix of one round on the cells, given the
    reference's x and z: the pod ring (``make_plan_mixer`` on the pod
    mesh: B1 with the cut noise, the pods' amax, B2) or the dense mix on
    one pod (``make_cells_mixer``). Every dequantized delta bitwise the
    reference quantizer's; the output within MIX_ULP ulp of each leaf's
    largest value of the reference mixer's."""
    strategy, mname = case
    ref = reference(_mix_name(case))
    cfg = reduced(get_config("smollm-135m"))
    mesh = _mesh(mname)
    pods = "pod" in mesh.axis_names
    quant = QuantConfig(bits=8)
    built = B.build_train_step(cfg, mesh, InputShape(*SHAPE),
                               strategy=strategy)
    specs = built.specs[0][0].params
    x, z = _tree(ref, "x:"), _tree(ref, "z:")
    xs, zs = _cells_of(mesh, specs, x), _cells_of(mesh, specs, z)
    spec = MixingSpec.ring(2)
    deq = []
    if pods:
        real = WireLayout.encode

        def spy(self, delta, scales, quant, keys=None, noise=None):
            words = real(self, delta, scales, quant, keys=keys, noise=noise)
            lanes = delta.shape[0]
            one = torch.ones((lanes, 1))
            src = torch.arange(lanes, dtype=torch.int32)[None]
            deq.append(self.from_planar_stacked(self.decode_apply(
                torch.zeros_like(delta), words, scales, one, src, quant)))
            return words

        monkeypatch.setattr(WireLayout, "encode", spy)
        mixer = MX.make_plan_mixer(spec.gossip_plan(), quant, mesh=mesh,
                                   param_specs=specs)
        out = mixer(xs, zs, prng.PRNGKey(5))
    else:
        real = MX.quantize_levels
        levels = []

        def spy(d, s, quant, u=None):
            k = real(d, s, quant, u)
            levels.append(k * s)
            return k

        monkeypatch.setattr(MX, "quantize_levels", spy)
        out = MX.make_cells_mixer(spec, mesh, specs, quant)(
            xs, zs, prng.PRNGKey(5))
        names = sorted(x)
        deq = [dict(zip(names, levels[i * len(names):(i + 1) * len(names)]))
               for i in range(len(xs))]
    assert len(deq) == len(xs)
    q = mesh.gather(Cells(deq), specs)
    want_q = _tree(ref, "q:")
    got = mesh.gather(Cells(out), specs)
    want = _tree(ref, "out:")
    for n in want:
        assert torch.equal(q[n], want_q[n]), n
        eps = float(np.finfo(np.float32).eps)
        err = float((got[n] - want[n]).abs().max())
        assert err <= MIX_ULP * eps * float(want[n].abs().max()), (n, err)


@pytest.mark.parametrize("strategy,mname,bits,fused", [
    ("B2", "2x2x2", 8, 0), ("B2", "4x2", 32, 1)])
def test_recorded_collectives_equal_the_meta_count(strategy, mname, bits,
                                                   fused):
    """One round on the CPU cells records the same collectives (the
    pod ring's payloads over "pod" included) and kernel records as the
    same build evaluated on ``meta`` cells."""
    from repro_torch.launch.cost_model import structural_costs
    from repro_torch.models import model as M
    cfg = reduced(get_config("smollm-135m"))
    shape = tuple(int(v) for v in mname.split("x"))
    dfed = DFedAvgMConfig(eta=1e-3, theta=0.9, local_steps=2,
                          quant=QuantConfig(bits=8) if bits == 8 else None,
                          fuse_round=bool(fused),
                          mixer_impl="ring" if len(shape) == 3 else "dense")
    built = B.build_train_step(cfg, _mesh(mname), InputShape(*SHAPE),
                               strategy=strategy, dfed=dfed)
    meta = B.build_train_step(
        cfg, make_named_mesh(shape, AXES[mname], device="meta"),
        InputShape(*SHAPE), strategy=strategy, dfed=dfed)
    m, k, bs = (built.meta[n] for n in ("m", "K", "local_bs"))
    ps = [M.init_model(prng.PRNGKey(10 + i), cfg, device="cpu")
          for i in range(m)]
    params = {n: torch.stack([p[n] for p in ps]) for n in ps[0]}
    tok = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (m, k, bs, SHAPE[1] + 1)).astype(np.int32))
    batches = {"tokens": tok[..., :-1].contiguous(),
               "targets": tok[..., 1:].contiguous()}
    card = structural_costs(built.fn, RoundState(
        params=params, rng=prng.PRNGKey(1), round=0), batches)
    on_meta = structural_costs(meta.fn, *meta.args)
    assert card.coll_by_kind == on_meta.coll_by_kind
    assert card.coll_bytes == on_meta.coll_bytes
    assert card.kernels == on_meta.kernels
    assert ("collective-permute" in card.coll_by_kind) == (len(shape) == 3)


def test_the_fused_round_on_the_pod_mesh_is_refused():
    """The reference refuses the fused tail with model-sharded params on
    the pod mesh: so does the port, with its reason (it ran the one
    global program before)."""
    mesh = make_named_mesh((2, 2, 2), ("pod", "data", "model"),
                           device="meta")
    fused = DFedAvgMConfig(eta=1e-3, theta=0.9, local_steps=2,
                           fuse_round=True)
    for s in ("B", "B2", "B3"):
        with pytest.raises(ValueError, match="fuse_round is not supported "
                           "with model-sharded params"):
            B.build_train_step(reduced(get_config("smollm-135m")), mesh,
                               InputShape(*SHAPE), strategy=s, dfed=fused)


def test_an_mlp_cut_unalike_is_refused():
    """Gate, up and down weights whose hidden dim the specs cut unalike
    (one over ("data", "model"), one over "model"): a strided partition
    of the hidden dim is exact only when all three share it."""
    axes = {"stages/0/mlp/wg": ("layers", "embed", "mlp"),
            "stages/0/mlp/wd": ("layers", "mlp", "embed")}
    specs = {"stages/0/mlp/wg": P(None, None, None, ("data", "model")),
             "stages/0/mlp/wd": P(None, None, "model", None)}
    with pytest.raises(ValueError, match="unalike"):
        B._check_cells_layout(specs, axes)


def test_pod_views_of_a_laid_out_tree():
    """``ServeMesh.pod`` is pod p's (data, model) mesh; ``pod_cells``
    its cells, which hold its clients' blocks as that mesh lays them
    out by ``pod_specs``; ``join_pods`` the inverse."""
    from repro_torch.sharding.rules import pod_specs
    mesh = make_named_mesh((2, 2, 2), ("pod", "data", "model"),
                           device="cpu")
    x = torch.arange(2 * 4 * 6, dtype=torch.float32).reshape(2, 4, 6)
    specs = {"x": P("pod", "data", "model")}
    cells = mesh.shard({"x": x}, specs)
    assert pod_specs(specs) == {"x": P(None, "data", "model")}
    for p in range(2):
        sub = mesh.pod(p)
        assert sub.axis_names == ("data", "model")
        assert sub.devices.shape == (2, 2)
        mine = mesh.pod_cells(cells, p)
        want = sub.shard({"x": x[p:p + 1]}, pod_specs(specs))
        assert all(torch.equal(a["x"], b["x"]) for a, b in zip(mine, want))
    joined = mesh.join_pods([mesh.pod_cells(cells, p) for p in range(2)])
    assert all(torch.equal(a["x"], b["x"]) for a, b in zip(joined, cells))
    assert torch.equal(mesh.gather(joined, specs)["x"], x)
