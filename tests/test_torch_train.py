"""The port's LM driver (``repro_torch.launch.train``) against the JAX
package's (``repro.launch.train``) on the same argv: two rounds of the
reduced SmolLM-135M, 4 clients, 2 local steps, batch 2, 16 tokens, at
32 and 8 bits.

* The port's ``--mixer-impl dense`` against the reference's default,
  which falls back to the dense mixer on one device.
* The port's default (the plan realization on one card) against the
  reference's ``--mixer-impl sparse --clients-per-shard 4`` (the sparse
  executor on a one-shard client mesh).

The final loss and consensus distance within rtol 1e-5, and the JSONL
run logs record for record: the same kinds in the same order, every
round and end record's fields equal (floats within rtol 1e-5; ``wall_s``
and ``time`` are the clock's). Then one bf16 round against the JAX round
built with the Pallas update in interpret mode (its bf16 semantics), the
pooled, async and telemetry paths one round each, and the refusals of
the 2D mesh and of ``--placement partition`` without a client mesh, and
the reference's second wire codec (``--wire seq``) held to ``--wire
auto``.
"""
import dataclasses
import json
import math
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as rcfg  # noqa: E402
from repro import core as rcore  # noqa: E402
from repro.data.synthetic import lm_round_batches as r_batches  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.launch import train as RT  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.data.synthetic import lm_round_batches as t_batches  # noqa: E402,E501
from repro_torch.launch import train as TT  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.telemetry import validate_record  # noqa: E402

torch.set_num_threads(2)

BASE = ["--clients", "4", "--local-steps", "2", "--batch", "2", "--seq",
        "16", "--rounds", "2"]
RTOL = 1e-5
CLOCK_FIELDS = ("wall_s", "time")
# One bf16 round against the reference's, element by element. The two
# packages' bf16 products round apart, so their gradients differ in the
# low bits and an element's update can round to the other bf16 neighbour:
# at least 90 % of all elements stored bitwise equal (measured: 95.2 %),
# and each leaf's change y' - y0 in f32 within 0.25 of the reference's
# change in relative L2 norm (measured: 0.124 at worst). An update left
# out keeps ~45 % of the elements and misses the change by 1.0; a flipped
# sign misses it by 2.0. The mean loss of the K steps within 1e-3
# relative (measured: 1.8e-5). Every element also stays within 2 bf16 ulp
# of its leaf's largest magnitude.
BF16_LEAF_ULP = 2 * 2.0 ** -7
BF16_EQUAL_FRAC = 0.9
BF16_DELTA_RTOL = 0.25
BF16_LOSS_RTOL = 1e-3


def records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def same(a, b, what):
    if isinstance(a, float) or isinstance(b, float):
        assert math.isclose(a, b, rel_tol=RTOL, abs_tol=1e-12), (what, a, b)
    elif isinstance(a, list):
        assert len(a) == len(b), what
        for x, y in zip(a, b):
            same(x, y, what)
    else:
        assert a == b, (what, a, b)


@pytest.mark.parametrize("bits", ["32", "8"])
@pytest.mark.parametrize("impl", ["dense", "plan"])
def test_two_rounds_match_the_reference(tmp_path, bits, impl):
    ref_argv = BASE + ["--bits", bits, "--log-jsonl",
                       str(tmp_path / "ref.jsonl")]
    port_argv = BASE + ["--bits", bits, "--device", "cpu", "--log-jsonl",
                        str(tmp_path / "port.jsonl")]
    if impl == "dense":
        port_argv += ["--mixer-impl", "dense"]
    else:
        ref_argv += ["--mixer-impl", "sparse", "--clients-per-shard", "4"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, m_ref = RT.main(ref_argv)
    _, m_port = TT.main(port_argv)
    for k in ("loss", "consensus_dist"):
        same(float(m_port[k]), float(m_ref[k]), k)
    ref, port = records(tmp_path / "ref.jsonl"), records(tmp_path /
                                                         "port.jsonl")
    assert [r["kind"] for r in ref if r["kind"] != "info"] == \
        [r["kind"] for r in port if r["kind"] != "info"]
    for r, p in zip((r for r in ref if r["kind"] in ("round", "run_end")),
                    (p for p in port if p["kind"] in ("round", "run_end"))):
        validate_record(p)
        assert set(r) == set(p), (set(r) ^ set(p))
        for k in r:
            if k not in CLOCK_FIELDS:
                same(p[k], r[k], k)
    cfg_ref = next(r for r in ref if r["kind"] == "run_start")["config"]
    cfg_port = next(r for r in port if r["kind"] == "run_start")["config"]
    for k in set(cfg_ref) & set(cfg_port) - {"log_jsonl",
                                              "clients_per_shard",
                                              "mixer_impl"}:
        assert cfg_ref[k] == cfg_port[k], k


def test_one_bf16_round_against_the_pallas_update():
    """The reduced SmolLM in bf16, one round on the dense ring: the port
    (B3's plain version: f32 arithmetic, bf16 stores) against the JAX
    round whose update is ``momentum_sgd_pallas`` in interpret mode,
    element by element and by each leaf's change (``bf16_round_agrees``)."""
    rc = dataclasses.replace(rcfg.reduced(rcfg.get_config("smollm-135m")),
                             dtype="bfloat16")
    tc = dataclasses.replace(tcfg.reduced(tcfg.get_config("smollm-135m")),
                             dtype="bfloat16")
    m, K = 4, 2
    jp = RM.init_model(jax.random.PRNGKey(0), rc)[0]
    stacked = jax.tree.map(lambda t: jnp.broadcast_to(t[None], (m,) +
                                                      t.shape), jp)
    dcfg = dict(eta=3e-2, theta=0.9, local_steps=K, mixer_impl="dense")
    ring_r = rcore.MixingSpec.ring(m, self_weight=0.5)
    step_r = jax.jit(rcore.make_round_step(
        lambda p, b, r: RM.loss_fn(p, rc, b, r),
        rcore.DFedAvgMConfig(**dcfg), ring_r,
        fused_update=rops.make_fused_momentum_update(interpret=True)))
    b_r = r_batches(jax.random.PRNGKey(7), 0, m=m, K=K, batch=2, seq=16,
                    vocab=rc.vocab_size)
    s_r, met_r = step_r(rcore.init_round_state(stacked,
                                               jax.random.PRNGKey(1)), b_r)

    params = convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                       stack=m, device="cpu")
    assert all(t.dtype == torch.bfloat16 for t in params.values())
    step_t = tcore.make_round_step(lambda p, b, r: TM.loss_fn(p, tc, b, r),
                                   tcore.DFedAvgMConfig(**dcfg),
                                   tcore.MixingSpec.ring(m, self_weight=0.5),
                                   device="cpu")
    b_t = t_batches(prng.PRNGKey(7), 0, m=m, K=K, batch=2, seq=16,
                    vocab=tc.vocab_size)
    assert torch.equal(b_t["tokens"], torch.from_numpy(
        np.asarray(b_r["tokens"])))
    s_t, met_t = step_t(tcore.init_round_state(params, prng.PRNGKey(1)), b_t)
    assert math.isclose(float(met_t["loss"]), float(met_r["loss"]),
                        rel_tol=BF16_LOSS_RTOL)
    want = {n: np.asarray(t, np.float32) for n, t in
            zip(convert.flat_names(s_r.params), jax.tree.leaves(s_r.params))}
    y0 = {n: t.to(torch.float32).numpy() for n, t in params.items()}
    for t in s_t.params.values():
        assert t.dtype == torch.bfloat16
    got = {n: t.to(torch.float32).numpy() for n, t in s_t.params.items()}
    assert bf16_round_agrees(got, want, y0)
    # Controls: the same check refuses a round that left y unchanged and
    # one whose update has the other sign.
    assert not bf16_round_agrees(y0, want, y0)
    flipped = {n: torch.from_numpy(2 * y0[n] - got[n]).to(torch.bfloat16)
               .to(torch.float32).numpy() for n in got}
    assert not bf16_round_agrees(flipped, want, y0)


def bf16_round_agrees(got: dict, want: dict, y0: dict) -> bool:
    """Whether a bf16 round's parameters ``got`` agree with the
    reference's ``want`` (both from ``y0``, all as f32 arrays): the
    share of bitwise-equal elements, every element's error and each
    leaf's change."""
    equal = sum(int((got[n] == want[n]).sum()) for n in want)
    if equal < BF16_EQUAL_FRAC * sum(w.size for w in want.values()):
        return False
    for n, w in want.items():
        if np.abs(got[n] - w).max() > BF16_LEAF_ULP * np.abs(w).max():
            return False
        d_want = w.astype(np.float64) - y0[n]
        d_got = got[n].astype(np.float64) - y0[n]
        miss = np.linalg.norm(d_got - d_want)
        if miss > BF16_DELTA_RTOL * np.linalg.norm(d_want):
            return False
    return True


@pytest.mark.parametrize("mode", [["--pool", "--resident-lanes", "2"],
                                  ["--async-gossip", "--speed-model",
                                   "straggler"],
                                  ["--telemetry", "--bits", "8"]],
                         ids=["pool", "async", "telemetry"])
def test_other_modes_run_one_round(tmp_path, mode):
    """One round of each of the driver's other modes on the CPU: the log
    validates against the schema and the loss is finite."""
    path = tmp_path / "run.jsonl"
    argv = ["--clients", "4", "--local-steps", "2", "--batch", "2",
            "--seq", "16", "--rounds", "1", "--device", "cpu",
            "--log-jsonl", str(path)] + mode
    _, metrics = TT.main(argv)
    recs = records(path)
    for r in recs:
        validate_record(r)
    rounds = [r for r in recs if r["kind"] == "round"]
    assert len(rounds) == 1 and math.isfinite(rounds[0]["loss"])
    if "--telemetry" in mode:
        assert "quant_rel_err" in rounds[0] or "wire_bits" in rounds[0]


@pytest.mark.parametrize("argv, match", [
    (["--model-parallel", "2"], "needs >= 2 devices"),
    (["--placement", "partition"], "sparse backend"),
    (["--wire", "seq"], None)],
    ids=["model-parallel", "partition", "wire-seq"])
def test_unported_layouts_and_codec_raise(argv, match):
    """``--placement partition`` without a client mesh exits as the
    reference's does, and so does ``--model-parallel 2`` on a host
    without the 1 x 2 cards of its 2D mesh (the multi-shard layouts run
    on test meshes: ``tests/test_torch_mesh.py`` and
    ``tests/test_torch_mesh2d.py``). The reference's second wire codec
    (``--wire seq``) runs the port's one codec: its 8-bit run's losses
    and consensus equal ``--wire auto``'s."""
    if match is None:
        runs = [TT.main(BASE + ["--device", "cpu", "--bits", "8"] + a)[1]
                for a in (argv, ["--wire", "auto"])]
        for k in ("loss", "consensus_dist"):
            assert float(runs[0][k]) == float(runs[1][k]), k
        return
    with pytest.raises(SystemExit, match=match):
        TT.main(BASE + ["--device", "cpu"] + argv)
