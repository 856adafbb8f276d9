"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's ``repro.checkpoint`` on the CPU: a ``RoundState`` and a
``ClientPool`` written by either package restore in the other; rotation
by ``keep``; a shape mismatch refused; a bf16 leaf round trip; and a
resume that continues bit for bit.

Contracts: bitwise everywhere (keys, round counters, parameters, slabs,
versions); the keypaths of the manifest equal the reference's letter for
letter; keys are uint32 on disk.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as JC  # noqa: E402
from repro import core as J  # noqa: E402
from repro_torch import checkpoint as TC  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch import core as T  # noqa: E402

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False

D = 5


def j_state(seed=0):
    return J.init_round_state(
        {"w": jax.random.normal(jax.random.PRNGKey(seed), (4, 7)),
         "nest": {"b": jnp.arange(5, dtype=jnp.bfloat16) + seed}},
        jax.random.PRNGKey(seed + 1))


def t_state(seed=0):
    rng = np.random.default_rng(seed)
    return T.init_round_state(
        {"w": torch.from_numpy(rng.normal(size=(4, 7)).astype(np.float32)),
         "nest/b": torch.arange(5, dtype=torch.bfloat16) + seed},
        prng.PRNGKey(seed + 1))


def manifest(d, step):
    return json.loads((d / f"step_{step:08d}" / "manifest.json")
                      .read_text())["leaves"]


def test_round_state_from_the_reference_restores_in_the_port(tmp_path):
    st = j_state()
    JC.save_checkpoint(tmp_path, 3, st)
    restored, step = TC.restore_checkpoint(tmp_path, t_state(9))
    assert step == 3 and isinstance(restored, T.RoundState)
    assert restored.rng.dtype == torch.int64
    assert restored.rng.tolist() == np.asarray(st.rng).tolist()
    assert restored.round == 0 and restored.token is None
    assert torch.equal(restored.params["w"],
                       torch.from_numpy(np.asarray(st.params["w"])))
    assert restored.params["nest/b"].dtype == torch.bfloat16
    assert restored.params["nest/b"].tolist() == [0.0, 1.0, 2.0, 3.0, 4.0]


def test_round_state_from_the_port_restores_in_the_reference(tmp_path):
    st = t_state(2)
    TC.save_checkpoint(tmp_path, 5, st._replace(round=4))
    JC.save_checkpoint(tmp_path / "ref", 5, j_state())
    assert manifest(tmp_path, 5) == manifest(tmp_path / "ref", 5)
    restored, step = JC.restore_checkpoint(tmp_path, j_state(7))
    assert step == 5 and int(restored.round) == 4
    assert restored.rng.dtype == jnp.uint32
    assert np.asarray(restored.rng).tolist() == st.rng.tolist()
    np.testing.assert_array_equal(np.asarray(restored.params["w"]),
                                  st.params["w"].numpy())
    assert restored.params["nest"]["b"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(restored.params["nest"]["b"], np.float32),
        st.params["nest/b"].float().numpy())


def test_rotation_keeps_latest(tmp_path):
    st = t_state()
    for s in (1, 2, 3, 4, 5):
        TC.save_checkpoint(tmp_path, s, st, keep=2)
    assert TC.list_checkpoints(tmp_path) == [4, 5]
    assert TC.latest_step(tmp_path) == 5
    assert not list(tmp_path.glob(".tmp_*"))


def test_shape_mismatch_rejected(tmp_path):
    TC.save_checkpoint(tmp_path, 1, {"w": torch.zeros(3, 3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        TC.restore_checkpoint(tmp_path, {"w": torch.zeros(4, 3)})
    with pytest.raises(KeyError, match="missing"):
        TC.restore_checkpoint(tmp_path, {"v": torch.zeros(3, 3)})


def test_bf16_leaf_round_trip(tmp_path):
    a = (torch.randn(6, 3, generator=torch.Generator().manual_seed(0))
         .to(torch.bfloat16))
    TC.save_checkpoint(tmp_path, 1, {"a": a, "n": 3})
    assert manifest(tmp_path, 1)["a"]["dtype"] == "float32"
    like = {"a": torch.zeros(6, 3, dtype=torch.bfloat16), "n": 0}
    back, _ = TC.restore_checkpoint(tmp_path, like)
    assert back["a"].dtype == torch.bfloat16 and torch.equal(back["a"], a)
    assert back["n"] == 3


def loss_fn(p, b, r):
    return 0.5 * ((p["w"] - b["c"]) ** 2).sum(-1)


def test_resume_is_deterministic(tmp_path):
    """Save at round 3, restore, continue == the uninterrupted run."""
    m, d = 4, 6
    cs = torch.from_numpy(np.random.default_rng(1).normal(
        size=(m, d)).astype(np.float32))
    batches = {"c": cs[:, None].expand(m, 2, d).contiguous()}
    step = T.make_round_step(loss_fn, T.DFedAvgMConfig(
        eta=0.05, theta=0.5, local_steps=2), T.MixingSpec.ring(m),
        device="cpu")
    st = T.init_round_state({"w": torch.zeros(m, d)}, prng.PRNGKey(0))
    for t in range(6):
        if t == 3:
            TC.save_checkpoint(tmp_path, t, st)
        st, _ = step(st, batches)
    like = T.init_round_state({"w": torch.zeros(m, d)}, prng.PRNGKey(0))
    st2, _ = TC.restore_checkpoint(tmp_path, like)
    assert st2.round == 3
    for _ in range(3):
        st2, _ = step(st2, batches)
    assert torch.equal(st.params["w"], st2.params["w"])
    assert torch.equal(st.rng, st2.rng)


def filled_pools(m=40):
    """A port pool and a reference pool with the same rows written in the
    same order (two leaves, one bf16)."""
    rng = np.random.default_rng(3)
    tp = T.ClientPool({"a": torch.zeros(D), "b": torch.zeros(
        2, dtype=torch.bfloat16)}, m)
    jp = J.ClientPool({"a": jnp.zeros(D), "b": jnp.zeros(2, jnp.bfloat16)},
                      m)
    for ids in ([3, 17, 30], [17, 5], [39, 0, 3, 8]):
        a = rng.normal(size=(len(ids), D)).astype(np.float32)
        b = rng.normal(size=(len(ids), 2)).astype(np.float32)
        tp.writeback(ids, {"a": a, "b": torch.from_numpy(b).to(
            torch.bfloat16)})
        jp.writeback(ids, {"a": jnp.asarray(a),
                           "b": jnp.asarray(b, jnp.bfloat16)})
    return tp, jp


def same_pool(tp, jp, m):
    np.testing.assert_array_equal(tp.versions, jp.versions)
    assert tp.materialized == jp.materialized
    got, want = tp.fetch(np.arange(m)), jp.fetch(np.arange(m))
    np.testing.assert_array_equal(got["a"].numpy(), want["a"])
    np.testing.assert_array_equal(got["b"].float().numpy(),
                                  np.asarray(want["b"], np.float32))


def test_client_pool_from_the_reference_restores_in_the_port(tmp_path):
    tp, jp = filled_pools()
    jp.save(tmp_path, 6, extra={"rng": jax.random.PRNGKey(4),
                                "round": np.asarray(6, np.int64)})
    pool, extra, step = T.ClientPool.restore(
        tmp_path, {"a": torch.zeros(D),
                   "b": torch.zeros(2, dtype=torch.bfloat16)})
    assert step == 6 and int(extra["round"]) == 6
    assert extra["rng"].dtype == np.uint32
    assert extra["rng"].tolist() == np.asarray(
        jax.random.PRNGKey(4)).tolist()
    same_pool(pool, jp, 40)
    pool.writeback([1], {"a": np.ones((1, D), np.float32),
                         "b": torch.ones(1, 2, dtype=torch.bfloat16)})
    assert pool.versions[1] == 1 and pool.materialized == 8


def test_client_pool_from_the_port_restores_in_the_reference(tmp_path):
    tp, jp = filled_pools()
    tp.save(tmp_path, 6, extra={"rng": prng.PRNGKey(4),
                                "round": np.asarray(6, np.int64)})
    jp.save(tmp_path / "ref", 6, extra={"rng": jax.random.PRNGKey(4),
                                        "round": np.asarray(6, np.int64)})
    assert manifest(tmp_path, 6) == manifest(tmp_path / "ref", 6)
    pool, extra, _ = J.ClientPool.restore(
        tmp_path, {"a": jnp.zeros(D), "b": jnp.zeros(2, jnp.bfloat16)})
    assert extra["rng"].dtype == np.uint32
    assert jnp.asarray(extra["rng"]).tolist() == [0, 4]
    same_pool(tp, pool, 40)
