"""Port parity for the time-varying FUSED round: three rounds of the
port's fused round (B4/B5 tail, plain versions on the CPU) on every
non-stateful ``TopologySchedule`` kind against the JAX package's fused
round on a one-device client mesh (sparse, planar wire, Pallas in
interpret mode), from the same parameters, batches and key
(``schedule_rounds``). Inactive clients gate to y = x, v = g = 0 inside
the tail; a cycle takes the dense tail in both packages.

Contracts: loss, consensus, local drift and ``active_frac`` within rtol
1e-5; keys bitwise; parameters as ``test_torch_round``.
"""
import pytest

from schedule_rounds import (M, T, assert_rounds_track, prng, run_both,
                             schedule, t_loss, torch)

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.mark.parametrize("kind", ["edge_sample", "partial", "partial_exact",
                                  "partial_cap", "walk", "cycle"])
def test_three_fused_rounds_track_jax(kind):
    jst, tst, jm, tm = run_both(kind, fuse_round=True)
    assert_rounds_track(jst, tst, jm, tm)


def test_fused_gated_tail_holds_inactive_clients_at_eta_zero():
    """At eta = 0 the deferred updates vanish: an inactive client's
    parameters come out of a fused partial round unchanged (Q(0), zero
    update, W_t row e_i)."""
    from repro_torch.data import FederatedDataset, classification_dataset
    from repro_torch.models import paper_nets as tnets
    s = schedule(T, "partial")
    tfed = FederatedDataset.make(classification_dataset(n=200, d=32,
                                                        seed=0), M)
    p0 = {n: t.expand((M,) + t.shape).contiguous() for n, t in
          tnets.init_2nn(0, d_in=32, d_hidden=16, device="cpu").items()}
    step = T.make_round_step(t_loss, T.DFedAvgMConfig(
        eta=0.0, theta=0.9, local_steps=2, quant=T.QuantConfig(bits=8),
        fuse_round=True), s, device="cpu")
    st = T.init_round_state(p0, prng.PRNGKey(3))
    _, key_mix, _ = prng.split(st.rng, 3)
    _, active, _ = s.round_event(key_mix, 0)
    st1, met = step(st, tfed.round_batches(0, K=2, batch=8, device="cpu"))
    assert float(met["active_frac"]) == float(active.mean())
    for c in torch.nonzero(active == 0).flatten().tolist():
        for n in p0:
            assert torch.equal(st1.params[n][c], p0[n][c]), (n, c)
