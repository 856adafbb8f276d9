"""Port parity for the time-varying round (unfused): three rounds of the
port's DFedAvgM round on every ``TopologySchedule`` kind against the JAX
package's round on a one-device client mesh (the plan realization, 8-bit
stochastic ``lemma5`` wire, Pallas in interpret mode), from the same
parameters, batches and key (``schedule_rounds``); compute-skip against
full width; and ``constant(spec)`` against the static mixer. The
schedule mixers are held in ``test_torch_topology.py``.

Contracts: loss, consensus, local drift and ``active_frac`` within rtol
1e-5; keys and walk tokens bitwise; parameters as ``test_torch_round``.
"""
import pytest

from schedule_rounds import (M, T, assert_rounds_track, prng, run_both,
                             schedule, t_loss, torch)
from repro_torch.data import FederatedDataset, classification_dataset
from repro_torch.models import paper_nets as tnets

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False



def start():
    """The port's data and stacked parameters of the tests below."""
    tfed = FederatedDataset.make(classification_dataset(n=400, d=32,
                                                        seed=0), M)
    p0 = {n: t.expand((M,) + t.shape).contiguous() for n, t in
          tnets.init_2nn(0, d_in=32, d_hidden=16, device="cpu").items()}
    return tfed, p0


@pytest.mark.parametrize("kind", ["edge_sample", "partial", "partial_exact",
                                  "partial_cap", "walk", "walk_stateful",
                                  "cycle"])
def test_three_unfused_rounds_track_jax(kind):
    jst, tst, jm, tm = run_both(kind, fuse_round=False)
    assert_rounds_track(jst, tst, jm, tm)


@pytest.mark.parametrize("kind", ["partial_exact", "partial_cap", "walk",
                                  "walk_stateful"])
def test_compute_skip_equals_full_width(kind):
    """Training only the active lanes gives the full-width round's
    parameters and loss (the reference's promise); the default is
    ``"auto"``, which skips here."""
    s = schedule(T, kind)
    assert s.static_active_count < M
    tfed, p0 = start()
    cfg = T.DFedAvgMConfig(eta=0.05, theta=0.9, local_steps=2,
                           quant=T.QuantConfig(bits=8))
    out = []
    for skip in ("auto", False):
        step = T.make_round_step(t_loss, cfg, s, device="cpu",
                                 skip_inactive_compute=skip)
        st = T.init_round_state(p0, prng.PRNGKey(1),
                                token=s.init_token() if s.is_stateful
                                else None)
        for t in range(3):
            st, met = step(st, tfed.round_batches(t, K=2, batch=8,
                                                  device="cpu"))
        out.append((st, met))
    (a, ma), (b, mb) = out
    for n in a.params:
        assert torch.equal(a.params[n], b.params[n]), n
    assert torch.equal(ma["loss"], mb["loss"])
    assert torch.equal(ma["active_frac"], mb["active_frac"])


def test_constant_schedule_equals_static_dense_mixer_bitwise():
    """constant(spec) on the dense backend is the static dense round,
    bit for bit (the reference's promise)."""
    tfed, p0 = start()
    spec = T.MixingSpec.ring(M, 0.5)
    states = []
    for sp in (spec, T.TopologySchedule.constant(spec)):
        cfg = T.DFedAvgMConfig(eta=0.05, local_steps=2, mixer_impl="dense",
                               quant=T.QuantConfig(bits=8))
        step = T.make_round_step(t_loss, cfg, sp, device="cpu")
        st = T.init_round_state(p0, prng.PRNGKey(1))
        for t in range(2):
            st, met = step(st, tfed.round_batches(t, K=2, batch=8,
                                                  device="cpu"))
        states.append((st, met))
    (a, ma), (b, mb) = states
    for n in a.params:
        assert torch.equal(a.params[n], b.params[n]), n
    assert torch.equal(ma["loss"], mb["loss"])
