"""Fig. 7: the char-LM (the paper's Shakespeare LSTM) under DFedAvgM with a
non-IID Markov stream per client — the reference's
``benchmarks/bench_charlm.py`` on the port: fp32 gossip (bits 32) against
an 8-bit wire on the dense mixer (the per-leaf noise drawn by T2 on the
card). The batches are numpy draws, exactly the reference's."""
from __future__ import annotations

import numpy as np
import torch

from .. import prng
from ..core import (DFedAvgMConfig, MixingSpec, QuantConfig,
                    init_round_state, make_round_step)
from ..data import char_stream
from ..device import resolve_device
from ..models.paper_nets import init_charlstm
from .common import loss_charlm, run_rounds, stacked

M, K, B, SEQ, ROUNDS, VOCAB = 8, 2, 8, 40, 25, 60
SMOKE_M, SMOKE_ROUNDS = 4, 2


def lm_batches(streams, rnd: int, *, K: int = K, batch: int = B,
               seq: int = SEQ) -> dict[str, torch.Tensor]:
    """Round ``rnd``'s windows [m, K, batch, seq + 1] of each client's
    stream, drawn as the reference draws them (CPU tensor)."""
    out = np.zeros((len(streams), K, batch, seq + 1), np.int32)
    rng = np.random.default_rng(rnd)
    for i, s in enumerate(streams):
        starts = rng.integers(0, len(s) - seq - 1, size=(K, batch))
        for k in range(K):
            for b in range(batch):
                out[i, k, b] = s[starts[k, b]:starts[k, b] + seq + 1]
    return {"t": torch.from_numpy(out)}


def arms(*, smoke: bool = False, device=None, capture: bool = True):
    """(name, result) for bits 32 and 8; a result holds ``loss``,
    ``first_loss``, ``consensus_dist``, ``us_per_round``, ``capture_s``,
    ``graph`` and the CSV ``derived`` string."""
    dev = resolve_device(device)
    m, rounds = (SMOKE_M, SMOKE_ROUNDS) if smoke else (M, ROUNDS)
    streams = [char_stream(4000, vocab=VOCAB, bias_seed=i, seed=i)
               for i in range(m)]
    for bits in (32, 8):
        q = QuantConfig(bits=bits) if bits < 32 else None
        step = make_round_step(loss_charlm, DFedAvgMConfig(
            eta=1.0, theta=0.9, local_steps=K, quant=q, mixer_impl="dense"),
            MixingSpec.ring(m, self_weight=0.5), device=dev)
        st = init_round_state(
            stacked(init_charlstm(0, vocab=VOCAB, device=dev), m),
            prng.PRNGKey(1))
        r = run_rounds(step, st, lambda t: lm_batches(streams, t), rounds,
                       capture=capture)
        loss = float(r["metrics"]["loss"])
        yield f"fig7/charlm/bits{bits}", dict(
            r, loss=loss,
            consensus_dist=float(r["metrics"]["consensus_dist"]),
            derived=f"loss={loss:.3f}")


def run(*, smoke: bool = False, device=None):
    """The runner's entry: Fig. 7's CharLSTM arms as CSV rows (name, us a
    round, derived); ``smoke`` runs them small."""
    return [(name, r["us_per_round"], r["derived"])
            for name, r in arms(smoke=smoke, device=device)]
