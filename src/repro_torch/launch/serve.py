"""Batched serving driver, the port of the JAX package's
``launch/serve.py``: prefill a batch of prompts into KV caches (SSM
states for the Mamba2 blocks), then greedy-decode one token a step. The
consensus (client-averaged) model is what gets served — in decentralized
FL every client ends up with (approximately) this model.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
      --batch 4 --prompt-len 32 --gen 16 [--device cpu]

As in the reference, ``main`` serves the reduced config; a full-width
model goes through :func:`greedy_generate` with its unreduced config.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from .. import prng
from ..configs import get_config, reduced as make_reduced
from ..device import resolve_device
from ..models import model as M
from ..models.frontends import stub_frontend_embeddings


@torch.no_grad()
def greedy_generate(params, cfg, prompts: torch.Tensor, *, gen: int,
                    s_alloc: int, cross_states=None) -> torch.Tensor:
    """prompts: [b, Lp] on the parameters' device -> generated tokens
    [b, gen] (int64): the prefill's argmax, then ``gen - 1`` cached
    one-token decode steps, each position a device tensor."""
    b, lp = prompts.shape
    dev = prompts.device
    caches = M.init_decode_caches(cfg, b, s_alloc, device=dev)
    logits, caches = M.prefill(params, cfg, prompts, caches,
                               cross_states=cross_states)
    tok = torch.argmax(logits, dim=-1)
    out = [tok]
    pos = torch.tensor(lp, dtype=torch.int32, device=dev)
    for _ in range(gen - 1):
        logits, caches = M.decode_step(params, cfg, tok, pos, caches,
                                       cross_states=cross_states)
        tok = torch.argmax(logits, dim=-1)
        out.append(tok)
        pos = pos + 1
    return torch.stack(out, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = dataclasses.replace(make_reduced(get_config(args.arch)),
                              remat=False)
    params = M.init_model(prng.PRNGKey(args.seed), cfg, device=dev)
    prompts = prng.randint(prng.PRNGKey(1, device=dev),
                           (args.batch, args.prompt_len), 0, cfg.vocab_size)
    cross = None
    if cfg.frontend is not None:
        fe = stub_frontend_embeddings(cfg, args.batch, device=dev)
        cross = M.cross_states(params, cfg, fe)

    t0 = time.time()
    toks = greedy_generate(params, cfg, prompts, gen=args.gen,
                           s_alloc=args.prompt_len + args.gen,
                           cross_states=cross)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen}: {tuple(toks.shape)} in {dt:.2f}s "
          f"({args.batch*args.gen/dt:.1f} tok/s)")
    print("sample:", toks[0, :12].tolist())
    return toks


if __name__ == "__main__":
    main()
