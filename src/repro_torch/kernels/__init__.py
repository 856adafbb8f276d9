"""Hand-written CUDA kernels for the port's hot spots, each beside its plain
PyTorch version (``ref.py``):

quantize_pack — B1, whole-buffer quantize + planar pack (wire encoder);
                B4, the same fused with the penultimate heavy-ball step;
                B6, one buffer with one scale (B1's encode, keyed or
                with tensor noise, in a kernel sized for one client)
dequant_mix   — B2, whole-buffer fused unpack + dequantize + gossip apply,
                gathering neighbours' streams through the plan's src table;
                B5, the same fused with the deferred last heavy-ball step;
                B7, one buffer over a [k, W] stream stack; B8, the ring
                form over three stream pointers
momentum_sgd  — B3, fused heavy-ball update, with eta a float or a
                device [m], one a client (the lane entry)
threefry      — T1, T2, T3 and T4, the key chain's ``jax.random.split``
                (and ``fold_in``), ``jax.random.uniform``,
                ``jax.random.bits`` and ``jax.random.normal``
                (``prng.split`` / ``fold_in`` / ``uniform`` /
                ``random_bits`` / ``normal`` on a CUDA key), which the
                JAX package leaves to XLA

``ops`` holds the per-tensor entry points (``encode_delta``,
``decode_apply_ring``, ``decode_apply_plan``, ``momentum_update_flat``,
``make_fused_momentum_update``). A wrapper runs its plain version on CPU
tensors and its kernel on CUDA tensors (or raises); ``native`` builds the
sources in ``csrc/`` with ``nvcc`` on first use and counts every launch.
"""
from .dequant_mix import (dequant_mix, dequant_mix_buffer,  # noqa: F401
                          dequant_mix_momentum_buffer, dequant_mix_plan)
from .momentum_sgd import momentum_sgd  # noqa: F401
from .ops import (decode_apply_plan, decode_apply_ring,  # noqa: F401
                  encode_delta, launch_counts, make_fused_momentum_update,
                  momentum_update, momentum_update_flat, reset_launch_counts)
from .quantize_pack import (momentum_quantize_pack_buffer,  # noqa: F401
                            quantize_pack, quantize_pack_buffer)
