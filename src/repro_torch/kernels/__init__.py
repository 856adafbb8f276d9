"""Hand-written CUDA kernels for the port's hot spots, each beside its plain
PyTorch version (``ref.py``):

quantize_pack — B1, whole-buffer quantize + planar pack (wire encoder)
dequant_mix   — B2, whole-buffer fused unpack + dequantize + gossip apply,
                gathering neighbours' streams through the plan's src table
momentum_sgd  — B3, fused heavy-ball update

A wrapper runs its plain version on CPU tensors and its kernel on CUDA
tensors (or raises); ``native`` builds the sources in ``csrc/`` with
``nvcc`` on first use and counts every launch.
"""
from .dequant_mix import dequant_mix_buffer  # noqa: F401
from .momentum_sgd import momentum_sgd  # noqa: F401
from .ops import launch_counts, momentum_update, reset_launch_counts  # noqa
from .quantize_pack import quantize_pack_buffer  # noqa: F401
