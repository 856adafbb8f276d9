"""PyTorch + CUDA port of the DFedAvgM system (JAX package: ``repro``).

Layout mirrors ``repro``: ``core/`` (quantizer, wire layout, gossip plan,
mixers, local SGD, round step), ``kernels/`` (hand-written CUDA kernels in
``csrc/`` beside their plain PyTorch versions), ``models/``, ``data/``,
plus ``prng`` (threefry, bit-compatible with ``jax.random``) and
``convert`` (parameters to and from numpy). Entry points run on CUDA
unless the caller passes ``device="cpu"``.
"""
