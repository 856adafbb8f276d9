"""The paper's benches on the port — the counterparts of the JAX
package's ``benchmarks/bench_fig6_compare.py`` (Fig. 6),
``benchmarks/bench_quant_epochs.py`` (Figs 2-5), ``bench_cnn.py``
(Fig. 8), ``bench_charlm.py`` (Fig. 7), ``bench_topology.py`` (ring
against torus) and ``bench_timevarying.py`` (its in-process schedule
rows: time-varying gossip), with their shared helpers
(``common``) and runner (``run``). On the card every round runs as one
captured CUDA graph (``repro_torch.core.compiled``).

    python -m repro_torch.bench.run [--only fig6] [--smoke] [--device cpu]
"""
