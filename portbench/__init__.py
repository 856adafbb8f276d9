"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one cell a
run, driven by ``BENCHMARK.json`` at the checkout's root
(``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``; ``README.md`` lays the folder out)."""
