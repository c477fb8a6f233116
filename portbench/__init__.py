"""The benchmark of the PyTorch + CUDA port (``repro_torch``) on an NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON result line.
Nothing here imports JAX or the JAX package ``repro``.
"""
