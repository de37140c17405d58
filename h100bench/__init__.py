"""The benchmark of the PyTorch and CUDA port, one cell per run.

``python -m h100bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` on the CUDA card and prints one JSON
line. Every configuration, cell and per-layer metric sits in a file of its
own (``configs/``, ``cells/``, ``metrics/``), found by the name that
``BENCHMARK.json`` gives it. The traffic generators, the roofline
arithmetic and the plain references that decide ``correct`` live here and
import nothing of the port.
"""
