"""The benchmark of the PyTorch/CUDA port (``dwpa_tpu_torch``) on an H100.

``python3 -m port_bench --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json``: dwpa volunteer work units
through the port's client (``TpuCrackClient.run()``) against an
in-process server, judged by a plain reference.  See ``run.py``.
"""
