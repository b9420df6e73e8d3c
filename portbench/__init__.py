"""portbench: the benchmark of ``tensorhive_tpu_torch`` on an NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON line.
Everything that belongs to one configuration, cell, traffic kind or metric
is a file of its own here, found by name (``configs/``, ``cells/``,
``traffic/``, ``metrics/``); ``reference/`` holds the plain PyTorch model
that decides ``correct``.
"""
