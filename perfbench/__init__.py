"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one H100.

``python perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything a cell needs is found by name: its configuration
in ``configs/``, its traffic mix in ``traffic/`` (which names its driver
in ``drivers/``), each per-layer metric's reader in ``metrics/`` and the
limits its outputs are judged by in ``limits/``.
"""
