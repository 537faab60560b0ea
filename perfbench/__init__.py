"""The benchmark of viabel_torch on one NVIDIA H100.

``python3 perfbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line last. Everything a cell needs is found by name: its
configuration in ``configs/``, its traffic mix in ``traffic/``, its
limits in ``limits/`` and each per-layer metric's reader in
``metrics/``. See ``README.md``.
"""
