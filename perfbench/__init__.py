"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything that belongs to one configuration, traffic mix,
per-layer metric or count lives in a file of its own, found by name:
``configs/<config>.json``, ``traffic/<mix>.json`` (whose ``kind`` names
``kinds/<kind>.py``), ``metrics/<metric>.py``, ``counts/<name>.py``,
``reference/<family>.py`` and ``limits/<cell>.json``.
"""
