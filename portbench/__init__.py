"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once. Everything that
belongs to one configuration, traffic mix, cell or per-layer metric is a
file of its own under this folder, found by the name in ``BENCHMARK.json``;
each architecture is a module of its own under ``reference/arch/``, found by
the ``architecture`` key of a configuration file.
"""
