"""The benchmark of ``ppr_tpu_torch`` on one NVIDIA H100.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line last. Everything that belongs to one deployment, traffic mix or
per-layer metric is a file of its own under ``configs/``, ``traffic/`` and
``metrics/``, found by the name the manifest gives. The yardstick (the graph
generator, the reference, the trace reader and the published peaks) lives
here and imports nothing of the program.
"""
