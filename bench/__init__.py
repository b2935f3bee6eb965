"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one NVIDIA H100.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line.  Everything
a cell needs is found by name: ``configs/<config>.json`` (sizes, the runner),
``traffic/<traffic>.json`` (the mix), ``limits/<cell>.json`` (the limits of
the output check) and ``metrics/<metric>.py`` (one reader per metric; a
split name ``<base>.<part>`` falls back to ``metrics/<base>.py``).
Nothing here imports ``jax`` or the JAX package ``repro``; ``reference/``
imports nothing of ``repro_torch`` either.
"""
