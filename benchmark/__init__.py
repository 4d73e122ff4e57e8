"""Benchmark of the PyTorch/CUDA port (``dream2real_tpu_torch``) on one GPU.

One command runs one cell of ``BENCHMARK.json`` once:

    python -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives it: ``configs/<config>.json``,
``workloads/<cell>.json`` (which names its driver in ``drivers/``) and
``metrics/<metric>.py``. The plain reference that decides ``correct`` is in
``reference/`` and imports nothing of the port. See README.md.
"""
