"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

One command runs one cell once::

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: ``BENCHMARK.json`` at the repository's root
lists the cells and metrics, ``gpubench/configs/<config>.json`` holds each
model configuration, ``gpubench/workloads/<cell>.json`` each traffic mix,
``gpubench/metrics/<metric>.py`` the reader of each metric and
``gpubench/drivers/<driver>.py`` each kind of run (serving, training). The
plain reference that decides ``correct`` lives in ``gpubench/reference/``
and imports nothing of the port.
"""
