"""The benchmark of ``graphflow_tpu_torch`` on NVIDIA H100 cards.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything that decides a number lives here and not in the
program: the graph generator, the operation and byte counts with the
card's peaks, the plain reference that decides ``correct``, and one reader
per metric (``perfbench/metrics/<name>.py``).  A cell is found by name:
its configuration in ``configs/``, its traffic mix in ``traffic/`` and the
limits of its check in ``workloads/``.
"""
