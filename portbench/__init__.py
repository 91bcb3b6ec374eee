"""The benchmark of ``medseg_torch`` on an NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` (at the root of the checkout) and prints
one JSON line. Everything that belongs to one configuration, traffic mix,
per-layer metric, kernel family or cell's limits is a file of its own under
this folder, found by the name the manifest gives (``manifest.py``).
"""
