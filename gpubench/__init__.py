"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on NVIDIA H100s.

``python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
from the root of a checkout; see ``run.py``.  Everything that belongs to one
configuration, traffic mix, kind of cell, metric or cell's limits is a file of
its own, found by the name ``BENCHMARK.json`` gives it (``spec.py``).
"""
