"""segbench: the benchmark of segtpu_torch, the PyTorch and CUDA port, on one H100.

``python3 segbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line. Everything
that belongs to one configuration, traffic mix or metric is a file of its own,
found by the name that ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the model, its recipe and its counted work;
* ``workloads/<cell>.json``: the cell's configuration, traffic and limits;
* ``traffic/<traffic>.json``: the mix's parameters, read by the generator
  ``traffic/<kind>.py`` that the mix names;
* ``metrics/<metric>.py``: ``read(record)``, the metric from the run's record.

``reference/`` is plain PyTorch that imports nothing of the port, JAX or
segtpu; the run's ``correct`` compares the program's output with it.
"""
