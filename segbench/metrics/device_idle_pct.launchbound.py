"""``device_idle_pct.train`` of the launch-bound training cells, which move
``train_step_p95_ms.hostbound``."""

from segbench.harness import metric_reader

read = metric_reader("device_idle_pct.train")
