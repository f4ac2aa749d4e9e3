"""``device_idle_pct.serve`` of the cells without TTA, which move
``serve_s_per_image.notta``."""

from segbench.harness import metric_reader

read = metric_reader("device_idle_pct.serve")
