"""``outside_pass_pct.serve`` of the cells without TTA, which move
``serve_s_per_image.notta``."""

from segbench.harness import metric_reader

read = metric_reader("outside_pass_pct.serve")
