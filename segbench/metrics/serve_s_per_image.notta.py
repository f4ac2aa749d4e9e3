"""``serve_s_per_image`` of the cells without TTA, whose host-bound stream
spreads ten times wider from run to run than the TTA cell's, under a bound
of its own."""

from segbench.harness import metric_reader

read = metric_reader("serve_s_per_image")
