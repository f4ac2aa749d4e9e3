"""``train_step_p95_ms`` of the host-bound training cells, whose steps wait for the
host's dispatch and spread ten times wider from run to run than a
device-bound step's, under a bound of their own."""

from segbench.harness import metric_reader

read = metric_reader("train_step_p95_ms")
