"""``train_images_per_s`` of the launch-bound training cells, whose host's
pace changes by up to a fifth from one run to the next, wider than the
widest bound an end-to-end metric may have: read per layer, beside the
cell's ``train_step_p95_ms.hostbound``, which it moves."""

from segbench.harness import metric_reader

read = metric_reader("train_images_per_s")
