"""``bn_reduce_roofline.train`` of the host-bound training cells, which move
``train_images_per_s.hostbound``."""

from segbench.harness import metric_reader

read = metric_reader("bn_reduce_roofline.train")
