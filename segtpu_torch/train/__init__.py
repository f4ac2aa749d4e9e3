"""Train, eval and predict steps, optimizers and schedules, and
reference-format checkpoints."""
