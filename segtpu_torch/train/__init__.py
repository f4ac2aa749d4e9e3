"""Predict step and reference-format checkpoints."""
