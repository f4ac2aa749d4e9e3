"""Datasets of the port: INRIA constants and the SHAPES generators."""
