"""Dataset constants of the port."""
