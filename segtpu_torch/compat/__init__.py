"""Weights carried across from segtpu parameter trees."""
