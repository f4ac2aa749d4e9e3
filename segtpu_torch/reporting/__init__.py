"""Cross-experiment reporting (counterpart of segtpu/reporting; reference
plot.py, plot_loss.py): plots from the history CSVs that the train CLI
writes and from the NumPy loss mirrors. matplotlib (Agg) and pandas are
imported where a plot is made; seaborn's style is used when it is there."""
