"""INRIA Aerial Image Labeling constants (counterpart of segtpu/data/inria.py)."""

# Channel statistics (reference Inria.py:34-35)
INRIA_MEAN = [0.40273115, 0.45046371, 0.42960134]
INRIA_STD = [3.15086464, 3.29831641, 3.63201004]
