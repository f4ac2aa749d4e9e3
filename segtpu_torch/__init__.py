"""PyTorch/CUDA port of segtpu (NCHW, hand-written Hopper kernels).

Modules mirror ``segtpu``; the package imports neither JAX nor ``segtpu``.
Entry points run on CUDA unless the caller passes ``device="cpu"``
(:mod:`segtpu_torch.device`).
"""
