"""Regularised trainer CLI of the port (counterpart of segtpu/train_reg_cli.py;
reference torch_train_reg.py).

The train CLI's grid cell with an L1 penalty on the convolution kernels and
an L2 penalty on their biases added to the scaled loss:
``batch_size * loss + l1 + l2`` (torch_train_reg.py:97).

    python -m segtpu_torch.train_reg_cli -m linknet34 -d shapes -l bce -o adam -b 8 -e 10
"""

from __future__ import annotations

from segtpu_torch.regularization import make_conv2d_penalty
from segtpu_torch.train_cli import main as _main


def main(argv=None, l1_factor: float = 0.0005, l2_factor: float = 0.0005):
    return _main(argv, param_penalty=make_conv2d_penalty(l1_factor, l2_factor))


if __name__ == "__main__":
    main()
