"""Afterburner trainer CLI of the port (counterpart of segtpu/train_ab_cli.py;
reference torch_train_ab.py).

Two stages: the train CLI's best checkpoint of a model, ``<model>_checkpoint.pth``
(found by a recursive search from the working directory,
torch_train_ab.py:242), becomes a frozen head, and a 1-channel UNet
"afterburner" stacked after its sigmoid trains. The train CLI's flags; the
experiment name gets the prefix ``ab_``.

    python -m segtpu_torch.train_ab_cli -m linknet34 -d shapes -l bce -o adam -b 8 -e 10
"""

from __future__ import annotations

import torch

from segtpu_torch.models import get_model
from segtpu_torch.models.afterburner_stack import AfterburnerStack, head_frozen_mask
from segtpu_torch.models.layers import reset_parameters
from segtpu_torch.train.checkpoint import load_snapshot
from segtpu_torch.train_cli import main as _main
from segtpu_torch.utils import auto_file


def _model_builder(args, num_channels):
    head = get_model(args.model, patch_size=args.patch_size, num_channels=num_channels,
                     device="cpu")
    stack = AfterburnerStack(head)
    reset_parameters(stack.afterburner, torch.Generator().manual_seed(0))
    return stack


def _model_initializer(model, args):
    """The trained head's weights and running statistics into ``model.head``."""
    state_dict, _ = load_snapshot(auto_file(f"{args.model}_checkpoint.pth"))
    model.head.load_state_dict(state_dict)


def main(argv=None):
    return _main(argv, model_builder=_model_builder, model_initializer=_model_initializer,
                 trainable_mask_fn=head_frozen_mask, experiment_prefix="ab_")


if __name__ == "__main__":
    main()
