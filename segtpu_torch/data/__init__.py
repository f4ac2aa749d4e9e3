"""Dataset registry of the port (counterpart of segtpu/data/__init__.py;
reference torch_train.py:39-64).

``get_dataset(name, data_dir, grayscale, patch_size, keep_in_mem)`` ->
``(train_ds, valid_ds, num_classes)``.
"""

from __future__ import annotations

from segtpu_torch.data.dsb2018 import DSB2018Sliced
from segtpu_torch.data.inria import INRIA, INRIASliced
from segtpu_torch.data.shapes import SHAPES, SHAPES_DEVICE


def get_dataset(dataset_name: str, data_dir: str = "data", grayscale: bool = False,
                patch_size: int = 224, keep_in_mem: bool = False):
    name = dataset_name.lower()
    if name == "shapes":
        return SHAPES(patch_size, grayscale=grayscale)
    if name in ("shapes-device", "shapes_device"):
        return SHAPES_DEVICE(patch_size, grayscale=grayscale)
    if name == "dsb2018":
        return DSB2018Sliced(data_dir, grayscale, patch_size)
    if name in ("inria", "inria-small"):
        return INRIA(data_dir, grayscale, patch_size, keep_in_mem, small=name == "inria-small")
    if name in ("inria-1024", "inria-512"):
        if patch_size != int(name[6:]):
            raise ValueError(f"Patch size must be {name[6:]}")
        return INRIASliced(data_dir, grayscale)
    raise ValueError(dataset_name)
