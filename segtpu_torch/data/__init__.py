"""Datasets of the port (counterpart of segtpu/data/__init__.py; reference
torch_train.py:39-64): INRIA constants, the SHAPES generators, the loader.

``get_dataset(name, data_dir, grayscale, patch_size, keep_in_mem)`` ->
``(train_ds, valid_ds, num_classes)``.
"""

from __future__ import annotations

from segtpu_torch.data.shapes import SHAPES, SHAPES_DEVICE

# segtpu's other dataset names: they read files with cv2 and split them with
# scikit-learn, and wait for slice 5 of ROADMAP.md with the host augmentations.
LATER_SLICE = ("dsb2018", "inria", "inria-small", "inria-1024", "inria-512")


def get_dataset(dataset_name: str, data_dir: str = "data", grayscale: bool = False,
                patch_size: int = 224, keep_in_mem: bool = False):
    name = dataset_name.lower()
    if name == "shapes":
        return SHAPES(patch_size, grayscale=grayscale)
    if name in ("shapes-device", "shapes_device"):
        return SHAPES_DEVICE(patch_size, grayscale=grayscale)
    if name in LATER_SLICE:
        raise ValueError(f"dataset {dataset_name!r} is not yet ported to segtpu_torch: it waits "
                         "for slice 5 of ROADMAP.md (datasets and host augmentations); "
                         "ported: shapes, shapes-device")
    raise ValueError(dataset_name)
