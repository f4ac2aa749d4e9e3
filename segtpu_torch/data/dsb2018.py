"""DSB2018 (Data Science Bowl 2018 nuclei) datasets (counterpart of
segtpu/data/dsb2018.py; reference lib/datasets/dsb2018.py).

Split parity: ``train_test_split(random_state=1234, test_size=0.1)`` with the
same stratification (by source image id for the sliced variant) so val-IoU is
comparable run-to-run with the reference.
"""

from __future__ import annotations

import os
from typing import List, Tuple

from segtpu_torch.augment import host as aug
from segtpu_torch.data.common import ImageMaskDataset, InMemoryDataset
from segtpu_torch.data.split import train_test_split
from segtpu_torch.tiles import ImageSlicer
from segtpu_torch.utils import find_in_dir, read_mask, read_rgb

_SPLIT_SEED = 1234  # reference dsb2018.py:23,75
_TEST_FRACTION = 0.1


def _normalize_and_binarize() -> List:
    """The common tail of every DSB pipeline: ImageNet normalize + binary mask."""
    return [aug.ImageOnly(aug.NormalizeImage()), aug.MaskOnly(aug.MakeBinary())]


def _heavy_geometric() -> List:
    """Train-time geometric augmentations of the sliced variant
    (reference dsb2018.py:76-84)."""
    return [
        aug.RandomRotate90(),
        aug.VerticalFlip(),
        aug.HorizontalFlip(),
        aug.ShiftScaleRotate(rotate_limit=15),
    ]


def _list_pairs(dataset_dir: str) -> Tuple[List[str], List[str]]:
    return (
        find_in_dir(os.path.join(dataset_dir, "images")),
        find_in_dir(os.path.join(dataset_dir, "masks")),
    )


def DSB2018(dataset_dir: str, grayscale: bool, patch_size: int):
    """File-based variant: random-crop train / center-crop test pipelines
    (reference dsb2018.py:11-49)."""
    images, masks = _list_pairs(dataset_dir)
    x_train, x_test, y_train, y_test = train_test_split(
        images, masks, random_state=_SPLIT_SEED, test_size=_TEST_FRACTION
    )

    def make(filenames, targets, crop):
        return ImageMaskDataset(
            filenames, targets, image_loader=read_rgb, target_loader=read_mask,
            transform=aug.Sequential([crop] + _normalize_and_binarize()),
            load_in_ram=False,
        )

    train = make(x_train, y_train, aug.RandomCrop(patch_size))
    test = make(x_test, y_test, aug.CenterCrop(patch_size, patch_size))
    return train, test, 1


def slice_all_into_patches(images, masks, patch_size: int):
    """Slice every (image, mask) pair into overlapping patches with
    step = patch/2, tracking the source image id of each patch (the
    stratification key) — reference dsb2018.py:61-73."""
    patch_images, patch_masks, image_ids = [], [], []
    for image_id, (image, mask) in enumerate(zip(images, masks)):
        slicer = ImageSlicer(image.shape, patch_size, patch_size // 2)
        img_patches = slicer.split(image)
        patch_images.extend(img_patches)
        patch_masks.extend(slicer.split(mask))
        image_ids.extend([image_id] * len(img_patches))
    return patch_images, patch_masks, image_ids


def DSB2018Sliced(dataset_dir: str, grayscale: bool, patch_size: int,
                  raw: bool = False):
    """RAM-sliced variant, registered as ``dsb2018``
    (reference dsb2018.py:52-98): all images loaded, overlap-sliced,
    stratified split by source image, heavy train augmentations.

    ``raw=True`` skips the host transforms entirely: the loaders yield raw
    pixels, for the device augmentations of ``--device-augs``
    (:mod:`segtpu_torch.augment.device`).
    """
    image_files, mask_files = _list_pairs(dataset_dir)
    images = [read_rgb(f) for f in image_files]
    masks = [read_mask(f) for f in mask_files]

    patch_images, patch_masks, image_ids = slice_all_into_patches(
        images, masks, patch_size
    )
    x_train, x_test, y_train, y_test = train_test_split(
        patch_images, patch_masks, random_state=_SPLIT_SEED,
        test_size=_TEST_FRACTION, stratify=image_ids,
    )

    if raw:
        train_pipeline = test_pipeline = None
    else:
        train_pipeline = aug.Sequential(
            [aug.ImageOnly(aug.NormalizeImage())]
            + _heavy_geometric()
            + [aug.MaskOnly(aug.MakeBinary())]
        )
        test_pipeline = aug.Sequential(_normalize_and_binarize())

    return (
        InMemoryDataset(x_train, y_train, transform=train_pipeline),
        InMemoryDataset(x_test, y_test, transform=test_pipeline),
        1,
    )
