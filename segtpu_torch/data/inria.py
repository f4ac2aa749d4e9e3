"""INRIA Aerial Image Labeling datasets (counterpart of segtpu/data/inria.py;
reference lib/datasets/Inria.py).

5000x5000 aerial tiles handled three ways, matching the reference:
lazy tiled datasets (``inria``/``inria-small``), pre-sliced patch files
(``inria-1024``/``inria-512``), and an offline patch cutter.
"""

from __future__ import annotations

import os

import numpy as np

from segtpu_torch.augment import host as aug
from segtpu_torch.data.common import ImageMaskDataset, TiledImagesDataset
from segtpu_torch.data.split import train_test_split
from segtpu_torch.tiles import ImageSlicer
from segtpu_torch.utils import find_in_dir, read_mask, read_rgb

# Channel statistics (reference Inria.py:34-35)
INRIA_MEAN = [0.40273115, 0.45046371, 0.42960134]
INRIA_STD = [3.15086464, 3.29831641, 3.63201004]


def _train_transform(grayscale: bool):
    return aug.Sequential([
        aug.ImageOnly(aug.RandomGrayscale(1.0 if grayscale else 0.5)),
        aug.ImageOnly(aug.RandomBrightness()),
        aug.ImageOnly(aug.RandomContrast()),
        aug.VerticalFlip(),
        aug.HorizontalFlip(),
        aug.ShiftScaleRotate(rotate_limit=15),
        aug.ImageOnly(aug.NormalizeImage(mean=INRIA_MEAN, std=INRIA_STD)),
        aug.MaskOnly(aug.MakeBinary()),
    ])


def _test_transform():
    return aug.Sequential([
        aug.ImageOnly(aug.NormalizeImage(mean=INRIA_MEAN, std=INRIA_STD)),
        aug.MaskOnly(aug.MakeBinary()),
    ])


def INRIA(dataset_dir: str, grayscale: bool, patch_size: int,
          keep_in_mem: bool, small: bool = False, raw: bool = False):
    """Lazy tiled datasets over the 5000x5000 images
    (reference Inria.py:38-67); ``small`` truncates to 4 images; ``raw``
    skips the host transforms, for the device augmentations of
    ``--device-augs`` (:mod:`segtpu_torch.augment.device`)."""
    x = sorted(find_in_dir(os.path.join(dataset_dir, "images")))
    y = sorted(find_in_dir(os.path.join(dataset_dir, "gt")))
    if small:
        x, y = x[:4], y[:4]

    x_train, x_test, y_train, y_test = train_test_split(
        x, y, random_state=1234, test_size=0.1
    )

    train = TiledImagesDataset(x_train, y_train, patch_size,
                               target_shape=(5000, 5000),
                               transform=None if raw else _train_transform(grayscale),
                               keep_in_mem=keep_in_mem)
    test = TiledImagesDataset(x_test, y_test, patch_size,
                              target_shape=(5000, 5000),
                              transform=None if raw else _test_transform(),
                              keep_in_mem=keep_in_mem)
    return train, test, 1


def INRIASliced(dataset_dir: str, grayscale: bool):
    """Pre-sliced patch files, split stratified by 6-char geocode prefix
    (reference Inria.py:70-105)."""
    x = sorted(find_in_dir(os.path.join(dataset_dir, "images")))
    y = sorted(find_in_dir(os.path.join(dataset_dir, "gt")))
    image_id = [os.path.basename(f).split("_")[0] for f in x]

    unique_image_id = np.unique(image_id)
    location = [basename[:6] for basename in unique_image_id]
    train_id, test_id = train_test_split(
        unique_image_id, random_state=1234, test_size=0.1, stratify=location
    )
    train_id = set(train_id)

    xy_train = [(i, m) for i, m, iid in zip(x, y, image_id) if iid in train_id]
    xy_test = [(i, m) for i, m, iid in zip(x, y, image_id) if iid not in train_id]
    x_train, y_train = zip(*xy_train)
    x_test, y_test = zip(*xy_test)

    train = ImageMaskDataset(x_train, y_train, image_loader=read_rgb,
                             target_loader=read_mask,
                             transform=_train_transform(grayscale),
                             load_in_ram=False)
    test = ImageMaskDataset(x_test, y_test, image_loader=read_rgb,
                            target_loader=read_mask,
                            transform=_test_transform(), load_in_ram=False)
    return train, test, 1


def cut_dataset_in_patches(data_dir: str, output_dir: str, patch_size: int):
    """Offline preprocessing: write overlapping patch .tif files
    (reference Inria.py:108-130)."""
    import cv2
    from tqdm import tqdm

    x = sorted(find_in_dir(os.path.join(data_dir, "images")))
    y = sorted(find_in_dir(os.path.join(data_dir, "gt")))

    out_img = os.path.join(output_dir, "images")
    out_msk = os.path.join(output_dir, "gt")
    os.makedirs(out_img, exist_ok=True)
    os.makedirs(out_msk, exist_ok=True)

    slicer = ImageSlicer((5000, 5000), patch_size, patch_size // 2)
    for image_fname, mask_fname in tqdm(list(zip(x, y))):
        image = read_rgb(image_fname)
        mask = read_mask(mask_fname)
        basename = os.path.splitext(os.path.basename(image_fname))[0]
        for index, patch in enumerate(slicer.split(image)):
            cv2.imwrite(os.path.join(out_img, f"{basename}_{index}.tif"), patch)
        for index, patch in enumerate(slicer.split(mask)):
            cv2.imwrite(os.path.join(out_msk, f"{basename}_{index}.tif"), patch)


def compute_mean_std(image_fnames):
    """Dataset channel statistics (reference Inria.py:14-31): per-image
    mean/var of 1/255-scaled pixels, averaged over images — including the
    reference's quirk of returning sqrt of the *sum* (not mean) of
    variances."""
    one_over_255 = 1.0 / 255.0
    global_mean = np.zeros(3, dtype=np.float64)
    global_var = np.zeros(3, dtype=np.float64)
    n_items = len(image_fnames)
    for fname in image_fnames:
        x = read_rgb(fname) * one_over_255
        mean = x.reshape(-1, x.shape[-1]).mean(axis=0)
        std = x.reshape(-1, x.shape[-1]).std(axis=0)
        global_mean += mean
        global_var += std ** 2
    return global_mean / n_items, np.sqrt(global_var)
