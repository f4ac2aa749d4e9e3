"""segtpu_torch's data layer against segtpu's: the numpy train/test split
against scikit-learn's, every host transform, the DSB2018 and INRIA datasets
on files, the nuclei fixture and the dataset registry, bit for bit
(``np.array_equal``); then the port's train CLI for one epoch on the fixture
and the band rule of ``python -m segtpu_torch.ab_nuclei``.

Small: 24 x 24 (or 24 x 30) images for the transforms, a fixture of 6
nuclei images sliced at patch 128, INRIA-style files of 120 x 120, and one
CLI epoch of LinkNet34 at ``-p 64 -b 2 -s 2`` on the CPU (the kernels through
their plain versions). Nothing here reads the reference checkout.
"""

import importlib.util
import inspect
import os
import random
import re
import shutil
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from sklearn.model_selection import train_test_split as sk_train_test_split

from segtpu.augment import host as jax_host
from segtpu.data import dsb2018 as jax_dsb2018
from segtpu.data import get_dataset as jax_get_dataset
from segtpu.data import inria as jax_inria
from segtpu.data import nuclei_fixture as jax_fixture
from segtpu.tiles import ImageSlicer as JaxImageSlicer

from segtpu_torch import ab_nuclei, train_cli
from segtpu_torch.augment import host
from segtpu_torch.data import dsb2018, get_dataset, inria, nuclei_fixture
from segtpu_torch.data.common import TiledImagesDataset
from segtpu_torch.data.split import train_test_split
from segtpu_torch.tiles import ImageSlicer
from segtpu_torch.utils import read_gray, read_mask
from torch_port_util import module_tmp, tmp_path  # noqa: F401  (removed after use)

REPO = Path(__file__).resolve().parent.parent
FIXTURE_IMAGES, PATCH = 6, 128


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def assert_same(ours, theirs):
    """Equal values of equal types: arrays bit for bit with their dtype,
    lists, tuples and dicts element by element."""
    assert type(ours) is type(theirs), (type(ours), type(theirs))
    if isinstance(theirs, np.ndarray):
        assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
        assert np.array_equal(ours, theirs, equal_nan=ours.dtype.kind == "f")
    elif isinstance(theirs, (list, tuple)):
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            assert_same(a, b)
    else:
        assert ours == theirs


# ---------------------------------------------------------------------------
# train_test_split against scikit-learn's
# ---------------------------------------------------------------------------

def _labels(kind, n):
    rng = np.random.RandomState(n)
    if kind == "fixture_ids":  # slice_all_into_patches' image ids: 9 or 12 patches each
        return [i for i in range(n) for _ in range(9 + 3 * (i % 5 in (2, 4)))]
    if kind == "geocodes":  # INRIASliced's 6-character locations of np.unique ids
        return [("austin", "chicag", "kitsap", "tyrol-", "vienna")[i % 5] for i in range(n)]
    return list(rng.randint(0, 4, n))


@pytest.mark.parametrize("random_state", [1234, 0, 20260819])
@pytest.mark.parametrize("test_size", [0.1, 0.25])
@pytest.mark.parametrize("n", [20, 57, 489])
def test_split_matches_sklearn(n, test_size, random_state):
    x = [f"image_{i}.png" for i in range(n)]
    y = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    ids = np.unique([f"id{i:03d}" for i in range(n)])
    for arrays in ((x, y), (ids,), (tuple(x),)):
        assert_same(train_test_split(*arrays, test_size=test_size, random_state=random_state),
                    sk_train_test_split(*arrays, test_size=test_size, random_state=random_state))


@pytest.mark.parametrize("random_state", [1234, 0, 20260819])
@pytest.mark.parametrize("test_size", [0.1, 0.25])
@pytest.mark.parametrize("labels", ["fixture_ids", "geocodes", "random"])
def test_stratified_split_matches_sklearn(labels, test_size, random_state):
    n = 40 if labels != "fixture_ids" else 6
    strat = _labels(labels, n)
    items = [np.full((2, 2), i, np.uint8) for i in range(len(strat))]
    args = dict(test_size=test_size, random_state=random_state, stratify=strat)
    try:
        want = sk_train_test_split(items, np.asarray(strat), **args)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            train_test_split(items, np.asarray(strat), **args)
        return
    assert_same(train_test_split(items, np.asarray(strat), **args), want)


@pytest.mark.parametrize("case", [
    dict(n=10, test_size=0.1, stratify=[0, 1] * 5),            # n_test 1 < 2 classes
    dict(n=10, test_size=0.9, stratify=[0, 1] * 5),            # n_train 1 < 2 classes
    dict(n=10, test_size=0.3, stratify=[0] * 9 + [1]),         # a class of one member
    dict(n=10, test_size=1.5, stratify=None),                  # not in (0, 1)
    dict(n=10, test_size=10, stratify=None),                   # not below n
    dict(n=10, test_size="a", stratify=None),
    dict(n=10, test_size=0.95, stratify=None),                 # an empty train set
    dict(n=10, test_size=0, stratify=None),                    # a count below 1
])
def test_split_raises_as_sklearn(case):
    kw = dict(case, random_state=1234)
    x = list(range(kw.pop("n")))
    with pytest.raises(ValueError) as theirs:
        sk_train_test_split(x, **kw)
    with pytest.raises(ValueError) as ours:
        train_test_split(x, **kw)
    assert str(ours.value) == str(theirs.value)


# ---------------------------------------------------------------------------
# Host transforms
# ---------------------------------------------------------------------------

# name -> (constructor kwargs, takes a mask, gated by prob)
TRANSFORMS = {
    "VerticalFlip": ({}, True, True),
    "HorizontalFlip": ({}, True, True),
    "Transpose": ({}, True, True),
    "RandomRotate90": ({}, True, True),
    "Rotate": ({}, True, True),
    "Shift": ({}, True, True),
    "ShiftScale": ({}, True, True),
    "ShiftScaleRotate": ({}, True, True),
    "ShiftScaleRotate15": ({"rotate_limit": 15, "shift_limit": 0.6}, True, True),
    "CenterCrop": ({"height": 16, "width": 12}, True, False),
    "RandomCrop": ({"size": 16}, True, False),
    "RandomCropPadded": ({"size": 20, "padding": 3}, True, False),
    "RandomGrayscale": ({}, False, True),
    "RandomInvert": ({}, False, True),
    "RandomFilter": ({}, False, True),
    "RandomBrightness": ({}, False, True),
    "RandomContrast": ({}, False, True),
    "RandomSaturation": ({}, False, True),
    "RandomHueSaturationValue": ({}, False, True),
    "CLAHE": ({}, False, False),
    "NormalizeImage": ({}, False, False),
    "MakeBinary": ({}, False, False),
}
ALIASES = {"ShiftScaleRotate15": "ShiftScaleRotate", "RandomCropPadded": "RandomCrop"}


def _image_and_mask(dtype, seed):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (24, 24, 3)).astype(dtype)
    mask = (rng.rand(24, 24) > 0.6).astype(np.uint8 if dtype == np.uint8 else np.float32)
    return img, mask


def _apply(module, name, prob, dtype, rng_of):
    """Four calls of one transform of ``module`` on seeded inputs: each
    output, or "cv2.error" where OpenCV refused the input."""
    kwargs, with_mask, gated = TRANSFORMS[name]
    cls = getattr(module, ALIASES.get(name, name))
    kwargs = dict(kwargs)
    if gated and prob is not None:
        kwargs["prob"] = prob
    if "rng" in inspect.signature(cls).parameters:
        kwargs["rng"] = rng_of(module)
    t = cls(**kwargs)
    outs = []
    for call in range(4):
        img, mask = _image_and_mask(dtype, call)
        try:
            if name == "MakeBinary":
                outs.append(t(mask))
            else:
                outs.append(t(img, mask) if with_mask else t(img))
        except cv2.error:
            outs.append("cv2.error")
    return outs


@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["uint8", "float32"])
@pytest.mark.parametrize("prob", [None, 1.0], ids=["default_p", "p1"])
@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_host_transform_matches_segtpu(name, prob, dtype):
    """Each transform of a seeded ``random.Random`` on each side gives
    segtpu's outputs; its gate and parameters come from that stream in
    segtpu's order, so the two streams end in the same state."""
    rngs = {}

    def rng_of(module):
        rngs[module] = random.Random(1234)
        return rngs[module]

    assert_same(_apply(host, name, prob, dtype, rng_of),
                _apply(jax_host, name, prob, dtype, rng_of))
    if rngs:
        assert rngs[host].getstate() == rngs[jax_host].getstate()


def test_combinators_draw_from_the_bound_stream():
    """OneOf and OneOrOther on DEFAULT_RNG: under bind_sample_rng the draws
    are segtpu's under its own binding, sample by sample."""
    def pipeline(m):
        return m.Sequential([
            m.OneOf([m.VerticalFlip(), m.Rotate(limit=30), m.RandomRotate90()], prob=0.7),
            m.OneOrOther(m.ShiftScaleRotate(rotate_limit=15), m.Transpose(), prob=0.5),
            m.ImageOnly(m.RandomBrightness()), m.ImageOnly(m.NormalizeImage()),
            m.MaskOnly(m.MakeBinary())])

    ours, theirs = pipeline(host), pipeline(jax_host)
    for index in range(12):
        img, mask = _image_and_mask(np.uint8, index)
        with host.bind_sample_rng(7, 1, index):
            a = ours(img.copy(), mask.copy())
        with jax_host.bind_sample_rng(7, 1, index):
            b = theirs(img.copy(), mask.copy())
        assert_same(a, b)


# ---------------------------------------------------------------------------
# The nuclei fixture, DSB2018 and INRIA on files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("index", [0, 1, 2, 4, 7])
def test_nuclei_fixture_matches_segtpu(index):
    assert_same(nuclei_fixture.generate_image(20260819, index),
                jax_fixture.generate_image(20260819, index))


@pytest.fixture(scope="module")
def fixture_dir(module_tmp):
    root = module_tmp("nuclei") / "dsb2018"
    nuclei_fixture.write_fixture(str(root), FIXTURE_IMAGES)
    return root


def test_write_fixture_writes_segtpu_files(fixture_dir, tmp_path):
    jax_fixture.write_fixture(str(tmp_path), FIXTURE_IMAGES)
    for sub in ("images", "masks"):
        names = sorted(os.listdir(fixture_dir / sub))
        assert names == sorted(os.listdir(tmp_path / sub)) and len(names) == FIXTURE_IMAGES
        for f in names:
            assert (fixture_dir / sub / f).read_bytes() == (tmp_path / sub / f).read_bytes()
    mask = str(fixture_dir / "masks" / "000.png")
    assert np.array_equal(read_mask(mask), (read_gray(mask) > 0).astype(np.uint8))


@pytest.fixture(scope="module")
def sliced(fixture_dir):
    return (dsb2018.DSB2018Sliced(str(fixture_dir), False, PATCH),
            jax_dsb2018.DSB2018Sliced(str(fixture_dir), False, PATCH))


def test_dsb2018_sliced_split_and_patches_match_segtpu(sliced):
    (ours_train, ours_test, n_ours), (train, test, n) = sliced
    assert n_ours == n == 1
    assert (len(ours_train), len(ours_test)) == (len(train), len(test)) == (54, 6)
    for a, b in ((ours_train, train), (ours_test, test)):
        assert_same(a.images, b.images)
        assert_same(a.masks, b.masks)


@pytest.mark.parametrize("split", ["train", "test"])
def test_dsb2018_sliced_samples_match_segtpu(sliced, split):
    """The first 16 samples of each split under bind_sample_rng(seed, epoch,
    index), as the seeded loader draws them."""
    i = 0 if split == "train" else 1
    ours, theirs = sliced[0][i], sliced[1][i]
    for index in range(min(16, len(theirs))):
        with host.bind_sample_rng(20260819, 3, index):
            a = ours[index]
        with jax_host.bind_sample_rng(20260819, 3, index):
            b = theirs[index]
        assert_same(a, b)
        assert a[0].dtype == np.float32 and a[1].shape == (PATCH, PATCH, 1)


def test_dsb2018_raw_and_file_based_match_segtpu(fixture_dir):
    raw, raw_jax = (dsb2018.DSB2018Sliced(str(fixture_dir), False, PATCH, raw=True),
                    jax_dsb2018.DSB2018Sliced(str(fixture_dir), False, PATCH, raw=True))
    assert raw[0].transform is None and raw[1].transform is None
    assert_same(raw[0][5], raw_jax[0][5])
    ours, theirs = dsb2018.DSB2018(str(fixture_dir), False, 96), jax_dsb2018.DSB2018(
        str(fixture_dir), False, 96)
    for a, b in zip(ours[:2], theirs[:2]):
        assert_same(a.images, b.images)
        for index in range(len(b)):
            with host.bind_sample_rng(5, 0, index):
                x = a[index]
            with jax_host.bind_sample_rng(5, 0, index):
                y = b[index]
            assert_same(x, y)


def _write_inria(root, names, size=120):
    rng = np.random.RandomState(1)
    for sub in ("images", "gt"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    for name in names:
        cv2.imwrite(str(root / "images" / f"{name}.tif"),
                    rng.randint(0, 256, (size, size, 3)).astype(np.uint8))
        cv2.imwrite(str(root / "gt" / f"{name}.tif"),
                    ((rng.rand(size, size) > 0.7) * 255).astype(np.uint8))
    return root


INRIA_NAMES = [f"{city}{i}" for city in ("austin", "vienna") for i in range(1, 11)]


@pytest.fixture(scope="module")
def inria_dirs(module_tmp):
    """A tiled INRIA directory of 20 images and its patches, cut by each
    package's cut_dataset_in_patches at 120 x 120 instead of 5000 x 5000."""
    root = _write_inria(module_tmp("inria"), INRIA_NAMES)
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for key, module, slicer in (("ours", inria, ImageSlicer),
                                    ("jax", jax_inria, JaxImageSlicer)):
            mp.setattr(module, "ImageSlicer",
                       lambda shape, size, step, slicer=slicer: slicer((120, 120), size, step))
            out[key] = root.parent / f"sliced_{key}_{root.name}"
            module.cut_dataset_in_patches(str(root), str(out[key]), 64)
    finally:
        mp.undo()
    return root, out["ours"], out["jax"]


def test_inria_cut_into_patches_matches_segtpu(inria_dirs):
    _, ours, theirs = inria_dirs
    for sub in ("images", "gt"):
        names = sorted(os.listdir(ours / sub))
        assert names == sorted(os.listdir(theirs / sub)) and len(names) == 20 * 9
        for f in names[:12]:
            assert (ours / sub / f).read_bytes() == (theirs / sub / f).read_bytes()


def test_inria_tiled_and_sliced_match_segtpu(inria_dirs):
    root, sliced_dir, _ = inria_dirs
    for small in (False, True):
        ours, theirs = (inria.INRIA(str(root), False, 64, False, small=small),
                        jax_inria.INRIA(str(root), False, 64, False, small=small))
        for a, b in zip(ours[:2], theirs[:2]):
            assert [d.image_fname for d in a.datasets] == [d.image_fname for d in b.datasets]
            assert [d.mask_fname for d in a.datasets] == [d.mask_fname for d in b.datasets]
            assert len(a) == len(b)
    ours, theirs = inria.INRIASliced(str(sliced_dir), False), jax_inria.INRIASliced(
        str(sliced_dir), False)
    for a, b in zip(ours[:2], theirs[:2]):
        assert (a.images, a.targets) == (b.images, b.targets)
    for index in (0, 7, 33):
        with host.bind_sample_rng(3, 0, index):
            x = ours[0][index]
        with jax_host.bind_sample_rng(3, 0, index):
            y = theirs[0][index]
        assert_same(x, y)


def test_inria_tiles_and_statistics_match_segtpu(inria_dirs):
    """Tiles cut lazily (cut_patch) through the train transform, at a small
    target shape, and compute_mean_std."""
    root = inria_dirs[0]
    images = [str(root / "images" / f"{n}.tif") for n in INRIA_NAMES[:2]]
    masks = [str(root / "gt" / f"{n}.tif") for n in INRIA_NAMES[:2]]
    from segtpu.data.common import TiledImagesDataset as JaxTiledImagesDataset
    ours = TiledImagesDataset(images, masks, 48, target_shape=(120, 120),
                              transform=inria._train_transform(False))
    theirs = JaxTiledImagesDataset(images, masks, 48, target_shape=(120, 120),
                                   transform=jax_inria._train_transform(False))
    assert len(ours) == len(theirs) == 2 * 9
    for index in range(len(theirs)):
        with host.bind_sample_rng(11, 2, index):
            x = ours[index]
        with jax_host.bind_sample_rng(11, 2, index):
            y = theirs[index]
        assert_same(x, y)
    image = cv2.imread(images[0])
    slicer, jax_slicer = ImageSlicer((120, 120), 48, 24), JaxImageSlicer((120, 120), 48, 24)
    assert [slicer.cut_patch(image, i).tobytes() for i in range(len(slicer.crops))] == \
        [t.tobytes() for t in slicer.split(image)]
    assert_same(slicer.cut_patch(image, 5), jax_slicer.cut_patch(image, 5))
    assert_same(inria.compute_mean_std(images), jax_inria.compute_mean_std(images))


@pytest.mark.parametrize("name", ["dsb2018", "inria", "inria-small", "inria-1024", "inria-512"])
def test_get_dataset_matches_segtpu(name, fixture_dir, inria_dirs):
    """Each file dataset of segtpu's registry, its split and its first
    sample; the sliced INRIA names keep segtpu's patch-size check."""
    if name == "dsb2018":
        data_dir, patch = fixture_dir, PATCH
    elif name in ("inria", "inria-small"):
        data_dir, patch = inria_dirs[0], 64
    else:
        data_dir, patch = inria_dirs[1], int(name[6:])
        with pytest.raises(ValueError, match=f"Patch size must be {patch}"):
            get_dataset(name, str(data_dir), patch_size=256)
    ours = get_dataset(name, str(data_dir), patch_size=patch)
    theirs = jax_get_dataset(name, str(data_dir), patch_size=patch)
    assert ours[2] == theirs[2] == 1
    for a, b in zip(ours[:2], theirs[:2]):
        assert len(a) == len(b) > 0
        if name in ("inria", "inria-small"):
            assert [d.image_fname for d in a.datasets] == [d.image_fname for d in b.datasets]
            continue
        with host.bind_sample_rng(1, 0, 0):
            x = a[0]
        with jax_host.bind_sample_rng(1, 0, 0):
            y = b[0]
        assert_same(x, y)


# ---------------------------------------------------------------------------
# The train CLI on the fixture, and the A/B's band rule
# ---------------------------------------------------------------------------

def _segtpu_ab_tool():
    spec = importlib.util.spec_from_file_location("segtpu_ab_nuclei_tool",
                                                  REPO / "tools" / "ab_nuclei.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_cli_epoch_on_dsb2018_writes_segtpu_csv_path(fixture_dir, tmp_path):
    """One epoch of 2 steps: the CSV lies where segtpu's A/B reads it, with
    segtpu's columns; the CLI keeps 3 input channels."""
    argv = ["-m", "linknet34", "-d", "dsb2018", "-dd", str(fixture_dir), "-p", "64", "-b", "2",
            "-l", "bce_jaccard", "-o", "adam", "-lr", "1e-4", "-e", "1", "-s", "2", "--seed",
            "20260819", "--no-tensorboard", "--light-logging", "--device", "cpu",
            "--experiments-dir", str(tmp_path / "experiments")]
    history = train_cli.main(argv)
    path = ab_nuclei.csv_path(tmp_path / "experiments", "linknet34", "bce_jaccard", 64)
    assert str(path) == _segtpu_ab_tool()._csv_path(str(tmp_path), "linknet34", "bce_jaccard", 64)
    lines = path.read_text().splitlines()
    assert lines[0] == "epoch,loss,val_loss,iou,accuracy,val_iou,val_accuracy"
    assert len(lines) == 2 and np.isfinite(history["loss"][0])
    assert ab_nuclei.read_val_iou(path) == history["val_iou"]


def _device_aug_spy(monkeypatch, pipeline):
    """Wrap the train CLI's step so that each augmentation is checked against
    the dataset's pipeline run on the same raw batch with the same seed."""
    from segtpu_torch.augment import device as dev_aug
    seen = []
    real = train_cli.make_train_step

    def spy(*args, augment_fn=None, **kwargs):
        def augment(g, x, y):
            want = pipeline(torch.Generator().manual_seed(g.initial_seed()), x, y)
            out = augment_fn(g, x, y)
            seen.append(all(torch.equal(a, b) for a, b in zip(out, want))
                        and float(x.max()) > 10.0 and set(out[1].unique().tolist()) <= {0.0, 1.0})
            return out
        return real(*args, augment_fn=augment, **kwargs)

    monkeypatch.setattr(train_cli, "make_train_step", spy)
    return seen, dev_aug


def test_cli_device_augs_on_dsb2018(fixture_dir, tmp_path, monkeypatch):
    """``-d dsb2018 --device-augs``: the raw sliced loaders, the DSB2018
    pipeline in the step (its output binary masks), and finite losses."""
    from segtpu_torch.augment.device import dsb2018_train_pipeline
    seen, _ = _device_aug_spy(monkeypatch, dsb2018_train_pipeline)
    argv = ["-m", "linknet34", "-d", "dsb2018", "-dd", str(fixture_dir), "-p", "64", "-b", "2",
            "-l", "bce_jaccard", "-o", "adam", "-lr", "1e-4", "-e", "1", "-s", "2", "--seed", "5",
            "--device-augs", "--no-tensorboard", "--light-logging", "--device", "cpu",
            "--experiments-dir", str(tmp_path / "experiments")]
    history = train_cli.main(argv)
    assert seen == [True, True] and np.isfinite(history["loss"][0] + history["val_loss"][0])


def test_cli_device_augs_on_inria(inria_dirs, tmp_path, monkeypatch):
    """``-d inria --device-augs`` on the 120 x 120 tiles (the tiled dataset's
    target shape cut to match): raw tiles and the INRIA pipeline."""
    from segtpu_torch.augment.device import inria_train_pipeline
    seen, _ = _device_aug_spy(monkeypatch, inria_train_pipeline)
    monkeypatch.setattr(inria, "TiledImagesDataset",
                        lambda *a, target_shape, **k: TiledImagesDataset(
                            *a, target_shape=(120, 120), **k))
    argv = ["-m", "linknet34", "-d", "inria", "-dd", str(inria_dirs[0]), "-p", "64", "-b", "2",
            "-l", "bce_jaccard", "-o", "adam", "-lr", "1e-4", "-e", "1", "-s", "2",
            "--device-augs", "--no-tensorboard", "--light-logging", "--device", "cpu",
            "--experiments-dir", str(tmp_path / "experiments")]
    history = train_cli.main(argv)
    assert seen == [True, True] and np.isfinite(history["loss"][0] + history["val_loss"][0])


def _write_csv(path, val_iou):
    path.parent.mkdir(parents=True, exist_ok=True)
    rows = ["epoch,loss,val_loss,iou,accuracy,val_iou,val_accuracy"]
    rows += [f"{i},0.5,0.5,0.1,0.9,{v!r},0.9" for i, v in enumerate(val_iou)]
    path.write_text("\n".join(rows) + "\n")


def _bands(base, spread=0.02, epochs=10):
    """Three seeds' val_iou, each epoch rising from ``base``."""
    return {s: [base + 0.04 * i + spread * k for i in range(epochs)]
            for k, s in enumerate(ab_nuclei.RUN_SEEDS)}


@pytest.mark.parametrize("case,relation,ok", [
    ("overlap", "overlap", True), ("above", "above", True), ("below", "BELOW", False)])
def test_ab_band_rule_on_hand_made_csvs(tmp_path, case, relation, ok):
    ref = _bands(0.3)
    port = {"overlap": _bands(0.31), "above": _bands(0.4), "below": _bands(0.2)}[case]
    read = {}
    for source, runs in (("torch", ref), ("segtpu", _bands(0.305)), ("port", port)):
        for seed, values in runs.items():
            _write_csv(tmp_path / f"{source}_s{seed}.csv", values)
        read[source] = {s: ab_nuclei.read_val_iou(tmp_path / f"{source}_s{s}.csv") for s in runs}
    verdict = ab_nuclei.compare(read["port"], read["torch"], read["segtpu"])
    assert verdict["ok"] is ok and verdict["epochs"] == 10
    assert {r["relation"] for r in verdict["rows"]} == {relation}
    assert verdict["delta_vs_torch"] == pytest.approx(
        np.mean([v[-1] for v in port.values()]) - np.mean([v[-1] for v in ref.values()]))
    # a band below only in the first half passes; a short leg fails
    first_half = {s: v[:5] + ref[s][5:] for s, v in _bands(0.0).items()}
    assert ab_nuclei.compare(first_half, read["torch"], read["segtpu"])["ok"]
    short = {s: v[:9] for s, v in read["port"].items()}
    assert not ab_nuclei.compare(short, read["torch"], read["segtpu"])["ok"]


def test_ab_run_writes_the_comparison(tmp_path, monkeypatch):
    """``run`` end to end with legs that write hand-made CSVs in place of
    training: the fixture, one leg per config and seed with segtpu's flags,
    under TF32 off and deterministic cuDNN (restored after), the port's CSVs
    and comparison.md; the reference CSVs from ``reference``."""
    legs, flags = [], set()
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.deterministic)

    def fake_leg(argv, model):
        legs.append(argv)
        flags.add((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
                   torch.backends.cudnn.deterministic))
        loss = argv[argv.index("-l") + 1]
        seed = int(argv[argv.index("--seed") + 1])
        base = 0.0 if model == "zf_unet" else 0.6
        values = _bands(base)[seed]
        _write_csv(ab_nuclei.csv_path(argv[argv.index("--experiments-dir") + 1], model, loss),
                   values)

    monkeypatch.setattr(ab_nuclei, "write_init", lambda model, seed, path: None)
    monkeypatch.setattr(ab_nuclei, "FIXTURE_IMAGES", 2)
    out = tmp_path / "out"
    reference = tmp_path / "reference"
    shutil.copytree(ab_nuclei.REFERENCE_DIR, reference)
    verdicts = ab_nuclei.run(tmp_path / "work", out, run_leg=fake_leg, card="test card",
                             reference=reference)
    assert len(legs) == 6 and all("--device" not in a for a in legs)
    assert flags == {(False, False, True)}
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.deterministic) == before
    flags = legs[0][:legs[0].index("--seed")]
    assert flags == ["-m", "zf_unet", "-d", "dsb2018", "-dd",
                     str(tmp_path / "work" / "data" / "dsb2018"), "-p", "128", "-b", "8", "-l",
                     "bce", "-o", "sgd", "-lr", "1e-3", "-e", "10"]
    assert len(os.listdir(tmp_path / "work" / "data" / "dsb2018" / "images")) == 2
    assert sorted(os.listdir(out)) == sorted(
        ["comparison.md"] + [f"port_{m}_s{s}.csv" for m in ("zf_unet", "linknet34")
                             for s in ab_nuclei.RUN_SEEDS])
    text = (out / "comparison.md").read_text()
    assert "## zf_unet (bce + sgd, lr 1e-3)" in text and "test card" in text
    committed = ab_nuclei.read_val_iou(ab_nuclei.REFERENCE_DIR / "torch_zf_unet_s20260819.csv")
    assert verdicts["zf_unet"]["rows"][9]["torch"][0] <= committed[9]
    assert not verdicts["zf_unet"]["ok"] and verdicts["linknet34"]["ok"]


def test_ab_init_draws_the_reference_distribution(tmp_path):
    """linknet34's encoder convs from kaiming_normal_(fan_out, relu), its
    decoder and every zf_unet conv from U(+-1/sqrt(fan_in)); a seed each."""
    paths = [tmp_path / f"init_s{s}.pth" for s in (1, 2)]
    for seed, path in zip((1, 2), paths):
        ab_nuclei.write_init("linknet34", seed, path)
    a, b = (torch.load(p, weights_only=True) for p in paths)
    w = a["encoder3.0.conv1.weight"]  # 256 x 128 x 3 x 3
    assert w.std().item() == pytest.approx(np.sqrt(2 / (256 * 9)), rel=0.05)
    assert w.mean().abs().item() < 0.1 * w.std().item()
    assert a["firstconv.weight"].std().item() == pytest.approx(np.sqrt(2 / (64 * 49)), rel=0.05)
    assert a["firstbn.weight"].eq(1).all() and a["firstbn.bias"].eq(0).all()
    d = a["decoder4.conv1.weight"]  # 128 x 512 x 1 x 1
    assert d.abs().max().item() <= 1 / np.sqrt(512)
    assert d.abs().max().item() > 0.9 / np.sqrt(512)
    assert not torch.equal(w, b["encoder3.0.conv1.weight"])
    assert set(a) == set(b)
