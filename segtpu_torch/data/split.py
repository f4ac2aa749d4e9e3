"""``train_test_split`` in numpy: the train/test split that segtpu's DSB2018
and INRIA datasets take from scikit-learn, which the port does not import.

For an integer ``random_state`` it gives scikit-learn's output (1.9,
``sklearn/model_selection/_split.py``): the same indices in the same order,
lists returned as lists and arrays as arrays. It follows scikit-learn's
sequence of draws on one ``np.random.RandomState``: ``ShuffleSplit``
permutes all samples once and takes the test set first;
``StratifiedShuffleSplit`` draws the per-class train counts, then the test
counts (``_approximate_mode``, ties broken by ``choice`` without
replacement), then one permutation per class, then one of train and one of
test.
"""

from __future__ import annotations

import math
import numbers

import numpy as np


def _is_fraction(size) -> bool:
    return isinstance(size, numbers.Real) and not isinstance(size, numbers.Integral)


def _split_sizes(n_samples: int, test_size):
    """(n_train, n_test): scikit-learn's parameter check of ``test_size``,
    then its ``_validate_shuffle_split`` with no ``train_size``."""
    if not ((_is_fraction(test_size) and 0 < test_size < 1)
            or (isinstance(test_size, numbers.Integral) and test_size >= 1)):
        raise ValueError("The 'test_size' parameter of train_test_split must be a float in the "
                         "range (0.0, 1.0), an int in the range [1, inf) or None. Got "
                         f"{test_size!r} instead.")
    if isinstance(test_size, numbers.Integral) and test_size >= n_samples:
        raise ValueError(f"test_size={test_size} should be either positive and smaller than the "
                         f"number of samples {n_samples} or a float in the (0, 1) range")
    n_test = math.ceil(test_size * n_samples) if _is_fraction(test_size) else test_size
    n_train = n_samples - n_test
    if n_train == 0:
        raise ValueError(f"With n_samples={n_samples}, test_size={test_size} and "
                         "train_size=None, the resulting train set will be empty. Adjust any "
                         "of the aforementioned parameters.")
    return int(n_train), int(n_test)


def _approximate_mode(class_counts: np.ndarray, n_draws: int, rng) -> np.ndarray:
    """scikit-learn's ``sklearn.utils.extmath._approximate_mode``: per-class
    draws near the mode of the multivariate hypergeometric, ties in the
    remainders broken at random."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def _stratified_indices(y, n_train: int, n_test: int, rng):
    y = np.asarray(y)
    if y.ndim == 2:
        y = np.array([" ".join(row.astype("str")) for row in y])
    classes, y_indices, class_counts = np.unique(y, return_inverse=True, return_counts=True)
    n_classes = classes.shape[0]
    if np.min(class_counts) < 2:
        few = classes[class_counts < 2].tolist()
        raise ValueError("The least populated classes in y have only 1 member, which is too "
                         "few. The minimum number of groups for any class cannot be less than "
                         f"2. Classes with too few members are: {few}")
    if n_train < n_classes:
        raise ValueError(f"The train_size = {n_train} should be greater or equal to the number "
                         f"of classes = {n_classes}")
    if n_test < n_classes:
        raise ValueError(f"The test_size = {n_test} should be greater or equal to the number "
                         f"of classes = {n_classes}")
    class_indices = np.split(np.argsort(y_indices, kind="stable"), np.cumsum(class_counts)[:-1])
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(n_classes):
        members = class_indices[i].take(rng.permutation(class_counts[i]), mode="clip")
        train.extend(members[:n_i[i]])
        test.extend(members[n_i[i]:n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def _take(a, indices):
    """Rows ``indices`` of ``a``: an array stays an array, anything else
    indexable becomes a list."""
    if hasattr(a, "shape"):
        return np.take(a, indices, axis=0)
    return [a[i] for i in indices]


def train_test_split(*arrays, test_size, random_state: int, stratify=None):
    """Split each of ``arrays`` (lists or arrays of one length) into train and
    test parts: ``[a_train, a_test, b_train, b_test, ...]``, as
    ``sklearn.model_selection.train_test_split`` with ``shuffle=True``.

    ``test_size``: a fraction in (0, 1) or a count; ``random_state``: the
    seed of the one ``np.random.RandomState``; ``stratify``: class labels
    that the split keeps in proportion."""
    if not arrays:
        raise ValueError("At least one array required as input")
    lengths = {len(a) for a in arrays}
    if len(lengths) > 1:
        raise ValueError("Found input variables with inconsistent numbers of samples: "
                         f"{[len(a) for a in arrays]}")
    n_samples = len(arrays[0])
    n_train, n_test = _split_sizes(n_samples, test_size)
    rng = np.random.RandomState(random_state)
    if stratify is None:
        permutation = rng.permutation(n_samples)
        test, train = permutation[:n_test], permutation[n_test:]
    else:
        if len(stratify) != n_samples:
            raise ValueError("Found input variables with inconsistent numbers of samples: "
                             f"{[n_samples, len(stratify)]}")
        train, test = _stratified_indices(stratify, n_train, n_test, rng)
    out = []
    for a in arrays:
        out += [_take(a, train), _take(a, test)]
    return out
