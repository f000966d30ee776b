"""CIFAR-10 loader for the ``dense`` preset.

The counterpart of ``idc_models_tpu/data/cifar10.py``. The reference
pulls CIFAR-10 through tfds at run time and scales by /255; with no
network, the order is:

1. a local copy beneath `root`: ``cifar10.npz`` (``x_train``/``y_train``,
   ``x_test``/``y_test``), else the python-pickled batches under
   ``cifar-10-batches-py/``;
2. a synthetic stand-in (``make_cifar_like``, with a warning), seeded
   ``2 * seed + 1`` for the test split and ``2 * seed`` for train, so a
   synthetic test set never holds the training images.
"""

from __future__ import annotations

import pickle
import warnings
from pathlib import Path

import numpy as np

from idc_models_tpu_torch.data import synthetic
from idc_models_tpu_torch.data.idc import ArrayDataset

NUM_CLASSES = 10

_SPLITS = ("train", "test")


def load_cifar10(root: str | None = None, *, split: str = "train",
                 synthetic_size: int = 2048,
                 seed: int = 0) -> ArrayDataset:
    if split not in _SPLITS:
        raise ValueError(f"split must be one of {_SPLITS}, got {split!r} "
                         "(carve validation out of 'train' with "
                         "train_val_test_split)")
    if root is not None:
        found = _find_local(Path(root), split)
        if found is not None:
            return found
    warnings.warn(
        "CIFAR-10 not found locally; using a synthetic stand-in "
        "(class-dependent mean shift). Pass root=<dir containing "
        "cifar-10-batches-py or cifar10.npz> for the real dataset.",
        stacklevel=2)
    imgs, labels = synthetic.make_cifar_like(
        synthetic_size, seed=2 * seed + (1 if split == "test" else 0))
    return ArrayDataset(imgs, labels)


def _find_local(root: Path, split: str) -> ArrayDataset | None:
    npz = root / "cifar10.npz"
    if npz.exists():
        with np.load(npz) as z:
            x = z[f"x_{split}"].astype(np.float32) / 255.0
            y = z[f"y_{split}"].astype(np.int32).reshape(-1)
            return ArrayDataset(x, y)
    batches_dir = root / "cifar-10-batches-py"
    if batches_dir.exists():
        names = ([f"data_batch_{i}" for i in range(1, 6)]
                 if split == "train" else ["test_batch"])
        xs, ys = [], []
        for name in names:
            # the dataset's own pickle format; read only from a local
            # copy the user points `root` at
            with open(batches_dir / name, "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(d[b"data"])
            ys.append(np.asarray(d[b"labels"], np.int32))
        x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return ArrayDataset(x.astype(np.float32) / 255.0, np.concatenate(ys))
    return None
