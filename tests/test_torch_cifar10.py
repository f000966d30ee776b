"""The port's CIFAR-10 loader and CIFAR-like stand-in (data/cifar10.py,
data/synthetic.py) against the JAX package's, bit for bit: a local npz,
the pickled python batches, and the synthetic fallback."""

from __future__ import annotations

import pickle

import numpy as np
import pytest

from idc_models_tpu.data import cifar10 as jcifar
from idc_models_tpu.data import synthetic as jsynthetic
from idc_models_tpu_torch.data import cifar10 as tcifar
from idc_models_tpu_torch.data import synthetic as tsynthetic


def _assert_same(got, want):
    assert got.images.dtype == want.images.dtype
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.labels.dtype == want.labels.dtype


@pytest.mark.parametrize("n,seed,classes", [(7, 0, 10), (64, 3, 10),
                                            (5, 1, 4)])
def test_make_cifar_like_matches_jax(n, seed, classes):
    got = tsynthetic.make_cifar_like(n, seed=seed, num_classes=classes)
    want = jsynthetic.make_cifar_like(n, seed=seed, num_classes=classes)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("split", ["train", "test"])
def test_synthetic_fallback_matches_jax(tmp_path, split):
    """No local copy: a warned stand-in, seeded 2*seed (+1 for test)."""
    with pytest.warns(UserWarning, match="CIFAR-10 not found"):
        got = tcifar.load_cifar10(str(tmp_path), split=split,
                                  synthetic_size=40, seed=3)
    with pytest.warns(UserWarning, match="CIFAR-10 not found"):
        want = jcifar.load_cifar10(str(tmp_path), split=split,
                                   synthetic_size=40, seed=3)
    _assert_same(got, want)
    with pytest.warns(UserWarning):
        other = tcifar.load_cifar10(None, split="test" if split == "train"
                                    else "train", synthetic_size=40, seed=3)
    assert not np.array_equal(other.images, got.images)


@pytest.mark.parametrize("split", ["train", "test"])
def test_local_npz_matches_jax(tmp_path, split):
    rng = np.random.default_rng(0)
    np.savez(tmp_path / "cifar10.npz",
             x_train=rng.integers(0, 256, (6, 32, 32, 3), np.uint8),
             y_train=rng.integers(0, 10, (6, 1), np.uint8),
             x_test=rng.integers(0, 256, (3, 32, 32, 3), np.uint8),
             y_test=rng.integers(0, 10, (3, 1), np.uint8))
    _assert_same(tcifar.load_cifar10(str(tmp_path), split=split),
                 jcifar.load_cifar10(str(tmp_path), split=split))


@pytest.mark.parametrize("split", ["train", "test"])
def test_pickled_batches_match_jax(tmp_path, split):
    """The python pickles: rows of 3072 bytes, channel-major (CHW)."""
    rng = np.random.default_rng(1)
    d = tmp_path / "cifar-10-batches-py"
    d.mkdir()
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(d / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (2, 3072), np.uint8),
                         b"labels": list(rng.integers(0, 10, 2))}, f)
    got = tcifar.load_cifar10(str(tmp_path), split=split)
    _assert_same(got, jcifar.load_cifar10(str(tmp_path), split=split))
    assert got.images.shape == ((10 if split == "train" else 2), 32, 32, 3)


def test_unknown_split_raises():
    with pytest.raises(ValueError, match="train_val_test_split"):
        tcifar.load_cifar10(None, split="val")
