"""The port's client partitions (idc_models_tpu_torch/data/partition.py)
against the JAX package's data/partition.py, bit for bit."""

from __future__ import annotations

import numpy as np
import pytest

from idc_models_tpu.data import idc as jidc
from idc_models_tpu.data import partition as jpart
from idc_models_tpu.data import synthetic as jsynthetic
from idc_models_tpu_torch.data import idc as tidc
from idc_models_tpu_torch.data import partition as tpart


@pytest.mark.parametrize("iid", [True, False])
@pytest.mark.parametrize("n,clients,seed", [(100, 10, 0), (103, 7, 3),
                                            (64, 1, 1)])
def test_partition_clients_bit_identical(iid, n, clients, seed):
    imgs, labels = jsynthetic.make_idc_like(n, size=6, seed=seed)
    want = jpart.partition_clients(jidc.ArrayDataset(imgs, labels), clients,
                                   iid=iid, seed=seed)
    got = tpart.partition_clients(tidc.ArrayDataset(imgs, labels), clients,
                                  iid=iid, seed=seed)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_partition_clients_refusals_match_jax():
    ds = tidc.ArrayDataset(np.zeros((3, 2, 2, 3)), np.zeros(3, np.int32))
    jds = jidc.ArrayDataset(ds.images, ds.labels)
    for clients in (0, 4):
        with pytest.raises(ValueError) as want:
            jpart.partition_clients(jds, clients, iid=True)
        with pytest.raises(ValueError) as got:
            tpart.partition_clients(ds, clients, iid=True)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("clients,frac,seed", [(10, 0.2, 0), (10, 0.2, 5),
                                               (7, 0.3, 1), (3, 0.01, 2)])
def test_train_test_client_split_bit_identical(clients, frac, seed):
    got = tpart.train_test_client_split(clients, frac, seed=seed)
    want = jpart.train_test_client_split(clients, frac, seed=seed)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    with pytest.raises(ValueError, match="leaves no training clients"):
        tpart.train_test_client_split(2, 0.9)


@pytest.mark.parametrize("multiple", [1, 4, 8])
def test_pad_clients_bit_identical(multiple):
    rng = np.random.default_rng(0)
    imgs = rng.random((10, 5, 4, 4, 3)).astype(np.float32)
    labels = rng.integers(0, 2, (10, 5)).astype(np.int32)
    w1, w2 = np.arange(10, dtype=np.float32), np.ones(10)
    got = tpart.pad_clients(imgs, labels, w1, w2, multiple=multiple)
    want = jpart.pad_clients(imgs, labels, w1, w2, multiple=multiple)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
