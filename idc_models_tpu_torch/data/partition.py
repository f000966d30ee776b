"""Federated client partitioning: IID / non-IID shards.

The counterpart of ``idc_models_tpu/data/partition.py`` (numpy only, so
the outputs are the JAX package's bit for bit). Capability parity with the reference's `get_data` + client sharding
(C9/C10): IID = globally shuffled examples cut into contiguous
equal-size client shards (fed_model.py:150-165); non-IID = all class-1
examples concatenated before class-0 so contiguous shards are label-skewed
(fed_model.py:161-165); secure-fed uses strided `shard(N, i)` instead
(secure_fed_model.py:206-210, available as `ArrayDataset.shard`).

Shards are materialized as a stacked [num_clients, client_size, ...] array
so the federated round takes every client's shard from one upload to the
card, deterministic per client.
"""

from __future__ import annotations

import numpy as np

from idc_models_tpu_torch.data.idc import ArrayDataset


def partition_clients(ds: ArrayDataset, num_clients: int, *, iid: bool,
                      seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Returns (images [C, S, H, W, 3], labels [C, S]) client shards.

    S = len(ds) // num_clients; surplus examples are dropped (the
    reference's CLIENT_SIZE arithmetic, fed_model.py:58).
    """
    if num_clients <= 0:
        raise ValueError("num_clients must be positive")
    n = len(ds)
    client_size = n // num_clients
    if client_size == 0:
        raise ValueError(f"{n} examples cannot feed {num_clients} clients")
    if iid:
        order = np.random.default_rng(seed).permutation(n)
    else:
        # class-1 first, then class-0, each deterministically shuffled
        # within class — contiguous shards become label-skewed.
        rng = np.random.default_rng(seed)
        pos = np.flatnonzero(ds.labels == 1)
        neg = np.flatnonzero(ds.labels != 1)
        order = np.concatenate([rng.permutation(pos), rng.permutation(neg)])
    order = order[:client_size * num_clients]
    idx = order.reshape(num_clients, client_size)
    return ds.images[idx], ds.labels[idx]


def train_test_client_split(num_clients: int, test_fraction: float = 0.2,
                            *, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Split client *ids* into train/test populations (fed_model.py:47-49)."""
    ids = np.random.default_rng(seed).permutation(num_clients)
    n_test = max(1, int(round(test_fraction * num_clients)))
    if n_test >= num_clients:
        raise ValueError(
            f"test_fraction {test_fraction} leaves no training clients "
            f"out of {num_clients} — every round would be a no-op")
    return np.sort(ids[n_test:]), np.sort(ids[:n_test])


def pad_clients(images: np.ndarray, labels: np.ndarray, *weights: np.ndarray,
                multiple: int) -> tuple[np.ndarray, ...]:
    """Pad the client axis up to a multiple of the mesh size with
    weight-0 dummy clients (zero data). The round's failure-tolerant
    aggregation ignores zero-weight clients entirely, so padding lets
    any client count run on any device count (10 reference clients on an
    8-device mesh -> 16 shards, 2 per device, 6 of them inert).

    Every per-client weight vector travels through here together with
    the data (varargs), so no caller can pad them inconsistently.
    Returns (images, labels, *weights) padded to the same client count.
    """
    c = images.shape[0]
    pad = (-c) % multiple
    if pad == 0:
        return (images, labels) + tuple(
            np.asarray(w, np.float32) for w in weights)
    images = np.concatenate(
        [images, np.zeros((pad,) + images.shape[1:], images.dtype)])
    labels = np.concatenate(
        [labels, np.zeros((pad,) + labels.shape[1:], labels.dtype)])
    padded_w = tuple(
        np.concatenate([np.asarray(w, np.float32),
                        np.zeros((pad,), np.float32)]) for w in weights)
    return (images, labels) + padded_w
