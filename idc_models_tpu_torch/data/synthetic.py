"""Synthetic IDC-like, sequence and CIFAR-like data for tests, benchmarks, and
smoke runs.

Verbatim copies of ``idc_models_tpu/data/synthetic.py``'s
``make_idc_like``, ``make_sequence_task`` and ``make_cifar_like`` (numpy
only), so the same seed gives the same data in both packages. Positive IDC patches get a
brighter center blob (a cartoon of IDC nuclei density), CIFAR-like
images a class-dependent mean shift, so a model can demonstrably learn.
"""

from __future__ import annotations

import numpy as np


def make_idc_like(n: int, size: int = 50, *, seed: int = 0,
                  pos_fraction: float = 0.5) -> tuple[np.ndarray, np.ndarray]:
    """Returns (images [n,size,size,3] float32 in [0,1], labels [n] int32)."""
    rng = np.random.default_rng(seed)
    labels = (rng.random(n) < pos_fraction).astype(np.int32)
    imgs = rng.random((n, size, size, 3), dtype=np.float32) * 0.5
    yy, xx = np.mgrid[0:size, 0:size]
    c = (size - 1) / 2
    blob = np.exp(-(((yy - c) ** 2 + (xx - c) ** 2) / (2 * (size / 4) ** 2)))
    blob = blob[None, :, :, None].astype(np.float32)
    imgs = imgs + labels[:, None, None, None] * 0.4 * blob
    return np.clip(imgs, 0.0, 1.0), labels


def make_sequence_task(n: int, seq_len: int, features: int = 8, *,
                       seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Position-sensitive sequence task for the attention classifier:
    noise sequences with one marker spike on channel 0; label = whether
    the marker sits in the LATE half. GAP over raw inputs cannot solve
    it (the marker's value is position-independent) — the model must
    move positional information into the pooled features, which is
    exactly what attention + learned positions provide.

    Returns (x [n, seq_len, features] float32, labels [n] int32).
    """
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 0.3, (n, seq_len, features)).astype(np.float32)
    pos = rng.integers(0, seq_len, n)
    x[np.arange(n), pos, 0] += 3.0
    labels = (pos >= seq_len // 2).astype(np.int32)
    return x, labels


def make_cifar_like(n: int, *, seed: int = 0,
                    num_classes: int = 10) -> tuple[np.ndarray, np.ndarray]:
    """32x32x3 images with class-dependent mean shift, labels in [0, C)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, n).astype(np.int32)
    imgs = rng.random((n, 32, 32, 3), dtype=np.float32) * 0.6
    shift = (labels[:, None, None, None] / num_classes).astype(np.float32)
    imgs = np.clip(imgs + 0.4 * shift, 0.0, 1.0)
    return imgs, labels
