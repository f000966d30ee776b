"""IDC directory-tree image loader.

The counterpart of ``idc_models_tpu/data/idc.py``: a labeled dataset is
built from ``<root>/<label>/<file>.png`` where the label is the parent
directory name ('0'/'1'); images decode to float32 in [0, 1] and are
resized with the same half-pixel bilinear. The file list is sorted,
shuffled once with a seed, and the split is materialized, so a seed
gives the same examples and the same split as the JAX package.

Two decode backends, as in the JAX package: "native" (the C++/libpng
loader of ``data/native``, built at first use) and "pil" (a Python
thread pool); "auto" takes native when it builds, else PIL. PIL is
imported only when it decodes a file. numpy only: the spawned decode
workers of ``pipeline.FileStream`` import this module, never torch.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np


@dataclasses.dataclass(frozen=True)
class ArrayDataset:
    """An in-memory labeled image dataset (NHWC float32 in [0,1])."""

    images: np.ndarray
    labels: np.ndarray

    def __post_init__(self):
        if len(self.images) != len(self.labels):
            raise ValueError(f"{len(self.images)} images but "
                             f"{len(self.labels)} labels")

    def __len__(self) -> int:
        return len(self.images)

    def take(self, n: int) -> "ArrayDataset":
        return ArrayDataset(self.images[:n], self.labels[:n])

    def skip(self, n: int) -> "ArrayDataset":
        return ArrayDataset(self.images[n:], self.labels[n:])

    def shard(self, num_shards: int, index: int) -> "ArrayDataset":
        """Strided shard, matching tf.data `Dataset.shard` semantics
        (used for secure-fed clients, secure_fed_model.py:206-210)."""
        return ArrayDataset(self.images[index::num_shards],
                            self.labels[index::num_shards])

    def shuffled(self, seed: int) -> "ArrayDataset":
        perm = np.random.default_rng(seed).permutation(len(self))
        return ArrayDataset(self.images[perm], self.labels[perm])


def list_labeled_files(root: str | os.PathLike,
                       pattern: str = "*/*.png") -> list[tuple[str, int]]:
    """Sorted (path, label) pairs; label = parent directory name == '1'."""
    files = sorted(Path(root).glob(pattern))
    return [(str(f), int(f.parent.name == "1")) for f in files
            if f.parent.name in ("0", "1")]


def _decode_one(path: str, size: int) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"), np.float32) / 255.0
    if arr.shape[:2] != (size, size):
        arr = _resize_bilinear(arr, size)
    return arr


def _resize_bilinear(arr: np.ndarray, size: int) -> np.ndarray:
    """Naive bilinear with half-pixel centers (``tf.image.resize``'s
    default, antialias off), as the JAX package resizes."""
    h, w = arr.shape[:2]
    fy = np.maximum((np.arange(size) + 0.5) * (h / size) - 0.5, 0.0)
    fx = np.maximum((np.arange(size) + 0.5) * (w / size) - 0.5, 0.0)
    y0 = fy.astype(np.int32)
    x0 = fx.astype(np.int32)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (fy - y0).astype(np.float32)[:, None, None]
    wx = (fx - x0).astype(np.float32)[None, :, None]
    top = arr[y0][:, x0] * (1 - wx) + arr[y0][:, x1] * wx
    bot = arr[y1][:, x0] * (1 - wx) + arr[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def load_directory(root: str | os.PathLike, *, image_size: int = 50,
                   limit: int | None = None, seed: int = 0,
                   workers: int = 16, backend: str = "auto") -> ArrayDataset:
    """Load the ``<root>/<label>/*.png`` tree into an ArrayDataset.

    The file list is shuffled once with `seed` before the optional
    `limit` is applied ("first N of a shuffled list"). `backend`:
    "native", "pil" or "auto" (native when it builds, else pil)."""
    pairs = list_shuffled_pairs(root, seed=seed, limit=limit)
    labels = np.asarray([l for _, l in pairs], np.int32)
    return ArrayDataset(decode_pairs(pairs, image_size, workers=workers,
                                     backend=backend), labels)


def list_shuffled_pairs(root: str | os.PathLike, *, seed: int = 0,
                        limit: int | None = None) -> list[tuple[str, int]]:
    """The loaders' shared preamble: list the labeled tree, shuffle once
    with `seed`, apply the optional subset `limit`."""
    pairs = list_labeled_files(root)
    if not pairs:
        raise FileNotFoundError(f"no <label>/*.png files under {root}")
    order = np.random.default_rng(seed).permutation(len(pairs))
    pairs = [pairs[i] for i in order]
    return pairs[:limit] if limit is not None else pairs


def decode_pairs(pairs: list[tuple[str, int]], image_size: int, *,
                 workers: int = 16, backend: str = "auto",
                 pool=None) -> np.ndarray:
    """Decode (path, label) pairs to a float32 [n, s, s, 3] batch: the
    one decode entry point of the materializing loader and the streaming
    one (`pipeline.FileStream`); `backend` as in `load_directory`.
    `pool` (a zero-arg callable returning a live executor) lets
    per-batch callers reuse one thread pool on the PIL path."""
    if backend not in ("auto", "native", "pil"):
        raise ValueError(f"backend must be auto|native|pil, got {backend!r}")
    if not pairs:
        return np.zeros((0, image_size, image_size, 3), np.float32)
    if backend in ("auto", "native"):
        from idc_models_tpu_torch.data import native

        if native.available():
            return native.decode_batch([p for p, _ in pairs], image_size,
                                       threads=workers)
        if backend == "native":
            raise RuntimeError(native.build_error())
    job = lambda p: _decode_one(p[0], image_size)
    if pool is not None:
        imgs = list(pool().map(job, pairs))
    else:
        with ThreadPoolExecutor(max_workers=workers) as ex:
            imgs = list(ex.map(job, pairs))
    return np.stack(imgs)


_TASK_POOL: list = [None, 0]  # [executor, max_workers], per process


def _task_pool(workers: int):
    """A persistent thread pool per decode worker process for
    `decode_task`'s PIL path, so a worker does not build and tear down a
    pool per batch."""
    if _TASK_POOL[0] is None or _TASK_POOL[1] != workers:
        if _TASK_POOL[0] is not None:
            _TASK_POOL[0].shutdown(wait=False)
        _TASK_POOL[0] = ThreadPoolExecutor(max_workers=workers)
        _TASK_POOL[1] = workers
    return _TASK_POOL[0]


def decode_worker_init():
    """Decode workers never touch the card: hide it from any torch a
    worker might import, before anything could claim it."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""


def decode_task(args):
    """Worker-process entry of `pipeline.FileStream`'s multi-process
    decode: one whole batch per task, through the same `decode_pairs`
    call a single-process stream makes."""
    pairs, image_size, backend, workers = args
    return decode_pairs(pairs, image_size, workers=workers,
                        backend=backend,
                        pool=lambda: _task_pool(workers))


def train_val_test_split(ds: ArrayDataset,
                         fractions: tuple[float, float, float] = (0.8, 0.1, 0.1),
                         *, seed: int | None = None,
                         ) -> tuple[ArrayDataset, ArrayDataset, ArrayDataset]:
    """Deterministic materialized 80/10/10 split (shuffled first when
    `seed` is given), the JAX package's take/skip scheme."""
    if seed is not None:
        ds = ds.shuffled(seed)
    n = len(ds)
    n_train = int(fractions[0] * n)
    n_val = int(fractions[1] * n)
    train = ds.take(n_train)
    val = ds.skip(n_train).take(n_val)
    test = ds.skip(n_train + n_val)
    return train, val, test
