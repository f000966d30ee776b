"""Host -> device input pipeline: batching, shuffling, and transfer.

The counterpart of ``idc_models_tpu/data/pipeline.py``: ``Loader`` over
a materialized dataset and ``FileStream`` over a file list share one
schedule (`_EpochSchedule`). Each epoch's order is a fresh seeded
permutation keyed by ``(seed, epoch)`` for the first pass and
``(seed, epoch, rep)`` for extra passes -- the JAX package's contract,
so a seed gives the same batch order in both packages. ``to_device``
copies batches from pinned host memory with ``non_blocking=True`` and
keeps the next batch's copy in flight while the current one is used;
``prefetch_to_mesh`` does so with this rank's rows of each batch, and
``pad_to_multiple`` pads an eval batch to divide the mesh.
"""

from __future__ import annotations

import collections
import copy
import itertools
import multiprocessing as mp
from collections.abc import Iterable, Iterator
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from idc_models_tpu_torch.data import idc
from idc_models_tpu_torch.data.idc import ArrayDataset


class _EpochSchedule:
    """The shared batching/shuffle/repeat schedule: the seeding contract
    ((seed, epoch) for pass 0, (seed, epoch, rep) for extra passes) lives
    only here, so `Loader` and `FileStream` give bit-identical streams.

    - `shuffle`: a new seeded permutation each epoch (epoch mixed into
      the seed)
    - `drop_remainder`: drop the final partial batch (training)
    - `repeat`: passes over the dataset per epoch, each freshly shuffled

    Subclasses define `_num_examples()` and `_gather(idx) -> batch`."""

    def __init__(self, batch_size: int, *, shuffle: bool = True,
                 seed: int = 0, drop_remainder: bool = True,
                 repeat: int = 1):
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.repeat = repeat
        self._validate()

    def _validate(self) -> None:
        if self.batch_size <= 0:
            raise ValueError("batch_size must be positive")
        if self.repeat < 1:
            raise ValueError(f"repeat must be >= 1, got {self.repeat}")
        n = self._num_examples()
        if n < self.batch_size and self.drop_remainder:
            raise ValueError(
                f"dataset of {n} examples yields zero batches of "
                f"size {self.batch_size} with drop_remainder")

    def _num_examples(self) -> int:
        raise NotImplementedError

    def _gather(self, idx: np.ndarray):
        raise NotImplementedError

    def replace(self, **kw) -> "_EpochSchedule":
        """A copy with schedule knobs replaced (seed, repeat, ...): `fit`
        imposes its per-phase schedule on a caller-built stream this way.
        Validates again, as the constructor does."""
        new = copy.copy(self)
        for k, v in kw.items():
            if not hasattr(new, k):
                raise AttributeError(f"{type(self).__name__} has no {k!r}")
            setattr(new, k, v)
        new._validate()
        return new

    def __len__(self) -> int:
        n = self._num_examples()
        per_pass = (n // self.batch_size if self.drop_remainder
                    else -(-n // self.batch_size))
        return per_pass * self.repeat

    def _index_batches(self, epoch: int) -> Iterator[np.ndarray]:
        """Per-batch index arrays, deterministic in (seed, epoch): the one
        place the batch order is defined."""
        n = self._num_examples()
        stop = (n // self.batch_size * self.batch_size
                if self.drop_remainder else n)
        for rep in range(self.repeat):
            if self.shuffle:
                key = (self.seed, epoch) if rep == 0 else (self.seed, epoch, rep)
                order = np.random.default_rng(key).permutation(n)
            else:
                order = np.arange(n)
            for i in range(0, stop, self.batch_size):
                yield order[i:i + self.batch_size]

    def epoch(self, epoch: int = 0) -> Iterator:
        for idx in self._index_batches(epoch):
            yield self._gather(idx)


class Loader(_EpochSchedule):
    """Iterates (images, labels) numpy batches of a materialized
    ArrayDataset over epochs (see `_EpochSchedule` for the knobs)."""

    def __init__(self, ds: ArrayDataset, batch_size: int, **kw):
        self.ds = ds
        super().__init__(batch_size, **kw)

    def _num_examples(self) -> int:
        return len(self.ds)

    def _gather(self, idx):
        return self.ds.images[idx], self.ds.labels[idx]


class FileStream(_EpochSchedule):
    """Loader-shaped iterator that decodes image files per batch instead
    of materializing the dataset in host memory (``--stream``).

    Each epoch permutes the FILE list with `Loader`'s schedule and
    decodes each batch on demand (the native C++/libpng decoder when it
    builds, one persistent thread pool on the PIL path), so streaming a
    directory and training on its materialized ArrayDataset (same pair
    order) give bit-identical batch streams. With ``decode_workers`` > 0
    whole batches fan out to that many worker processes (started with
    ``spawn``: the parent holds a CUDA context that must not be forked).
    """

    def __init__(self, pairs: list[tuple[str, int]], image_size: int,
                 batch_size: int, *, workers: int = 16,
                 backend: str = "auto", decode_workers: int = 0, **kw):
        if not pairs:
            raise ValueError("FileStream needs a non-empty file list")
        self.pairs = list(pairs)
        self.image_size = image_size
        self.workers = workers
        self.backend = backend
        self.decode_workers = decode_workers
        # lazy persistent pools, boxed so replace()'s shallow copies
        # share ONE pool instead of each leaking their own
        self._pool_box: list = [None]       # PIL thread pool
        self._proc_box: list = [None]       # decode worker processes
        super().__init__(batch_size, **kw)

    def _num_examples(self) -> int:
        return len(self.pairs)

    def _gather(self, idx):
        batch = [self.pairs[j] for j in idx]
        labels = np.asarray([l for _, l in batch], np.int32)
        return idc.decode_pairs(batch, self.image_size, workers=self.workers,
                                backend=self.backend,
                                pool=self._pil_pool), labels

    def _pil_pool(self):
        if self._pool_box[0] is None:
            self._pool_box[0] = ThreadPoolExecutor(max_workers=self.workers)
        return self._pool_box[0]

    def epoch(self, epoch: int = 0) -> Iterator:
        """With ``decode_workers`` > 0, whole batches go round-robin to N
        persistent worker processes, each decoding with the same
        `decode_pairs` call a single-process stream makes, while the
        parent consumes earlier batches in order: the two streams are
        bit-identical. At most 2N decoded batches exist at once (a
        bounded window, not ``Pool.imap``, whose feeder would buffer the
        whole epoch)."""
        if not self.decode_workers:
            yield from super().epoch(epoch)
            return
        pool = self._proc_pool()
        it = self._index_batches(epoch)
        inflight: collections.deque = collections.deque()

        def submit(n):
            for idx in itertools.islice(it, n):
                task = ([self.pairs[j] for j in idx], self.image_size,
                        self.backend, self.workers)
                inflight.append(
                    (idx, pool.apply_async(idc.decode_task, (task,))))

        submit(2 * self.decode_workers)
        while inflight:
            idx, fut = inflight.popleft()
            images = fut.get()
            labels = np.asarray([self.pairs[j][1] for j in idx], np.int32)
            yield images, labels
            submit(1)

    def _proc_pool(self):
        if self._proc_box[0] is None:
            ctx = mp.get_context("spawn")
            self._proc_box[0] = ctx.Pool(self.decode_workers,
                                         initializer=idc.decode_worker_init)
        return self._proc_box[0]

    def close(self) -> None:
        """Shut the decode pools down (a no-op if never started). Copies
        made by replace() share them, so close the stream only when no
        copy is iterating; unclosed pools live until the process exits."""
        pool, self._pool_box[0] = self._pool_box[0], None
        if pool is not None:
            pool.shutdown(wait=False)
        procs, self._proc_box[0] = self._proc_box[0], None
        if procs is not None:
            procs.terminate()
            procs.join()


def eval_batches(ds: ArrayDataset, batch_size: int, *,
                 steps: int | None = None) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Batches of `ds` in order, final batch partial, at most `steps` of
    them (None: all) -- every example counted once."""
    loader = Loader(ds, batch_size, shuffle=False, drop_remainder=False)
    for i, batch in enumerate(loader.epoch(0)):
        if steps is not None and i >= steps:
            return
        yield batch


def _put(arrays, device: torch.device):
    out = []
    for a in arrays:
        # float64 host data goes over as float32, as jax.device_put
        # narrows it without x64 (make_idc_like's patches are float64)
        a = np.ascontiguousarray(a, np.float32 if a.dtype == np.float64
                                 else None)
        t = torch.from_numpy(a)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out.append(t)
    return tuple(out)


# batches whose host->device copies are in flight ahead of the consumer
_PREFETCH = 2


def to_device(batches: Iterable, device: torch.device
              ) -> Iterator[tuple[torch.Tensor, ...]]:
    """Move host batches to `device`, keeping up to _PREFETCH copies in
    flight ahead of the consumer (pinned memory + non_blocking on CUDA;
    on the CPU the tensors share the numpy buffers)."""
    pending: collections.deque = collections.deque()
    for batch in batches:
        pending.append(_put(batch, device))
        if len(pending) >= _PREFETCH:
            yield pending.popleft()
    while pending:
        yield pending.popleft()


def prefetch_to_mesh(batches: Iterable, mesh, *, axis: str | None = None,
                     device: torch.device | None = None
                     ) -> Iterator[tuple[torch.Tensor, ...]]:
    """This rank's rows of each host batch, split over the mesh's batch
    axis (`axis`, default "data"), on `device` (the CPU when None), with
    `to_device`'s copies in flight ahead of the consumer. Every rank
    reads the same global batches (a seeded schedule)."""
    from idc_models_tpu_torch import mesh as meshlib

    sh = meshlib.sharding(mesh, meshlib.batch_axis(mesh, axis))
    local = (tuple(meshlib.put_with_sharding(np.asarray(a), sh).numpy()
                   for a in batch) for batch in batches)
    return to_device(local, device or torch.device("cpu"))


def pad_to_multiple(images: np.ndarray, labels: np.ndarray,
                    multiple: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad a final partial batch up to `multiple` rows with zeros,
    returning (images, labels, mask of the real rows): the eval loops see
    every example once while the batch still divides the mesh."""
    n = len(images)
    pad = (-n) % multiple
    if pad == 0:
        return images, labels, np.ones(n, bool)
    images = np.concatenate([images, np.zeros((pad,) + images.shape[1:],
                                              images.dtype)])
    labels = np.concatenate([labels, np.zeros((pad,) + labels.shape[1:],
                                              labels.dtype)])
    mask = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    return images, labels, mask
