"""Host -> device input pipeline: batching, shuffling, and transfer.

The counterpart of ``idc_models_tpu/data/pipeline.py``'s ``Loader``.
Data lives in host RAM as numpy; each epoch's order is a fresh seeded
permutation keyed by ``(seed, epoch)`` for the first pass and
``(seed, epoch, rep)`` for extra passes -- the JAX package's contract,
so a seed gives the same batch order in both packages. ``to_device``
copies batches from pinned host memory with ``non_blocking=True`` and
keeps the next batch's copy in flight while the current one is used.
"""

from __future__ import annotations

import collections
from collections.abc import Iterable, Iterator

import numpy as np
import torch

from idc_models_tpu_torch.data.idc import ArrayDataset


class Loader:
    """Iterates (images, labels) numpy batches of an ArrayDataset.

    - `shuffle`: a new seeded permutation each epoch (epoch mixed into
      the seed)
    - `drop_remainder`: drop the final partial batch (training)
    - `repeat`: passes over the dataset per epoch, each freshly shuffled
    """

    def __init__(self, ds: ArrayDataset, batch_size: int, *,
                 shuffle: bool = True, seed: int = 0,
                 drop_remainder: bool = True, repeat: int = 1):
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        if repeat < 1:
            raise ValueError(f"repeat must be >= 1, got {repeat}")
        if len(ds) < batch_size and drop_remainder:
            raise ValueError(
                f"dataset of {len(ds)} examples yields zero batches of "
                f"size {batch_size} with drop_remainder")
        self.ds = ds
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.repeat = repeat

    def __len__(self) -> int:
        n = len(self.ds)
        per_pass = (n // self.batch_size if self.drop_remainder
                    else -(-n // self.batch_size))
        return per_pass * self.repeat

    def _index_batches(self, epoch: int) -> Iterator[np.ndarray]:
        """Per-batch index arrays, deterministic in (seed, epoch)."""
        n = len(self.ds)
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

    def epoch(self, epoch: int = 0) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        for idx in self._index_batches(epoch):
            yield self.ds.images[idx], self.ds.labels[idx]


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
