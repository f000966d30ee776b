"""Checkpoint / resume, as ``idc_models_tpu/train/checkpoint.py``.

A checkpoint is a directory holding one ``state.npz`` of the JAX-layout
tree (nested dicts keyed by layer name, leaves numpy arrays; flat
"a/b/c" keys inside the npz, read back with ``allow_pickle=False``), a
content digest in ``_IDC_DIGEST.json`` and the completion marker
``_IDC_COMPLETE``. The contracts are the JAX package's:

- a save is atomic: the tree is written into ``<path>.tmp``, the digest
  and then the marker go in last, and the directory is renamed into
  place, so a crash leaves the old complete checkpoint or a markerless
  partial, never a half-written tree;
- a directory without the marker is a torn partial: `checkpoint_exists`
  refuses it and `restore_checkpoint` raises;
- the digest is `_tree_digest`'s formula (sha256 over each leaf's
  ``(shape, dtype.str)`` and bytes, in JAX's flatten order: sorted keys
  at every level), so the same tree digests the same in both packages;
  a mismatch on restore raises ``ValueError``;
- `load_or_train` retrains over a torn or corrupt checkpoint, warning.

The JAX package writes with orbax; reading one of its checkpoints is not
ported here.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import warnings
import zipfile
from pathlib import Path
from typing import Any

import numpy as np
import torch

from idc_models_tpu_torch import convert

_COMPLETE_MARKER = "_IDC_COMPLETE"
_DIGEST_FILE = "_IDC_DIGEST.json"
_STATE_FILE = "state.npz"


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _leaves(tree) -> list:
    """The leaves of a nested dict in JAX's flatten order: sorted keys at
    every level."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


def _tree_digest(tree) -> str:
    """sha256 over every leaf's ``(shape, dtype.str)`` and raw bytes in
    JAX's flatten order, one leaf on the host at a time; a leaf without
    a shape hashes its repr. (``np.ascontiguousarray`` gives a 0-d leaf
    the shape (1,), in the JAX package's formula too.)"""
    h = hashlib.sha256()
    for leaf in _leaves(tree):
        if hasattr(leaf, "shape"):
            a = np.ascontiguousarray(_host(leaf))
            h.update(str((a.shape, a.dtype.str)).encode())
            h.update(a.tobytes())
        else:
            h.update(repr(leaf).encode())
    return h.hexdigest()


def checkpoint_exists(path: str | os.PathLike) -> bool:
    """True for a complete checkpoint: a directory without the completion
    marker is a torn partial left by a crash mid-save and is refused."""
    path = Path(path)
    if not path.exists():
        return False
    if path.is_dir():
        return (path / _COMPLETE_MARKER).exists()
    return True


def save_checkpoint(path: str | os.PathLike, tree) -> str:
    """Save a nested dict of arrays (numpy, torch tensors on any device,
    or Python scalars) to `path`, atomically: write ``<path>.tmp``, stamp
    the digest and the marker, then rename into place (an existing
    checkpoint is retired to ``<path>.old`` first, since a rename cannot
    replace a non-empty directory)."""
    path = Path(path).absolute()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)              # leftover from a crash
    tmp.mkdir()
    flat = {k: _host(v) for k, v in convert.flatten(tree).items()}
    with open(tmp / _STATE_FILE, "wb") as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    (tmp / _DIGEST_FILE).write_text(json.dumps({"sha256": _tree_digest(
        convert.unflatten(flat))}))
    (tmp / _COMPLETE_MARKER).touch()
    if path.exists():
        old = path.with_name(path.name + ".old")
        if old.exists():
            shutil.rmtree(old)
        os.replace(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old)
    else:
        os.replace(tmp, path)
    return str(path)


def _restore_onto(loaded, target, where: str):
    if not isinstance(target, dict):
        if isinstance(target, torch.Tensor):
            if tuple(loaded.shape) != tuple(target.shape):
                raise ValueError(f"{where}: shape {loaded.shape} does not "
                                 f"match the target's {tuple(target.shape)}")
            return torch.from_numpy(loaded).to(device=target.device,
                                               dtype=target.dtype)
        if isinstance(target, np.ndarray):
            return loaded.astype(target.dtype, copy=False)
        return type(target)(loaded)
    # a subtree without leaves (VGG16's empty BN state) leaves no key in
    # the npz, as it leaves no leaf in JAX's flatten
    want = {k for k in target if _leaves(target[k])}
    if not isinstance(loaded, dict) or set(loaded) != want:
        have = set(loaded) if isinstance(loaded, dict) else {"<leaf>"}
        raise ValueError(f"{where}: keys {sorted(have)[:5]} do not match "
                         f"the target's {sorted(want)[:5]}")
    return {k: (_restore_onto(loaded[k], target[k], f"{where}/{k}")
                if k in want else target[k]) for k in target}


def restore_checkpoint(path: str | os.PathLike, target=None):
    """Restore the tree saved at `path` into the structure of `target`
    (torch leaves come back on the target leaf's device and dtype, so a
    checkpoint saved from the card restores onto the CPU and the other
    way round); ``target=None`` returns the saved tree as numpy arrays.

    Refuses a torn partial (no completion marker) and a corrupt or
    incompatible checkpoint with a ``ValueError`` naming it: an
    unreadable file, a content digest that does not match the one
    recorded at save time, or a tree that does not fit `target`."""
    path = Path(path).absolute()
    if path.is_dir() and not (path / _COMPLETE_MARKER).exists():
        raise ValueError(
            f"checkpoint {path} has no completion marker -- a torn "
            f"partial left by a crash mid-save (delete it, or let "
            f"load_or_train retrain)")
    try:
        with (open(path / _STATE_FILE, "rb") as f,
              np.load(f, allow_pickle=False) as z):
            flat = {k: z[k] for k in z.files}
    except (OSError, ValueError, EOFError, zipfile.BadZipFile) as e:
        raise ValueError(
            f"checkpoint {path} failed to restore ({type(e).__name__}: "
            f"{e}) -- corrupt or incompatible on-disk state; delete it (or "
            f"let load_or_train retrain over it)") from e
    loaded = convert.unflatten(flat)
    digest_file = path / _DIGEST_FILE
    if digest_file.exists():
        want = json.loads(digest_file.read_text()).get("sha256")
        got = _tree_digest(loaded)
        if want != got:
            raise ValueError(
                f"checkpoint {path} is CORRUPT: restored content digest "
                f"{got[:12]}... does not match the digest recorded at save "
                f"time {str(want)[:12]}... (bit rot, truncation, or a "
                f"partial overwrite); delete it or let load_or_train "
                f"retrain")
    if target is None:
        return loaded
    return _restore_onto(loaded, target, str(path))


def load_or_train(path: str | os.PathLike, target, train_fn
                  ) -> tuple[Any, bool]:
    """Restore `path` if it holds a complete checkpoint, else run
    ``train_fn() -> tree``, save it and return it. Returns ``(tree,
    restored)``. A torn partial at `path` is retrained over with a
    warning; so is a checkpoint that looks complete but fails to restore
    (corruption costs a retrain, never a run on garbage weights)."""
    if checkpoint_exists(path):
        try:
            return restore_checkpoint(path, target), True
        except ValueError as e:
            warnings.warn(
                f"checkpoint {path} is unrestorable ({e}) -- RETRAINING "
                f"and overwriting it", stacklevel=2)
    elif Path(path).is_dir():
        warnings.warn(
            f"checkpoint {path} exists but has no completion marker (torn "
            f"partial) -- RETRAINING over it", stacklevel=2)
    tree = train_fn()
    save_checkpoint(path, tree)
    return tree, False
