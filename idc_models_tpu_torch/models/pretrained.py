"""Pretrained-weight import from the JAX package's npz artifacts.

The counterpart of ``idc_models_tpu/models/pretrained.py`` for npz
files: the flat "path/to/leaf" layout ``save_npz`` writes, either
params-only or the ``{"params": ..., "state": ...}`` wrapper. Keras
``.h5`` files are not read yet; the JAX package's ``convert-weights``
verb turns one into an npz this module reads.
"""

from __future__ import annotations

import warnings
from pathlib import Path

import numpy as np
from torch import nn

from idc_models_tpu_torch import convert


def save_npz(path: str | Path, tree) -> None:
    flat = {k: np.asarray(v) for k, v in convert.flatten(tree).items()}
    np.savez(path, **flat)


def load_npz(path: str | Path):
    with np.load(path) as z:
        return convert.unflatten({k: z[k] for k in z.files})


def merge_pretrained(params, loaded):
    """Graft `loaded` leaves onto `params` where paths+shapes match.

    Returns (merged, n_loaded, mismatches)."""
    flat_p = convert.flatten(params)
    flat_l = convert.flatten(loaded)
    merged = dict(flat_p)
    mismatches = []
    n = 0
    for k, v in flat_l.items():
        if k not in flat_p:
            mismatches.append(f"unexpected: {k}")
            continue
        if tuple(np.shape(v)) != tuple(np.shape(flat_p[k])):
            mismatches.append(
                f"shape {k}: {np.shape(v)} vs {np.shape(flat_p[k])}")
            continue
        merged[k] = np.asarray(v, dtype=np.asarray(flat_p[k]).dtype)
        n += 1
    return convert.unflatten(merged), n, mismatches


def load_pretrained_file(path: str | Path):
    """Load an npz weight artifact -> (params_tree, state_tree)."""
    p = Path(path)
    if p.suffix.lower() in (".h5", ".hdf5"):
        raise NotImplementedError(
            f"{p}: Keras .h5 weights are not read by the port yet; "
            f"convert them to .npz with `python -m idc_models_tpu "
            f"convert-weights`")
    loaded = load_npz(p)
    if loaded and set(loaded) <= {"params", "state"}:
        return loaded.get("params", {}), loaded.get("state", {})
    return loaded, {}


def maybe_load_pretrained(module: nn.Module, weights_path: str | Path | None,
                          *, subtree: str | None = "backbone") -> nn.Module:
    """Merge a weight artifact into ``module``'s `subtree` (parameters and
    BN statistics) in place, if the file exists; warn, and keep the
    random initialization, if it does not."""
    if weights_path is None:
        return module
    p = Path(weights_path)
    if not p.exists():
        warnings.warn(f"pretrained weights {p} not found; using random "
                      f"initialization", stacklevel=2)
        return module
    loaded_p, loaded_s = load_pretrained_file(p)
    params, state = convert.to_jax(module)

    def graft(tree, loaded, what):
        if not loaded:
            return tree, 0
        target = tree[subtree] if subtree else tree
        merged, n, mis = merge_pretrained(target, loaded)
        if mis:
            warnings.warn(f"pretrained {what} merge: {len(mis)} mismatches "
                          f"(first: {mis[:3]})", stacklevel=3)
        if not subtree:
            return merged, n
        return {**tree, subtree: merged}, n

    params, n_p = graft(params, loaded_p, "params")
    state, n_s = graft(state, loaded_s, "state")
    if n_p + n_s == 0:
        warnings.warn(f"pretrained weights {p}: no tensors matched — "
                      f"continuing from random initialization", stacklevel=2)
        return module
    print(f"loaded pretrained weights from {p} "
          f"({n_p} param tensors, {n_s} state tensors)")
    return convert.load_jax(module, params, state)
