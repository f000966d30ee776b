"""Pretrained-weight import: Keras h5 files and the JAX package's npz
artifacts.

The counterpart of ``idc_models_tpu/models/pretrained.py``:

- ``load_npz`` / ``save_npz``: the flat "path/to/leaf" npz layout
  ``save_npz`` writes, either params-only or the ``{"params": ...,
  "state": ...}`` wrapper;
- ``load_keras_h5``: a Keras ``save_weights`` h5 file, keyed by the
  Keras layer names the port's backbones use. Conv kernels are HWIO in
  Keras as here; depthwise kernels are swapped from (kh, kw, C, 1) to
  (kh, kw, 1, C); BN moving statistics go to the state tree. h5py is
  imported only when an h5 file is read (the card's machine has none).
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


def merge_pretrained(params, loaded, *, strict: bool = False):
    """Graft `loaded` leaves onto `params` where paths+shapes match.

    Returns (merged, n_loaded, mismatches). With strict=True any shape
    mismatch, unexpected path or leaf of `params` left unloaded raises
    ``ValueError``."""
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
    if strict and (mismatches or n < len(flat_p)):
        raise ValueError(f"pretrained merge failed: {mismatches[:10]}, "
                         f"loaded {n}/{len(flat_p)}")
    return convert.unflatten(merged), n, mismatches


_KERAS_SUFFIX = {
    "kernel:0": "kernel",
    # Keras DepthwiseConv2D's variable, stored (kh, kw, C, 1)
    "depthwise_kernel:0": "kernel",
    "bias:0": "bias",
    "gamma:0": "scale", "beta:0": "bias",
    "moving_mean:0": "mean", "moving_variance:0": "var",
}


def load_keras_h5(path: str | Path):
    """Read a Keras `save_weights` h5 into (params, state) trees keyed by
    Keras layer name (the names the port's backbones use)."""
    import h5py

    params: dict = {}
    state: dict = {}
    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        for layer in root:
            g = root[layer]
            for w in g.attrs.get("weight_names", []):
                name = w.decode() if isinstance(w, bytes) else w
                suffix = name.split("/")[-1]
                key = _KERAS_SUFFIX.get(suffix)
                if key is None:
                    continue
                arr = np.asarray(g[name])
                layer_name = name.split("/")[-2]
                if key == "kernel" and (suffix == "depthwise_kernel:0"
                                        or "depthwise" in layer_name):
                    arr = np.transpose(arr, (0, 1, 3, 2))
                dest = state if suffix.startswith("moving") else params
                dest.setdefault(layer_name, {})[key] = arr
    return params, state


def load_pretrained_file(path: str | Path):
    """Load a weight artifact -> (params_tree, state_tree): ``.h5`` /
    ``.hdf5`` as a Keras `save_weights` file, anything else as the JAX
    package's npz (params only, or the {"params", "state"} wrapper)."""
    p = Path(path)
    if p.suffix.lower() in (".h5", ".hdf5"):
        return load_keras_h5(p)
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
