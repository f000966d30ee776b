"""Carry weights between the JAX package's trees and the port's modules.

The JAX package keeps a model's variables as two nested dicts of arrays,
``params`` and ``state`` (BN moving statistics), keyed by layer name:
``params["backbone"]["block_1_depthwise"]["kernel"]``. The port's
state-dict key for the same tensor is that path with "/" spelled ".":
``backbone.block_1_depthwise.kernel``. Every tensor keeps its JAX shape
at this boundary (HWIO conv, [kh, kw, 1, C] depthwise, [in, out]
dense), so nothing is transposed, and a ``save_npz`` file of the JAX
package (flat "a/b/c" keys) loads straight in.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def flatten(tree, prefix=()) -> dict[str, object]:
    """Nested dict -> {"a/b/c": leaf}."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten(v, prefix + (k,)))
    else:
        out["/".join(prefix)] = tree
    return out


def unflatten(flat: dict[str, object]) -> dict:
    """{"a/b/c": leaf} -> nested dict."""
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def from_jax(params, state=None) -> dict[str, torch.Tensor]:
    """JAX (params, state) trees of arrays -> a port state dict (CPU
    tensors, dotted keys) for ``module.load_state_dict``."""
    flat = flatten(params)
    flat.update(flatten(state or {}))
    return {k.replace("/", "."): torch.from_numpy(np.array(v, copy=True))
            for k, v in flat.items()}


def to_jax(module: nn.Module) -> tuple[dict, dict]:
    """A port module -> JAX-shaped (params, state) trees of numpy arrays:
    its parameters become ``params``, its buffers ``state``."""

    def tree(named):
        return unflatten({k.replace(".", "/"): t.detach().cpu().numpy()
                          for k, t in named})

    return tree(module.named_parameters()), tree(module.named_buffers())


def load_jax(module: nn.Module, params, state=None) -> nn.Module:
    """Copy JAX trees into `module` in place (onto its device); every
    tensor of the module must be given, at its shape."""
    module.load_state_dict(from_jax(params, state))
    return module
