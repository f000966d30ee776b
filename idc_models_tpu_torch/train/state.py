"""Training state and the Keras RMSprop.

The counterpart of ``idc_models_tpu/train/state.py``. The JAX package's
TrainState is one pytree (params, BN statistics, optimizer state, step);
here the module holds its parameters and BN statistics, the optimizer
its moments, and ``TrainState`` ties them to the step counter.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BN statistics, updated in place), its
    optimizer (the RMSprop moments) and the count of optimizer steps
    taken."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def freeze_where(module: nn.Module,
                 trainable_mask: dict[str, bool] | None) -> list[nn.Parameter]:
    """Apply a trainability mask ({parameter name: trainable}, from
    ``models.core.trainability_mask``): frozen parameters stop requiring
    grad, so autograd computes nothing for them. Returns the trainable
    parameters, in order. ``None`` trains everything."""
    named = dict(module.named_parameters())
    if trainable_mask is None:
        trainable_mask = {n: True for n in named}
    if set(trainable_mask) != set(named):
        raise ValueError(
            f"trainable_mask does not match the module's parameters: "
            f"missing {sorted(set(named) - set(trainable_mask))[:5]}, "
            f"unknown {sorted(set(trainable_mask) - set(named))[:5]}")
    for n, p in named.items():
        p.requires_grad_(bool(trainable_mask[n]))
    return [p for n, p in named.items() if trainable_mask[n]]


def rmsprop(module: nn.Module, learning_rate: float, *, rho: float = 0.9,
            eps: float = 1e-7,
            trainable_mask: dict[str, bool] | None = None
            ) -> torch.optim.RMSprop:
    """RMSprop in the Keras form over the module's trainable parameters:
    ``nu = rho*nu + (1-rho)*g^2``, ``p -= lr * g / (sqrt(nu) + eps)``,
    rho 0.9, eps 1e-7 -- the form of ``torch.optim.RMSprop(alpha=rho,
    eps=eps)``. Frozen parameters (mask False) are left out of the
    optimizer, so they get no update and no moment update."""
    return torch.optim.RMSprop(freeze_where(module, trainable_mask),
                               lr=learning_rate, alpha=rho, eps=eps)
