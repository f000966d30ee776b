"""The train and eval steps, as ``idc_models_tpu/train/step.py``:
forward -> loss -> backward -> optimizer update, on one card (no mesh
and no sharding layer: world size 1)."""

from __future__ import annotations

from collections.abc import Callable

import torch
from torch import nn

from idc_models_tpu_torch.train import metrics as metrics_lib
from idc_models_tpu_torch.train.state import TrainState

LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def cast_inputs(images: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Floating inputs go to `compute_dtype` once; integer inputs (LM
    token ids) stay exact, as the JAX step keeps them: a bf16 round trip
    would round ids above 256. ``None`` keeps the input's dtype."""
    if compute_dtype is None or not images.is_floating_point():
        return images
    return images.to(compute_dtype)


def make_train_step(state: TrainState, loss_fn: LossFn, *,
                    compute_dtype: torch.dtype | None = None):
    """Returns train_step(images, labels) -> metrics (device scalars),
    updating the model's parameters and BN statistics and the optimizer's
    moments in place, and counting the step in ``state.step``.

    `compute_dtype` (e.g. ``torch.bfloat16``) casts floating inputs once;
    each layer casts its parameters to the input's dtype, BN takes its
    statistics in f32, and the master parameters and optimizer moments
    stay f32 -- the JAX step's semantics, not autocast's. ``None`` (the
    default) runs in the input's dtype. The loss runs in the logits'
    precision, at least f32 (a float64 model keeps float64 through the
    loss and its gradient)."""
    model, optimizer = state.model, state.optimizer

    def train_step(images, labels):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        logits = model(cast_inputs(images, compute_dtype))
        logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
        loss = loss_fn(logits, labels)
        loss.backward()
        optimizer.step()
        state.step += 1
        logits = logits.detach()
        return {"loss": loss.detach(),
                "accuracy": metrics_lib.auto_accuracy(logits, labels)}

    return train_step


def make_eval_step(model: nn.Module, loss_fn: LossFn, *,
                   compute_dtype: torch.dtype | None = None):
    """Returns eval_step(images, labels) -> metrics (loss/accuracy/logits),
    the logits in f32; `compute_dtype` as in `make_train_step`."""

    @torch.no_grad()
    def eval_step(images, labels):
        model.eval()
        logits = model(cast_inputs(images, compute_dtype)).float()
        return {"loss": loss_fn(logits, labels),
                "accuracy": metrics_lib.auto_accuracy(logits, labels),
                "logits": logits}

    return eval_step
