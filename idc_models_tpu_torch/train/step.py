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


def make_train_step(state: TrainState, loss_fn: LossFn):
    """Returns train_step(images, labels) -> metrics (device scalars),
    updating the model's parameters and BN statistics and the optimizer's
    moments in place, and counting the step in ``state.step``. The loss
    runs in the logits' precision, at least f32 (a float64 model keeps
    float64 through the loss and its gradient)."""
    model, optimizer = state.model, state.optimizer

    def train_step(images, labels):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        logits = model(images)
        logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
        loss = loss_fn(logits, labels)
        loss.backward()
        optimizer.step()
        state.step += 1
        logits = logits.detach()
        return {"loss": loss.detach(),
                "accuracy": metrics_lib.auto_accuracy(logits, labels)}

    return train_step


def make_eval_step(model: nn.Module, loss_fn: LossFn):
    """Returns eval_step(images, labels) -> metrics (loss/accuracy/logits)."""

    @torch.no_grad()
    def eval_step(images, labels):
        model.eval()
        logits = model(images).float()
        return {"loss": loss_fn(logits, labels),
                "accuracy": metrics_lib.auto_accuracy(logits, labels),
                "logits": logits}

    return eval_step
