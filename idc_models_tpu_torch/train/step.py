"""The train and eval steps, as ``idc_models_tpu/train/step.py``:
forward -> loss -> backward -> optimizer update, on one card or over the
"data" axis of a mesh.

The JAX package shards the global batch over "data" and lets XLA insert
the gradient all-reduce (``jit_data_parallel``). Here each rank runs the
step on its own rows (`shard_batch`), its BatchNorms take the moments of
the global batch (``core.sync_batch_norm``), and the gradients are
averaged over "data" before the update, in one all-reduce per dtype: the
same step as one rank on the whole batch. A model split over other axes
first reduces its own gradients (``reduce_gradients``, e.g. the
sequence-sharded attention classifier's per-position parameters).

`place_state` under partition rules (the channel rule of
``--model-parallel``) stores the parameters and RMSprop moments by the
rule: `ShardedOptimizer` keeps this rank's block of each and updates only
that block, and the model's parameters are gathered whole after each
update for the next step's compute.
"""

from __future__ import annotations

from collections.abc import Callable

import torch
from torch import nn

from idc_models_tpu_torch import collectives
from idc_models_tpu_torch import mesh as meshlib
from idc_models_tpu_torch.mesh import Mesh
from idc_models_tpu_torch.models import core
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


def data_group(mesh: Mesh | None):
    """The process group a batch is split over on `mesh` (None without
    a mesh)."""
    if mesh is None:
        return None
    return mesh.group(meshlib.batch_axis(mesh))


def mean_gradients(params, group) -> None:
    """Average the gradients of `params` over `group` in place, one
    all-reduce per dtype. No group (no mesh) is no collective, even in
    a running world."""
    n = 1 if group is None else collectives.axis_size(group)
    if n == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    collectives.psum_(grads, group)
    for g in grads:
        g.div_(n)


def make_train_step(state: TrainState, loss_fn: LossFn, *,
                    compute_dtype: torch.dtype | None = None,
                    mesh: Mesh | None = None):
    """Returns train_step(images, labels) -> metrics (device scalars),
    updating the model's parameters and BN statistics and the optimizer's
    moments in place, and counting the step in ``state.step``.

    `compute_dtype` (e.g. ``torch.bfloat16``) casts floating inputs once;
    each layer casts its parameters to the input's dtype, BN takes its
    statistics in f32, and the master parameters and optimizer moments
    stay f32 -- the JAX step's semantics, not autocast's. ``None`` (the
    default) runs in the input's dtype. The loss runs in the logits'
    precision, at least f32 (a float64 model keeps float64 through the
    loss and its gradient).

    With `mesh` the step is data-parallel over its batch axis: the
    images and labels are this rank's rows of the global batch, and the
    metrics are the global batch's, the same on every rank. Without one
    it calls no collective, even in a running world."""
    model, optimizer = state.model, state.optimizer
    group = data_group(mesh)
    if mesh is not None:
        core.sync_batch_norm(model, group)
        core.shard_dropout(model, {0: (collectives.axis_index(group),
                                       collectives.axis_size(group))})
    reduce_own = getattr(model, "reduce_gradients", None)

    def train_step(images, labels):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        logits = model(cast_inputs(images, compute_dtype))
        logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
        loss = loss_fn(logits, labels)
        loss.backward()
        if reduce_own is not None:
            reduce_own()
        mean_gradients(model.parameters(), group)
        optimizer.step()
        state.step += 1
        logits = logits.detach()
        m = {"loss": loss.detach(),
             "accuracy": metrics_lib.auto_accuracy(logits, labels)}
        return collectives.pmean(m, group) if group is not None else m

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


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def shard_batch(mesh: Mesh, *arrays, axis: str | None = None, device=None):
    """This rank's rows of each host array (or tensor), split over the
    batch axis, on `device` when given."""
    sh = meshlib.sharding(mesh, meshlib.batch_axis(mesh, axis))
    out = tuple(meshlib.put_with_sharding(a, sh, device) for a in arrays)
    return out if len(out) > 1 else out[0]


def replicate(mesh: Mesh, model: nn.Module) -> nn.Module:
    """Every rank's model the same: rank 0's parameters and buffers
    broadcast over the mesh. (Ranks that build from one seed hold the
    same model already; this makes it so for any model.)"""
    if collectives.initialized() and mesh.size > 1:
        with torch.no_grad():
            for t in [*model.parameters(), *model.buffers()]:
                torch.distributed.broadcast(t.data, 0)
    return model


class ShardedOptimizer(torch.optim.Optimizer):
    """An optimizer whose parameters and moments are stored by partition
    rules: each rank keeps its block of every trained parameter (cut by
    the spec its rule resolves to on the mesh) and runs the wrapped
    optimizer's update on the blocks alone, its moments block-shaped;
    after the update the model's parameters are gathered whole for the
    next step's compute. The gradients it is given are the whole
    parameters', already averaged over "data"."""

    def __init__(self, optimizer: torch.optim.Optimizer, model: nn.Module,
                 mesh: Mesh, rules):
        params = [p for g in optimizer.param_groups for p in g["params"]]
        names = {id(p): n for n, p in model.named_parameters()}
        tree = {names[id(p)].replace(".", "/"): p for p in params}
        specs = rules.specs({"params": tree}, mesh=mesh,
                            check_dead=False)["params"]
        self._shardings = [meshlib.Sharding(mesh, specs[
            names[id(p)].replace(".", "/")]) for p in params]
        self.blocks = [meshlib.put_with_sharding(p.detach(), sh).clone()
                       for p, sh in zip(params, self._shardings)]
        self.inner = type(optimizer)(self.blocks, **optimizer.defaults)
        super().__init__(params, optimizer.defaults)
        self.state = self.inner.state

    @torch.no_grad()
    def step(self, closure=None):
        params = [p for g in self.param_groups for p in g["params"]]
        for p, b, sh in zip(params, self.blocks, self._shardings):
            b.grad = (None if p.grad is None
                      else meshlib.put_with_sharding(p.grad, sh))
        self.inner.step()
        for p, b, sh in zip(params, self.blocks, self._shardings):
            p.copy_(meshlib.gather_block(b, sh))


def place_state(mesh: Mesh, state: TrainState) -> TrainState:
    """The train state in the layout the step expects on `mesh`: by the
    channel rule on a mesh with a "model" axis (``tp.py``), its
    optimizer a `ShardedOptimizer`; else as it is (replicated)."""
    from idc_models_tpu_torch import tp

    if not tp.has_model_axis(mesh):
        return state
    return TrainState(state.model, ShardedOptimizer(
        state.optimizer, state.model, mesh, tp.channel_rules()), state.step)
