"""FedAvg's building blocks on one card: the server state, the per-client
local trainer, and the divergence test.

The counterpart of ``idc_models_tpu/federated/fedavg.py`` for what the
secure-aggregation round needs. The JAX package vmaps the k clients of a
device inside one program; on one H100 (world size 1) every client is
local, and the port trains them in turn on one working module, each from
the incoming global weights with its own generator. Batching the clients
as one workload (``torch.func.vmap``) comes with the distribution layer.

Weights cross the round boundary as flat ``{dotted name: tensor}`` dicts
-- the module's named parameters (``params``) and buffers (``state``, the
BN moving statistics) -- whose names are the JAX tree paths, so
``convert.py`` carries them to and from the JAX package's trees.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable, Mapping

import torch
from torch import nn

from idc_models_tpu_torch.models import core
from idc_models_tpu_torch.train.state import TrainState, rmsprop
from idc_models_tpu_torch.train.step import make_train_step

LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
Tree = dict[str, torch.Tensor]


@dataclasses.dataclass
class ServerState:
    """The federated server's state: the global model between rounds, as
    detached ``{name: tensor}`` copies of a module's parameters and
    buffers."""

    round: int
    params: Tree
    state: Tree

    def replace(self, **kw) -> "ServerState":
        return dataclasses.replace(self, **kw)

    @classmethod
    def of(cls, module: nn.Module, round: int = 0) -> "ServerState":
        """Snapshot `module`'s weights (copies, on its device)."""
        return cls(round,
                   {n: p.detach().clone()
                    for n, p in module.named_parameters()},
                   {n: b.detach().clone() for n, b in module.named_buffers()})


def initialize_server(model: nn.Module, seed: int) -> ServerState:
    """Fresh server state (`fed_avg.initialize()`, fed_model.py:216): the
    model initialized from `seed`, round 0."""
    return ServerState.of(core.init_params(model, seed))


def load_server(module: nn.Module, server: ServerState) -> nn.Module:
    """Copy the server's global weights into `module` in place."""
    module.load_state_dict({**server.params, **server.state})
    return module


def make_local_trainer(model: nn.Module, lr: float, loss_fn: LossFn, *,
                       local_epochs: int, batch_size: int):
    """The per-client E-local-epochs program.

    Returns ``local_train(imgs [S, ...], labels [S], generator) ->
    (losses, accs)``, each [local_epochs, steps] on the model's device,
    which trains `model` in place from its current weights with a fresh
    Keras RMSprop at `lr` (the client optimizer is built per round, TFF
    semantics). As in the JAX package, an epoch is ``steps = max(S // B,
    1)`` steps of ``take // steps`` examples, ``take = min(steps * B, S)``,
    in the order of a permutation drawn per epoch. `generator` (on the
    model's device) draws the permutations and every dropout mask.
    """

    def local_train(imgs, labels, generator: torch.Generator):
        shard_size = imgs.shape[0]
        steps = max(shard_size // batch_size, 1)
        take = min(steps * batch_size, shard_size)
        bsz = take // steps
        step = make_train_step(TrainState(model, rmsprop(model, lr)),
                               loss_fn)
        core.use_generator(model, generator)
        losses, accs = [], []
        try:
            for _ in range(local_epochs):
                perm = torch.randperm(shard_size, generator=generator,
                                      device=generator.device)
                for idx in perm[:take].view(steps, bsz):
                    m = step(imgs[idx], labels[idx])
                    losses.append(m["loss"])
                    accs.append(m["accuracy"])
        finally:
            core.use_generator(model, None)
        return (torch.stack(losses).view(local_epochs, steps),
                torch.stack(accs).view(local_epochs, steps))

    return local_train


def finite_clients(losses: torch.Tensor, *trees: Mapping[str, torch.Tensor]
                   ) -> torch.Tensor:
    """[C] bool: which clients produced an all-finite local result. Every
    leaf of `trees` and `losses` carries the leading [C] client axis."""
    leaves = [losses] + [t for tree in trees for t in tree.values()]
    ok = torch.ones(losses.shape[0], dtype=torch.bool, device=losses.device)
    for leaf in leaves:
        if leaf.is_floating_point():
            ok &= torch.isfinite(leaf.reshape(leaf.shape[0], -1)).all(1)
    return ok
