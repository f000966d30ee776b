"""FedAvg on one card: the server state, the per-client local trainer,
the divergence test, the plain FedAvg round and the federated eval.

The counterpart of ``idc_models_tpu/federated/fedavg.py``. The JAX
package vmaps the k clients of a device inside one program; on one H100
(world size 1) every client is local, and the port trains them in turn
on one working module, each from the incoming global weights with its
own generator. Batching the clients as one workload
(``torch.func.vmap``) comes with the distribution layer.

Weights cross the round boundary as flat ``{dotted name: tensor}`` dicts
-- the module's named parameters (``params``) and buffers (``state``, the
BN moving statistics) -- whose names are the JAX tree paths, so
``convert.py`` carries them to and from the JAX package's trees.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable, Mapping

import numpy as np
import torch
from torch import nn

from idc_models_tpu_torch import convert, resolve_device
from idc_models_tpu_torch import faults as faults_lib
from idc_models_tpu_torch.federated import robust
from idc_models_tpu_torch.models import core
from idc_models_tpu_torch.train import metrics as metrics_lib
from idc_models_tpu_torch.train.state import TrainState, rmsprop
from idc_models_tpu_torch.train.step import make_train_step

LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
Tree = dict[str, torch.Tensor]
# a round's random key: (seed, round, attempt) from the driver, as the
# JAX package's fold_in(fold_in(key(seed), round), attempt)
Key = tuple[int, ...]


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

    def to(self, device) -> "ServerState":
        return self.replace(
            params={k: v.to(device) for k, v in self.params.items()},
            state={k: v.to(device) for k, v in self.state.items()})

    def tree(self) -> dict:
        """The JAX package's ServerState as a checkpoint tree: ``round``,
        and ``params`` / ``model_state`` nested by layer name."""
        def nest(flat):
            return convert.unflatten({k.replace(".", "/"): v
                                      for k, v in flat.items()})

        return {"round": np.int32(self.round), "params": nest(self.params),
                "model_state": nest(self.state)}

    @classmethod
    def from_tree(cls, tree: dict) -> "ServerState":
        """The inverse of `tree` (e.g. a restored checkpoint)."""
        def flat(nested):
            return {k.replace("/", "."): v
                    for k, v in convert.flatten(nested).items()}

        return cls(int(tree["round"]), flat(tree["params"]),
                   flat(tree["model_state"]))


def initialize_server(model: nn.Module, seed: int) -> ServerState:
    """Fresh server state (`fed_avg.initialize()`, fed_model.py:216): the
    model initialized from `seed`, round 0."""
    return ServerState.of(core.init_params(model, seed))


def seed_server_with(server: ServerState, params: Tree,
                     state: Tree) -> ServerState:
    """Replace the server model wholesale: TFF's
    ``state_with_new_model_weights`` seeding from a pretrained model
    (fed_model.py:219-223)."""
    return server.replace(params=params, state=state)


def load_server(module: nn.Module, server: ServerState) -> nn.Module:
    """Copy the server's global weights into `module` in place."""
    module.load_state_dict({**server.params, **server.state})
    return module


def copy_tree(tree):
    """Fresh copies of a ServerState's tensors, or of a {name: tensor}
    dict's: snapshots that survive later in-place changes of the
    originals (the driver's rollback anchor, the straggler history)."""
    if isinstance(tree, ServerState):
        return tree.replace(params=copy_tree(tree.params),
                            state=copy_tree(tree.state))
    return {k: v.detach().clone() for k, v in tree.items()}


def client_generator(key: Key, client: int, device) -> torch.Generator:
    """Client `client`'s generator for the round keyed by `key`: a pure
    function of (key, global client id), so a client's draws do not
    depend on the order the clients train in (the JAX package's
    ``fold_in(rng, client id)``; its streams themselves cannot be
    reproduced)."""
    seed = np.random.SeedSequence([*key, client]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(seed >> 1))


def make_local_trainer(model: nn.Module, lr: float, loss_fn: LossFn, *,
                       local_epochs: int, batch_size: int,
                       trainable_mask: dict[str, bool] | None = None):
    """The per-client E-local-epochs program.

    Returns ``local_train(imgs [S, ...], labels [S], generator) ->
    (losses, accs)``, each [local_epochs, steps] on the model's device,
    which trains `model` in place from its current weights with a fresh
    Keras RMSprop at `lr` over the parameters `trainable_mask` marks
    trainable (None: all of them; the client optimizer is built per
    round, TFF semantics). As in the JAX package, an epoch is ``steps =
    max(S // B, 1)`` steps of ``take // steps`` examples, ``take =
    min(steps * B, S)``, in the order of a permutation drawn per epoch.
    `generator` (on the model's device) draws the permutations and every
    dropout mask.
    """

    def local_train(imgs, labels, generator: torch.Generator):
        shard_size = imgs.shape[0]
        steps = max(shard_size // batch_size, 1)
        take = min(steps * batch_size, shard_size)
        bsz = take // steps
        step = make_train_step(TrainState(model, rmsprop(
            model, lr, trainable_mask=trainable_mask)), loss_fn)
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


def train_clients(model: nn.Module, local_train, server: ServerState,
                  images: torch.Tensor, labels: torch.Tensor, live, key: Key,
                  first: int = 0):
    """Train each client ``c`` with ``live[c]`` in turn on `model`, from
    the server's weights, with the generator ``client_generator(key,
    first + c)`` (a streamed wave passes its first client's cohort
    position as `first`).

    Returns ``(params, state, losses, accs)``: the clients' weights
    stacked on a leading [C] axis (a client that did not train holds the
    server's) and their mean local loss and accuracy, [C] f32 (0 where
    it did not train). The round shared by `make_fedavg_round` and the
    waves of `federated/population.py`."""
    device = images.device
    glob = {**server.params, **server.state}
    n = images.shape[0]
    stacked = {k: v.unsqueeze(0).repeat((n,) + (1,) * v.dim())
               for k, v in glob.items()}
    losses = torch.zeros(n, device=device)
    accs = torch.zeros(n, device=device)
    for c in np.flatnonzero(np.asarray(live)).tolist():
        load_server(model, server)
        loss, acc = local_train(images[c], labels[c],
                                client_generator(key, first + c, device))
        losses[c], accs[c] = loss.mean(), acc.mean()
        with torch.no_grad():
            for k, v in model.state_dict().items():
                stacked[k][c].copy_(v)
    return ({k: stacked[k] for k in server.params},
            {k: stacked[k] for k in server.state}, losses, accs)


def screen_clients(params: Tree, state: Tree, losses: torch.Tensor,
                   weight: torch.Tensor, server: ServerState, faulted=None):
    """The round's fault application and divergence test, after local
    training: `faulted` is None or ``(codes [C], scales [C], stale
    server)`` for `faults.apply_faults`; then a client whose update or
    loss holds a non-finite value gets weight 0. Returns ``(params,
    state, weight, dropped)``, `dropped` counting the clients of weight >
    0 that the test removed (the JAX round's ``drop_nonfinite``)."""
    if faulted is not None:
        codes, scales, stale = faulted
        params, state, weight = faults_lib.apply_faults(
            codes, scales, params, state, weight, server.params,
            server.state, stale.params, stale.state)
    ok = finite_clients(losses, params, state)
    dropped = ((weight > 0) & ~ok).sum().float()
    return params, state, torch.where(ok, weight, 0.0), dropped


class StaleHistory:
    """The server entering each round, keyed by round index, for a fault
    plan's stragglers: ``history(server, r, k)`` records round r's server
    and returns round r - k's (the oldest retained entry on early rounds,
    and after a resume: the history is not checkpointed). With no
    straggler in the plan (`max_staleness` 0) it keeps nothing and
    returns `server`, whose straggler codes cannot occur."""

    def __init__(self, max_staleness: int):
        self.max_staleness = int(max_staleness)
        self._by_round: dict[int, ServerState] = {}

    def __call__(self, server: ServerState, r: int,
                 staleness: int) -> ServerState:
        if self.max_staleness == 0:
            return server
        self._by_round[r] = copy_tree(server)
        for old in [x for x in self._by_round
                    if x < r - self.max_staleness]:
            del self._by_round[old]
        return self._by_round.get(r - staleness,
                                  self._by_round[min(self._by_round)])


def float_metrics(m: dict) -> dict[str, float]:
    """A round's metric tensors as floats, in one device-to-host copy."""
    return dict(zip(m, torch.stack([v.float() for v in m.values()])
                    .tolist()))


def make_fedavg_round(model: nn.Module, lr: float, loss_fn: LossFn, *,
                      local_epochs: int = 1, batch_size: int = 32,
                      trainable_mask: dict[str, bool] | None = None,
                      aggregator=None, faults=None, device=None):
    """Build the one-round FedAvg program on one card.

    Returns ``round_fn(server, images [C, S, ...], labels [C, S],
    weights [C], key, *, round_idx=None) -> (server, metrics)``. `model`
    is the working module: it moves to `device` (CUDA unless "cpu" is
    asked for), and each client of weight > 0 trains on it in turn from
    the incoming global weights, with a fresh RMSprop at `lr` over
    `trainable_mask` and its own generator (`client_generator(key, c)`).
    A client of weight 0 does not train: nothing of it reaches the
    aggregate or the metrics. Images enter in the model's dtype; pass the
    stacked shards as tensors already on the device (and in that dtype)
    to keep the upload out of the round.

    - ``weights`` are the per-client aggregation weights (example counts
      for TFF parity); 0 leaves a client out.
    - ``faults`` (`faults.FaultPlan`): the plan's codes for the round
      (``round_idx``, default ``server.round``) are applied to the client
      updates after local training; stragglers replay a cloned server
      from an internal per-round history (depth: the plan's staleness).
    - A client whose update holds a non-finite value gets weight 0 and
      is counted in ``clients_dropped`` (the JAX round's
      ``drop_nonfinite``, always on here).
    - ``aggregator`` (`federated/robust.py`): None or "mean" is the
      example-weighted mean; "trimmed_mean", "median" and "norm_clip"
      bound finite-but-malicious updates and add their own metrics.
    - When no client survives, the incoming server weights are kept and
      ``loss`` and ``accuracy`` are NaN.

    The metrics are floats: the example-weighted ``loss`` and
    ``accuracy`` of the clients' local steps, ``clients_dropped``, and
    the aggregator's."""
    device = resolve_device(device)
    model.to(device)
    agg_fn = robust.get_aggregator(aggregator)
    local_train = make_local_trainer(
        model, lr, loss_fn, local_epochs=local_epochs,
        batch_size=batch_size, trainable_mask=trainable_mask)
    history = StaleHistory(faults.max_staleness if faults else 0)

    def round_fn(server: ServerState, images, labels, weights, key: Key, *,
                 round_idx: int | None = None):
        images = torch.as_tensor(images, device=device,
                                 dtype=next(model.parameters()).dtype)
        labels = torch.as_tensor(labels, device=device)
        w_host = torch.as_tensor(weights, dtype=torch.float32).cpu()
        n = images.shape[0]
        if w_host.shape != (n,):
            raise ValueError(f"{tuple(w_host.shape)} client weights for "
                             f"{n} client shards")
        if faults is not None and faults.n_clients > n:
            raise ValueError(
                f"fault plan covers {faults.n_clients} clients but only "
                f"{n} client shards were passed")
        server = server.to(device)
        glob = {**server.params, **server.state}
        client_p, client_s, losses, accs = train_clients(
            model, local_train, server, images, labels,
            w_host.numpy() > 0, key)
        faulted = None
        if faults is not None:
            r = server.round if round_idx is None else int(round_idx)
            codes, scales = faults.codes(r)
            pad = n - faults.n_clients
            faulted = (
                torch.as_tensor(np.concatenate(
                    [codes, np.zeros((pad,), np.int32)]), device=device),
                torch.as_tensor(np.concatenate(
                    [scales, np.ones((pad,), np.float32)]), device=device),
                history(server, r, faults.staleness(r)))
        client_p, client_s, weight, dropped = screen_clients(
            client_p, client_s, losses, w_host.to(device), server, faulted)

        agg, agg_m = agg_fn({**client_p, **client_s}, weight, glob)
        m = float_metrics({"loss": robust.weighted_mean(losses, weight),
                           "accuracy": robust.weighted_mean(accs, weight),
                           "clients_dropped": dropped, **agg_m})
        if not float(robust.weight_total(weight)) > 0:
            # every client dropped: keep the incoming server and report
            # NaN metrics -- an all-zero-weight mean would read as a
            # perfect 0.0 loss while training silently stalls
            agg = glob
            m["loss"] = m["accuracy"] = float("nan")
        return ServerState(server.round + 1,
                           {k: agg[k] for k in server.params},
                           {k: agg[k] for k in server.state}), m

    return round_fn


# examples a forward of the federated eval takes at a time (a whole
# shard is up to 3,000 patches at the fed preset)
_EVAL_CHUNK = 512


def make_federated_eval(model: nn.Module, loss_fn: LossFn, *, device=None):
    """Build the federated evaluation (fed_model.py:210).

    Returns ``eval_fn(server, images [C, S, ...], labels [C, S], weights
    [C]) -> {"loss", "accuracy"}``: the global model in eval mode on every
    client shard of weight > 0, each client's loss and accuracy over its
    whole shard, example-weighted across clients (floats)."""
    device = resolve_device(device)
    model.to(device)

    def eval_fn(server: ServerState, images, labels, weights):
        images = torch.as_tensor(images, dtype=torch.float32, device=device)
        labels = torch.as_tensor(labels, device=device)
        w_host = torch.as_tensor(weights, dtype=torch.float32).cpu()
        n = images.shape[0]
        losses = torch.zeros(n, device=device)
        accs = torch.zeros(n, device=device)
        load_server(model, server.to(device)).eval()
        with torch.no_grad():
            for c in np.flatnonzero(w_host.numpy() > 0).tolist():
                logits = torch.cat([
                    model(x).float()
                    for x in images[c].split(_EVAL_CHUNK)])
                losses[c] = loss_fn(logits, labels[c])
                accs[c] = metrics_lib.auto_accuracy(logits, labels[c])
        weight = w_host.to(device)
        m = torch.stack([robust.weighted_mean(losses, weight),
                         robust.weighted_mean(accs, weight)]).tolist()
        return {"loss": m[0], "accuracy": m[1]}

    return eval_fn

