"""FedAvg: the server state, the per-client local trainer, the
divergence test, the plain FedAvg round and the federated eval.

The counterpart of ``idc_models_tpu/federated/fedavg.py``. The JAX
package vmaps the k clients of a device inside one program; the port
trains a rank's k clients in turn on one working module, each from the
incoming global weights with its own generator. Over a "client" mesh
(``mesh.client_mesh``, one card or one gloo rank a rank) the C clients
split into blocks of k = C/D, rank r training clients ``r*k .. r*k+k-1``
under their global ids, so a round's math does not depend on the
layout; the round boundary sums over the group (`ClientLayout`).

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

from idc_models_tpu_torch import collectives, convert, resolve_device
from idc_models_tpu_torch import faults as faults_lib
from idc_models_tpu_torch import mesh as meshlib
from idc_models_tpu_torch import partition
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


@dataclasses.dataclass(frozen=True)
class ClientLayout:
    """This rank's place in a round's "client" mesh: the group (None
    without a mesh), its size D, this rank's index and whether the rank
    is outside the mesh. A rank outside it trains nothing and takes the
    round's result from the mesh's rank 0 (`share`); every rank of the
    world calls the round."""

    group: object = None
    size: int = 1
    index: int = 0
    outside: bool = False
    share_world: bool = False

    @classmethod
    def of(cls, mesh) -> "ClientLayout":
        if mesh is None:
            return cls()
        if meshlib.CLIENT_AXIS not in mesh.shape:
            raise ValueError(f"a federated round runs on a mesh with a "
                             f"{meshlib.CLIENT_AXIS!r} axis "
                             f"(mesh.client_mesh), got {mesh.axis_names}")
        share = (collectives.initialized()
                 and collectives.axis_size() > mesh.size)
        if mesh.coords is None:
            return cls(None, mesh.axis_size(meshlib.CLIENT_AXIS), 0, True,
                       share)
        return cls(mesh.group(meshlib.CLIENT_AXIS),
                   mesh.axis_size(meshlib.CLIENT_AXIS),
                   mesh.axis_index(meshlib.CLIENT_AXIS), False, share)

    def block(self, x, n_total: int):
        """This rank's [k] block of a client-stacked `x`: `x` as it is
        when it already holds k = n_total/D clients, else its rows
        ``index*k .. index*k+k-1``. None stays None."""
        if x is None:
            return None
        k = n_total // self.size
        if x.shape[0] == k:
            return x
        if x.shape[0] != n_total:
            raise ValueError(
                f"{x.shape[0]} client shards: pass all {n_total} or this "
                f"rank's block of {k} ({n_total} over a {self.size}-rank "
                f"client mesh)")
        return x[self.index * k:(self.index + 1) * k]

    def sum(self, values: dict) -> dict:
        """`values`' tensors summed over the group, in place."""
        return robust.group_sum(values, self.group)

    def share_value(self, value):
        """A host value of the mesh's rank 0 (the world's rank 0) on every
        rank of the world; as it is where the mesh spans the world."""
        if not self.share_world:
            return value
        box = [value]
        torch.distributed.broadcast_object_list(
            box, src=0, group=torch.distributed.group.WORLD)
        return box[0]

    def share(self, server: ServerState, metrics):
        """The round's (server, metrics) on every rank of the world: the
        mesh's rank 0 sends, a rank outside the mesh receives into
        `server`'s tensors, which hold the incoming server's shapes."""
        if not self.share_world:
            return server, metrics
        for tree in (server.params, server.state):
            for name in sorted(tree):
                torch.distributed.broadcast(
                    tree[name], src=0, group=torch.distributed.group.WORLD)
        rnd, metrics = self.share_value((server.round, metrics))
        return server.replace(round=rnd), metrics


def place_server(mesh, rules):
    """The server placement of a round over `mesh` under partition
    `rules` (``partition.PartitionRules``): resolved once, every leaf of
    the server tree must come out replicated on the 1-D "client" mesh
    (the JAX package's rules adapt to replicated there), and the
    placement keeps the tensors as they are -- bit-identical to no
    rules. A rule that would split a server leaf over the client axis
    raises: the round keeps a whole server on every rank."""
    resolved: dict = {}

    def place(server: ServerState) -> ServerState:
        if rules is None or mesh is None:
            return server
        if "ok" not in resolved:
            tree = {"params": {k.replace(".", "/"): v
                               for k, v in server.params.items()},
                    "model_state": {k.replace(".", "/"): v
                                    for k, v in server.state.items()}}
            specs = rules.specs(
                {g: convert.unflatten(t) for g, t in tree.items()},
                mesh=mesh)
            split = {n: spec for n, spec in convert.flatten(specs).items()
                     if len(spec)}
            if split:
                raise partition.PartitionError(
                    f"partition rules split server leaves over the "
                    f"client mesh: {split} -- a federated round keeps "
                    f"the server whole on every rank")
            resolved["ok"] = True
        return server

    return place


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
                      aggregator=None, faults=None, mesh=None, rules=None,
                      device=None):
    """Build the one-round FedAvg program.

    Returns ``round_fn(server, images [C, S, ...], labels [C, S],
    weights [C], key, *, round_idx=None) -> (server, metrics)``. `model`
    is the working module: it moves to `device` (CUDA unless "cpu" is
    asked for), and each client of weight > 0 trains on it in turn from
    the incoming global weights, with a fresh RMSprop at `lr` over
    `trainable_mask` and its own generator (`client_generator(key, c)`,
    c the global client id). A client of weight 0 does not train:
    nothing of it reaches the aggregate or the metrics. Images enter in
    the model's dtype; pass the stacked shards as tensors already on the
    device (and in that dtype) to keep the upload out of the round.

    - ``mesh`` (``mesh.client_mesh(D)``): the C clients split over the D
      ranks of its "client" group, C a multiple of D (pad with weight-0
      clients, ``data.partition.pad_clients``). Each rank passes all C
      shards or its own block of k = C/D (rank r: clients r*k .. r*k+k-1)
      with the global [C] weights, trains its block, and the aggregate,
      the metrics and the aggregator's counts are the group's; every rank
      returns the same server. A rank outside the mesh passes its
      incoming server (images may be None) and receives the result. No
      mesh: every client is local.
    - ``rules`` (``partition.PartitionRules``): the server placement
      resolves through the shared rule layer; on the 1-D client mesh
      every rule adapts to replicated, so the round is bit-identical to
      no rules (`place_server`).
    - ``weights`` are the per-client aggregation weights (example counts
      for TFF parity); 0 leaves a client out.
    - ``faults`` (`faults.FaultPlan`): the plan's codes for the round
      (``round_idx``, default ``server.round``) are applied to the client
      updates after local training, each rank taking its block's codes;
      stragglers replay a cloned server from an internal per-round
      history (depth: the plan's staleness).
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
    layout = ClientLayout.of(mesh)
    place = place_server(mesh, rules)
    local_train = make_local_trainer(
        model, lr, loss_fn, local_epochs=local_epochs,
        batch_size=batch_size, trainable_mask=trainable_mask)
    history = StaleHistory(faults.max_staleness if faults else 0)

    def round_fn(server: ServerState, images, labels, weights, key: Key, *,
                 round_idx: int | None = None):
        w_all = torch.as_tensor(weights, dtype=torch.float32).cpu()
        n = w_all.shape[0]
        if n % layout.size:
            raise ValueError(
                f"got {n} client shards for a {layout.size}-rank client "
                f"mesh; pad with weight-0 clients to a multiple "
                f"(data.partition.pad_clients)")
        if faults is not None and faults.n_clients > n:
            raise ValueError(
                f"fault plan covers {faults.n_clients} clients but only "
                f"{n} client shards were passed")
        server = place(server.to(device))
        r = server.round if round_idx is None else int(round_idx)
        stale = (history(server, r, faults.staleness(r))
                 if faults is not None else None)
        if layout.outside:
            return layout.share(copy_tree(server), None)
        k = n // layout.size
        first = layout.index * k
        images = torch.as_tensor(layout.block(images, n), device=device,
                                 dtype=next(model.parameters()).dtype)
        labels = torch.as_tensor(layout.block(labels, n), device=device)
        if images.shape[0] != k:
            raise ValueError(f"{tuple(w_all.shape)} client weights for "
                             f"{images.shape[0]} client shards")
        w_host = w_all[first:first + k]
        glob = {**server.params, **server.state}
        client_p, client_s, losses, accs = train_clients(
            model, local_train, server, images, labels,
            w_host.numpy() > 0, key, first=first)
        faulted = None
        if faults is not None:
            codes, scales = faults.codes(r)
            pad = n - faults.n_clients
            codes = np.concatenate([codes, np.zeros((pad,), np.int32)])
            scales = np.concatenate([scales, np.ones((pad,), np.float32)])
            faulted = (
                torch.as_tensor(codes[first:first + k], device=device),
                torch.as_tensor(scales[first:first + k], device=device),
                stale)
        client_p, client_s, weight, dropped = screen_clients(
            client_p, client_s, losses, w_host.to(device), server, faulted)

        agg, agg_m = agg_fn({**client_p, **client_s}, weight, glob,
                            layout.group)
        sums = layout.sum({"wloss": robust.weighted_sum(losses, weight),
                           "wacc": robust.weighted_sum(accs, weight),
                           "total": robust.weight_total(weight),
                           "dropped": dropped})
        floor = torch.clamp(sums["total"], min=1e-30)
        m = float_metrics({"loss": sums["wloss"] / floor,
                           "accuracy": sums["wacc"] / floor,
                           "clients_dropped": sums["dropped"], **agg_m})
        if not float(sums["total"]) > 0:
            # every client dropped: keep the incoming server and report
            # NaN metrics -- an all-zero-weight mean would read as a
            # perfect 0.0 loss while training silently stalls
            agg = glob
            m["loss"] = m["accuracy"] = float("nan")
        return layout.share(
            ServerState(server.round + 1,
                        {k: agg[k] for k in server.params},
                        {k: agg[k] for k in server.state}), m)

    return round_fn


# examples a forward of the federated eval takes at a time (a whole
# shard is up to 3,000 patches at the fed preset)
_EVAL_CHUNK = 512


def make_federated_eval(model: nn.Module, loss_fn: LossFn, *, mesh=None,
                        device=None):
    """Build the federated evaluation (fed_model.py:210).

    Returns ``eval_fn(server, images [C, S, ...], labels [C, S], weights
    [C]) -> {"loss", "accuracy"}``: the global model in eval mode on every
    client shard of weight > 0, each client's loss and accuracy over its
    whole shard, example-weighted across clients (floats). Over a
    `mesh` (``mesh.client_mesh``) each rank evaluates its block of the
    clients (all C shards or its k, with the global [C] weights) and the
    weighted sums are the group's; a rank outside the mesh receives the
    result."""
    device = resolve_device(device)
    model.to(device)
    layout = ClientLayout.of(mesh)

    def eval_fn(server: ServerState, images, labels, weights):
        w_all = torch.as_tensor(weights, dtype=torch.float32).cpu()
        n = w_all.shape[0]
        if layout.outside:
            return layout.share_value(None)
        k = n // layout.size
        first = layout.index * k
        images = torch.as_tensor(layout.block(images, n),
                                 dtype=torch.float32, device=device)
        labels = torch.as_tensor(layout.block(labels, n), device=device)
        w_host = w_all[first:first + k]
        losses = torch.zeros(k, device=device)
        accs = torch.zeros(k, device=device)
        load_server(model, server.to(device)).eval()
        with torch.no_grad():
            for c in np.flatnonzero(w_host.numpy() > 0).tolist():
                logits = torch.cat([
                    model(x).float()
                    for x in images[c].split(_EVAL_CHUNK)])
                losses[c] = loss_fn(logits, labels[c])
                accs[c] = metrics_lib.auto_accuracy(logits, labels[c])
        weight = w_host.to(device)
        m = robust.weighted_means({"loss": losses, "accuracy": accs},
                                  weight, layout.group)
        m = torch.stack([m["loss"], m["accuracy"]]).tolist()
        return layout.share_value({"loss": m[0], "accuracy": m[1]})

    return eval_fn
