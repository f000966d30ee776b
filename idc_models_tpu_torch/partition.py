"""Rule-based sharding: regexes over named parameter paths -> specs, the
counterpart of ``idc_models_tpu/partition.py``.

- `PartitionRules`: ordered ``(regex, PartitionSpec)`` pairs, resolved
  against tree paths joined with "/" (``params/block0/mha/wq``). The
  first match wins, and ``re.search`` means a rule written for a
  parameter also matches the optimizer moment that mirrors it
  (``opt_state/0/nu/block0/mha/wq``): the moments shard with their
  parameter.
- Specs are right-aligned against each leaf's shape: ``P("model")`` on a
  [E, M] kernel splits M. Missing leading dims are not split.
- Mesh adaptation (`adapt`): axes the mesh lacks or holds at size 1 are
  dropped, and a dim its axes do not divide is replicated, so one rule
  set serves every mesh and a mesh can mix split and replicated leaves.
- Errors that teach: a non-scalar leaf no rule matches, a rule that
  matches no leaf and a spec of higher rank than its leaf raise
  `PartitionError` with the JAX package's messages.
- `shard_tree` / `gather_tree`: this rank's blocks of a tree, and the
  whole tree back from every rank's blocks.

A tree here is nested dicts (and lists or tuples) of tensors or arrays:
the JAX-shaped trees of ``convert.to_jax`` and `state_tree`, so the JAX
package's rules apply verbatim. Scalars and 1-element leaves always
replicate.
"""

from __future__ import annotations

import re
from collections.abc import Sequence

import numpy as np
import torch

from idc_models_tpu_torch import convert
from idc_models_tpu_torch import mesh as meshlib
from idc_models_tpu_torch.mesh import Mesh, PartitionSpec as P, Sharding

SEP = "/"


class PartitionError(ValueError):
    """A rules/tree mismatch with a teaching message."""


def _is_leaf(x) -> bool:
    return isinstance(x, P) or not isinstance(x, (dict, list, tuple))


def tree_map_with_path(fn, tree, path=()):
    """`fn(path, leaf)` over every leaf, keeping the containers (dict
    keys sorted, as ``jax.tree_util`` orders them)."""
    if _is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], path + (str(k),))
                for k in sorted(tree)}
    return type(tree)(tree_map_with_path(fn, v, path + (str(i),))
                      for i, v in enumerate(tree))


def path_str(path) -> str:
    return SEP.join(path)


def tree_paths(tree) -> list[tuple[str, object]]:
    """[(name, leaf)] for every leaf, names in "a/b/c" form."""
    out = []
    tree_map_with_path(lambda p, leaf: out.append((path_str(p), leaf)), tree)
    return out


def tree_map(fn, tree, *rest):
    """`fn(leaf, *leaves)` over trees of one structure."""
    if _is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                      for i, v in enumerate(tree))


def _leaf_shape(leaf) -> tuple:
    shape = getattr(leaf, "shape", None)
    return tuple(shape) if shape is not None else np.shape(leaf)


def adapt(spec: P, shape: tuple, mesh: Mesh) -> P:
    """Fit a right-aligned spec onto a concrete shape and mesh: drop the
    axes the mesh lacks or holds at size 1, replicate a dim its axes do
    not divide, and strip trailing Nones, so one layout has one
    spelling."""
    entries = (None,) * (len(shape) - len(spec)) + tuple(spec)
    out = []
    for dim, entry in zip(shape, entries):
        kept = [a for a in meshlib.axes_of(entry)
                if a in mesh.axis_names and mesh.shape[a] > 1]
        n = int(np.prod([mesh.shape[a] for a in kept])) if kept else 1
        if not kept or dim % n:
            out.append(None)
        else:
            out.append(kept[0] if len(kept) == 1 else tuple(kept))
    while out and out[-1] is None:
        out.pop()
    return P(*out)


class PartitionRules:
    """Ordered ``(regex, PartitionSpec)`` pairs resolved against named
    tree paths: the whole sharding policy of a model in one object (the
    module docstring gives the matching and adaptation rules)."""

    def __init__(self, rules: Sequence[tuple[str, P]]):
        if not rules:
            raise PartitionError(
                "PartitionRules needs at least one (regex, "
                "PartitionSpec) pair — for all-replicated use "
                "PartitionRules.replicated()")
        compiled = []
        for i, pair in enumerate(rules):
            if len(pair) != 2:
                raise PartitionError(
                    f"rule {i} must be a (regex, PartitionSpec) pair, "
                    f"got {pair!r}")
            pattern, spec = pair
            if not isinstance(spec, P):
                raise PartitionError(
                    f"rule {i} ({pattern!r}) maps to {spec!r} — the "
                    f"right side must be a PartitionSpec")
            axes = [a for e in spec for a in meshlib.axes_of(e)]
            if len(axes) != len(set(axes)):
                raise PartitionError(
                    f"rule {i} ({pattern!r}) names a mesh axis twice "
                    f"in {spec} — a tensor dim pair cannot share one "
                    f"axis")
            try:
                rx = re.compile(pattern)
            except re.error as e:
                raise PartitionError(
                    f"rule {i} regex {pattern!r} does not compile: "
                    f"{e}") from e
            compiled.append((pattern, rx, spec))
        self._rules = tuple(compiled)

    @classmethod
    def replicated(cls) -> "PartitionRules":
        """Everything replicated: the layout without rules."""
        return cls(((r".*", P()),))

    @property
    def patterns(self) -> tuple[str, ...]:
        return tuple(pattern for pattern, _, _ in self._rules)

    def __repr__(self) -> str:
        body = ", ".join(f"({pattern!r}, {spec})"
                         for pattern, _, spec in self._rules)
        return f"PartitionRules(({body}))"

    def _match(self, name: str):
        for i, (_, rx, spec) in enumerate(self._rules):
            if rx.search(name) is not None:
                return i, spec
        return None, None

    def _resolve_leaf(self, name: str, shape):
        """(matched rule index | None, un-adapted spec) for one leaf.
        Scalars and 1- or 0-element leaves replicate, matched or not;
        a non-scalar leaf no rule matches raises."""
        i, spec = self._match(name)
        if len(shape) == 0 or int(np.prod(shape)) <= 1:
            return i, P()
        if i is None:
            raise PartitionError(self._unmatched_msg(name, shape))
        if len(spec) > len(shape):
            raise PartitionError(
                f"rule {self.patterns[i]!r} carries a rank-{len(spec)} "
                f"spec {spec} but matched the rank-{len(shape)} param "
                f"{name!r} (shape {tuple(shape)}) — specs right-align "
                f"against the leaf shape and may not exceed its rank; "
                f"write a more specific rule for this leaf")
        return i, spec

    def spec_for(self, name: str, shape) -> P:
        """The un-adapted spec for one named leaf of `shape`."""
        return self._resolve_leaf(name, shape)[1]

    def _unmatched_msg(self, name, shape) -> str:
        return (f"no partition rule matches param {name!r} (shape "
                f"{tuple(shape)}); rules tried, in order: "
                f"{list(self.patterns)}. Add a rule for it, or end "
                f"the rule set with the catch-all (r'.*', "
                f"PartitionSpec()) to replicate everything unmatched")

    def specs(self, tree, *, mesh: Mesh | None = None,
              check_dead: bool = True):
        """A tree of specs for `tree`: adapted to `mesh` when given, raw
        otherwise. With `check_dead` a rule that matches no leaf raises
        (a renamed parameter has orphaned it)."""
        live = set()
        names_seen = []

        def resolve(path, leaf):
            name = path_str(path)
            shape = _leaf_shape(leaf)
            i, spec = self._resolve_leaf(name, shape)
            if i is not None:
                live.add(i)
            names_seen.append(name)
            return adapt(spec, shape, mesh) if mesh is not None else spec

        out = tree_map_with_path(resolve, tree)
        if check_dead and names_seen:
            dead = [self.patterns[i] for i in range(len(self._rules))
                    if i not in live]
            if dead:
                raise PartitionError(
                    f"dead partition rule(s) {dead}: they match none "
                    f"of the {len(names_seen)} leaves of this tree — "
                    f"a param rename has probably orphaned them "
                    f"(tests/test_partition.py freezes the golden "
                    f"param paths; update the rule or the model, "
                    f"or resolve with check_dead=False for a "
                    f"deliberately partial tree)")
        return out

    def shardings(self, mesh: Mesh, tree, *, check_dead: bool = True):
        """A tree of `Sharding` over `mesh`."""
        return tree_map(lambda spec: Sharding(mesh, spec),
                        self.specs(tree, mesh=mesh, check_dead=check_dead))


class BlockTree(dict):
    """A nested tree of this rank's blocks of a sharded tree (what
    ``checkpoint.restore_sharded`` gives on a mesh), carrying each
    leaf's whole shape in `whole` ("a/b/c" path -> shape). A consumer
    of whole trees (a serving engine's build, spot-check and swap) takes
    its leaves as already cut, with no gather."""

    def __init__(self, tree: dict, whole: dict):
        super().__init__(tree)
        self.whole = {k: tuple(v) for k, v in whole.items()}


def whole_shape(tree, path: str) -> tuple:
    """The whole shape of `tree`'s leaf at "a/b/c" `path`: its own
    shape, or the recorded one in a `BlockTree`."""
    if isinstance(tree, BlockTree):
        return tree.whole[path]
    node = tree
    for part in path.split("/"):
        node = node[part]
    return _leaf_shape(node)


def shard_tree(mesh: Mesh, rules: PartitionRules, tree, *,
               check_dead: bool = True, device=None):
    """This rank's block of every leaf of `tree` under `rules` (tensors,
    on `device` when given)."""
    sh = rules.shardings(mesh, tree, check_dead=check_dead)
    return tree_map(lambda a, s: meshlib.put_with_sharding(a, s, device),
                    tree, sh)


def gather_tree(mesh: Mesh, tree, specs):
    """The whole tree back from every rank's blocks: `specs` is the tree
    of specs (or shardings) `tree` was cut by. Every rank of the mesh
    must call it."""
    def gather(x, spec):
        spec = spec.spec if isinstance(spec, Sharding) else spec
        x = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
        return meshlib.gather_block(x, Sharding(mesh, spec))

    return tree_map(gather, tree, specs)


def state_tree(model: torch.nn.Module, optimizer=None, step: int = 0) -> dict:
    """A model (and its RMSprop) as the JAX package's TrainState tree:
    ``step``, ``params``, ``model_state`` (the buffers) and
    ``opt_state/0/nu/<param path>`` for each trained parameter's second
    moment, so the JAX rules resolve the port's state leaf for leaf."""
    params, buffers = convert.to_jax(model)
    tree = {"step": np.asarray(step, np.int32), "params": params,
            "model_state": buffers}
    if optimizer is not None:
        names = {id(p): n for n, p in model.named_parameters()}
        nu = {names[id(p)].replace(".", SEP):
              s["square_avg"].detach().cpu().numpy()
              for p, s in optimizer.state.items() if "square_avg" in s}
        tree["opt_state"] = [{"nu": convert.unflatten(nu)}]
    return tree
