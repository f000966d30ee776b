"""Round-boundary aggregators that can ride secure aggregation.

The counterpart of ``idc_models_tpu/federated/robust.py`` for the
secure-compatible policies -- a per-client transform followed by a mean:

- ``WeightedMean`` ("mean", the default): no transform;
- ``NormClip(c)`` ("norm_clip"): each client's update delta is L2-clipped
  to norm c across all its leaves before the mean, so one attacker moves
  the server at most c/n per round.

The order-statistic aggregators (``trimmed_mean``, ``median``) need every
client's plaintext value per coordinate, which secure aggregation exists
to prevent; they come with the plain FedAvg round, and the secure round
rejects them by name.
"""

from __future__ import annotations

import torch

Tree = dict[str, torch.Tensor]

# needs a plaintext cross-client view: never secure-compatible
ORDER_STATISTIC = ("trimmed_mean", "median")


class Aggregator:
    """One aggregation policy. ``per_client(updates, server)`` takes the
    stacked client updates ({name: [C, ...]}) and the incoming global
    weights ({name: tensor}) and returns the transformed updates and
    ``{metric: [C] tensor}``."""

    name = "base"
    secure_compatible = False

    def per_client(self, updates: Tree, server: Tree):
        return updates, {}

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"


class WeightedMean(Aggregator):
    """The mean (unweighted in the secure round, as the reference's
    server, quirk Q7)."""

    name = "mean"
    secure_compatible = True


class NormClip(Aggregator):
    """Per-client update-norm clipping before the mean: the delta
    (update - server) is L2-clipped across ALL floating leaves to
    `max_norm`; updates below it are untouched (factor exactly 1)."""

    name = "norm_clip"
    secure_compatible = True

    def __init__(self, max_norm: float = 10.0):
        if not max_norm > 0:
            raise ValueError(f"need max_norm > 0, got {max_norm}")
        self.max_norm = float(max_norm)

    def per_client(self, updates: Tree, server: Tree):
        names = [n for n, t in updates.items() if t.is_floating_point()]
        k = next(iter(updates.values())).shape[0]
        sq = torch.zeros(k, dtype=torch.float32,
                         device=next(iter(updates.values())).device)
        for n in names:
            d = (updates[n] - server[n][None]).float()
            sq = sq + (d * d).reshape(k, -1).sum(1)
        norm = torch.sqrt(sq)
        factor = torch.clamp(self.max_norm / torch.clamp(norm, min=1e-12),
                             max=1.0)
        clipped = dict(updates)
        for n in names:
            new, old = updates[n], server[n][None]
            f = factor.reshape((k,) + (1,) * (new.dim() - 1)).to(new.dtype)
            clipped[n] = old + f * (new - old)
        return clipped, {"clients_clipped": (norm > self.max_norm).float()}

    def __repr__(self) -> str:
        return f"NormClip(max_norm={self.max_norm})"


_BY_NAME = {"mean": WeightedMean, "norm_clip": NormClip}


def get_aggregator(spec, **kwargs) -> Aggregator:
    """None -> WeightedMean; a name from {mean, norm_clip} (kwargs
    forwarded, e.g. max_norm=5.0); or an Aggregator instance."""
    if spec is None:
        return WeightedMean()
    if isinstance(spec, Aggregator):
        if kwargs:
            raise ValueError("kwargs only apply when building by name")
        return spec
    if spec in _BY_NAME:
        return _BY_NAME[spec](**kwargs)
    if spec in ORDER_STATISTIC:
        raise ValueError(f"aggregator {spec!r} is not ported yet: it comes "
                         f"with the plain FedAvg round")
    raise ValueError(f"unknown aggregator {spec!r}; one of "
                     f"{sorted(_BY_NAME)} or an Aggregator instance")
