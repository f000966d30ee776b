"""Byzantine-robust aggregation at the FedAvg round boundary.

The counterpart of ``idc_models_tpu/federated/robust.py``. Each rank
holds its own clients' updates on a leading [k] axis; `group` is the
"client" group the round's clients split over (``mesh.client_mesh``),
None when every client is local:

- ``WeightedMean`` ("mean", the default): the example-weighted mean;
- ``NormClip(c)`` ("norm_clip"): each client's update delta is
  L2-clipped to norm c across all its leaves before the mean, so one
  attacker moves the server at most c/n per round;
- ``TrimmedMean(t)`` ("trimmed_mean"): coordinate-wise, drop the t
  lowest and t highest values among the live clients and average the
  rest; tolerates t Byzantine clients and needs more than 2t live ones;
- ``Median`` ("median"): the coordinate-wise median.

The mean and the clip reduce over the group with one sum of the
partials; the order statistics all-gather the live clients' updates, as
the JAX package's ``_gathered_alive`` does. The order-statistic
aggregators need every client's plaintext value per coordinate, which
secure aggregation exists to prevent: the secure round refuses them by
name (`ORDER_STATISTIC`, `secure_compatible`).
"""

from __future__ import annotations

import torch

from idc_models_tpu_torch import collectives

Tree = dict[str, torch.Tensor]

# need a plaintext cross-client view: never secure-compatible
ORDER_STATISTIC = ("trimmed_mean", "median")


def weighted_sum(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Sum of `x` over its leading [C] client axis weighted by `weight`
    [C]; clients at weight <= 0 count for nothing, even when their value
    is not finite. The numerator of `weighted_mean`, and what a streamed
    round's waves accumulate (`federated/population.py`)."""
    w = torch.clamp(weight.float(), min=0.0)
    wx = w.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)
    return torch.where(wx > 0, x * wx, 0).sum(0)


def weight_total(weight: torch.Tensor) -> torch.Tensor:
    """The f32 sum of the positive weights: `weighted_mean`'s
    denominator before its 1e-30 floor."""
    return torch.clamp(weight.float(), min=0.0).sum()


def weighted_mean(x: torch.Tensor, weight: torch.Tensor,
                  group=None) -> torch.Tensor:
    """Mean of `x` over its leading [C] client axis, and over the
    group's ranks, weighted by `weight` [C]: `weighted_sum` over
    `weight_total`, each summed over `group`, floored at 1e-30 (all-zero
    weights give 0, not NaN). The JAX package's
    ``collectives.weighted_pmean_local``."""
    return weighted_means({"x": x}, weight, group)["x"]


def weighted_means(tree: dict, weight: torch.Tensor, group=None) -> dict:
    """`weighted_mean` of every leaf of `tree`, the leaves' partial sums
    and the weight total summed over `group` in one all-reduce a dtype."""
    sums = {n: weighted_sum(x, weight) for n, x in tree.items()}
    total = weight_total(weight)
    group_sum({"total": total, **sums}, group)
    total = torch.clamp(total, min=1e-30)
    return {n: s / total.to(s.dtype) for n, s in sums.items()}


def group_sum(values: dict, group=None) -> dict:
    """The tensors of `values` summed over `group` in place (one
    all-reduce a dtype); returns `values`. None is no group (never the
    default group of an initialized world)."""
    if group is not None:
        collectives.psum_(list(values.values()), group)
    return values


def _gathered(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's [k, ...] block of `x` stacked into [C, ...], in rank
    order (the clients' global order)."""
    if group is None or collectives.axis_size(group) == 1:
        return x
    return collectives.all_gather(x, group, axis=0, tiled=True)


class Aggregator:
    """One aggregation policy.

    ``per_client(updates, server)`` is the optional per-client transform:
    it takes the stacked client updates ({name: [k, ...]}) and the
    incoming global weights ({name: tensor}) and returns the transformed
    updates and ``{metric: [k] tensor}``. ``combine(updates, weight,
    server, group)`` reduces across the client axis and the group's
    ranks to the new global weights and scalar metrics. Calling the
    aggregator runs both and counts each per-client metric over the
    clients of weight > 0, on every rank of the group."""

    name = "base"
    secure_compatible = False

    def per_client(self, updates: Tree, server: Tree):
        return updates, {}

    def combine(self, updates: Tree, weight: torch.Tensor, server: Tree,
                group=None):
        raise NotImplementedError

    def __call__(self, updates: Tree, weight: torch.Tensor, server: Tree,
                 group=None):
        updates, per_client_m = self.per_client(updates, server)
        agg, metrics = self.combine(updates, weight, server, group)
        metrics.update(group_sum(
            {key: torch.where(weight > 0, vals, 0.0).sum()
             for key, vals in per_client_m.items()}, group))
        return agg, metrics

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"


class WeightedMean(Aggregator):
    """The example-weighted mean (weight 1 gives the reference's
    unweighted server, quirk Q7)."""

    name = "mean"
    secure_compatible = True

    def combine(self, updates, weight, server, group=None):
        return weighted_means(updates, weight, group), {}


class NormClip(Aggregator):
    """Per-client update-norm clipping before the weighted mean: the delta
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

    def combine(self, updates, weight, server, group=None):
        return weighted_means(updates, weight, group), {}

    def __repr__(self) -> str:
        return f"NormClip(max_norm={self.max_norm})"


def _dead_to_inf(x: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """`x` [C, ...] with the dead clients pinned to +inf, past every kept
    rank (NaNs sort after +inf, also out)."""
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    return torch.where(alive.reshape(shape), x,
                       torch.full((), float("inf"), dtype=x.dtype,
                                  device=x.device))


class TrimmedMean(Aggregator):
    """Coordinate-wise trimmed mean over the live clients (weight > 0):
    per coordinate, sort their values, drop the `trim` lowest and `trim`
    highest, and average the rest, unweighted (a Byzantine client could
    otherwise buy influence by claiming a huge example count). A plan
    that can never keep a value (2 * trim >= client slots) raises; a
    round whose live clients number 2 * trim or fewer keeps the incoming
    server weights and reports ``trim_degenerate`` = 1.

    ``clients_trimmed`` counts the live clients whose coordinates fell in
    the trimmed band at least 90% of the time: an honest client lands
    there about 2t/n of the time, an attacker nearly always."""

    name = "trimmed_mean"
    secure_compatible = False

    def __init__(self, trim: int = 1, *, track_clients: bool = True):
        if trim < 0:
            raise ValueError(f"need trim >= 0, got {trim}")
        self.trim = int(trim)
        self.track_clients = track_clients

    def combine(self, updates, weight, server, group=None):
        alive = _gathered(weight, group) > 0
        n_total = alive.shape[0]
        if n_total <= 2 * self.trim:
            raise ValueError(
                f"trim={self.trim} can never keep a value: only "
                f"{n_total} client slots exist and 2*trim of them are "
                f"always dropped — lower trim below {n_total / 2:.0f} "
                f"or add clients")
        lo = self.trim
        hi = alive.sum() - self.trim
        band_ok = hi > lo
        denom = torch.clamp(hi - lo, min=1).float()
        trimmed = torch.zeros(n_total, dtype=torch.float32,
                              device=weight.device)
        n_coords = 0
        agg = weighted_means({n: x for n, x in updates.items()
                              if not x.is_floating_point()}, weight, group)
        for n, x in updates.items():
            if not x.is_floating_point():
                continue
            x = _gathered(x, group)
            xm = _dead_to_inf(x, alive)
            # one stable sort gives the values and every client's rank;
            # stable, as JAX's argsort, so tied values (a frozen
            # parameter, the same in every update) rank by client index
            order = torch.argsort(xm, dim=0, stable=True)
            srt = xm.gather(0, order)
            shape = (n_total,) + (1,) * (x.dim() - 1)
            ranks = torch.arange(n_total, device=x.device).reshape(shape)
            keep = (ranks >= lo) & (ranks < hi)
            mean = torch.where(keep, srt, 0.0).float().sum(0) / denom
            if self.track_clients:
                rank_of = torch.empty_like(order).scatter_(
                    0, order, ranks.expand_as(order))
                out_of_band = (rank_of < lo) | (rank_of >= hi)
                trimmed += out_of_band.reshape(n_total, -1).sum(1).float()
                n_coords += x[0].numel()
            agg[n] = torch.where(band_ok, mean.to(x.dtype), server[n])
        metrics = {"trim_degenerate": (~band_ok).float()}
        if self.track_clients and n_coords:
            frac = trimmed / float(n_coords)
            metrics["clients_trimmed"] = torch.where(
                alive, (frac >= 0.9).float(), 0.0).sum()
        return agg, metrics

    def __repr__(self) -> str:
        return f"TrimmedMean(trim={self.trim})"


class Median(Aggregator):
    """Coordinate-wise median over the live clients: a minority coalition
    (< half the live clients) cannot move a coordinate outside the honest
    value range. Dead clients are pinned past the median (+inf); an even
    count averages the two middle order statistics."""

    name = "median"
    secure_compatible = False

    def combine(self, updates, weight, server, group=None):
        alive = _gathered(weight, group) > 0
        n_alive = alive.sum()
        i_lo = torch.clamp((n_alive - 1) // 2, min=0)
        i_hi = torch.clamp(n_alive // 2, min=0)
        agg = weighted_means({n: x for n, x in updates.items()
                              if not x.is_floating_point()}, weight, group)
        for n, x in updates.items():
            if not x.is_floating_point():
                continue
            srt = torch.sort(_dead_to_inf(_gathered(x, group), alive),
                             dim=0).values
            # where, not a product: inf * 0 at the dead tail is NaN
            med = (srt[i_lo].float() + srt[i_hi].float()) / 2.0
            agg[n] = med.to(x.dtype)
        return agg, {}


_BY_NAME = {"mean": WeightedMean, "trimmed_mean": TrimmedMean,
            "median": Median, "norm_clip": NormClip}


def get_aggregator(spec, **kwargs) -> Aggregator:
    """None -> WeightedMean; a name from {mean, trimmed_mean, median,
    norm_clip} (kwargs forwarded, e.g. trim=3 / max_norm=5.0); or an
    Aggregator instance, passed through."""
    if spec is None:
        return WeightedMean()
    if isinstance(spec, Aggregator):
        if kwargs:
            raise ValueError("kwargs only apply when building by name")
        return spec
    if spec in _BY_NAME:
        return _BY_NAME[spec](**kwargs)
    raise ValueError(f"unknown aggregator {spec!r}; one of "
                     f"{sorted(_BY_NAME)} or an Aggregator instance")
