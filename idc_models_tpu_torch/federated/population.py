"""Population-scale federated training: virtual clients, cohort
sampling, and streamed wave aggregation.

The counterpart of ``idc_models_tpu/federated/population.py``.
`make_fedavg_round` materializes every client's shard; at a
population of 10k+ clients memory would grow with the population, and a
synchronous barrier waits on its slowest member. Production FL systems
(Bonawitz et al., *Towards Federated Learning at Scale*) instead SELECT a
small cohort each round and aggregate it in a stream:

- `ClientPopulation`: virtual clients whose shards derive lazily from
  ``(seed, client id)``. No population-sized array ever exists (the AST
  scan in tests/test_torch_population.py); memory is bounded by what a
  wave materializes.
- `CohortSampler`: the round's cohort, a pure function of ``(seed,
  round)``, uniform (Floyd's algorithm) or weighted by size (rejection
  against the population's weight bound). There is no sampler state to
  checkpoint: a resume at round r draws round r's cohort again, and the
  ids equal the JAX package's bit for bit (numpy only).
- `make_population_round`: a driver-compatible round that streams the
  cohort through fixed-size WAVES. Each wave uploads O(wave) client data
  once, trains its clients in turn on the one working module
  (`fedavg.train_clients`), applies faults and the divergence test
  (`fedavg.screen_clients`) and folds the masked weighted sums into a
  running aggregate that is divided once, at the end. Server memory is
  O(wave) plus one accumulator, constant in population and cohort. Over
  a "client" mesh of D ranks (D dividing the wave) each rank trains its
  wave_size/D of every wave and the wave's sums take one sum over the
  group before they fold in.

Parity: a wave runs the one-shot round's own code, and client ``i`` of
a cohort trains with ``client_generator(key, i)``, its COHORT POSITION
(as the JAX package folds the round key by cohort position). So one wave
covering the cohort is `make_fedavg_round` on the materialized cohort,
bit for bit; other splits change only the order the waves' sums are
added in, and a round replays bit for bit from ``(seed, round)``.

Aggregators: ``WeightedMean`` and ``NormClip`` stream exactly (a
per-client transform, then a weighted sum). ``TrimmedMean`` runs PER
WAVE: each wave trims its own extremes and the wave results combine as a
running mean weighted by each wave's live clients; a wave too small to
keep a value (``wave_size <= 2 * trim``) is refused at build. ``Median``
is refused with a teaching error.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch import nn

from idc_models_tpu_torch import resolve_device
from idc_models_tpu_torch.data import synthetic
from idc_models_tpu_torch.federated import robust
from idc_models_tpu_torch.observe import metrics_registry as mreg
from idc_models_tpu_torch.federated.fedavg import (
    ClientLayout, Key, LossFn, ServerState, StaleHistory, copy_tree,
    float_metrics, make_local_trainer, place_server, screen_clients,
    train_clients,
)


class ClientPopulation:
    """`size` virtual clients, each a pure function of (seed, id).

    `shard(cid)` synthesizes the client's data lazily --
    `data.synthetic.make_idc_like` seeded by ``(seed, 1, cid)``, the JAX
    package's bytes -- and `weight(cid)` is the
    client's aggregation weight (its dataset-size proxy), seeded uniform
    in `weight_range`. Shards are fixed-shape so cohorts stack; the
    weight models differing dataset sizes (it drives the weighted
    sampler and the round's example weighting). The only O(population)
    helper is `all_weights`, for tests."""

    def __init__(self, size: int, *, examples_per_client: int = 16,
                 image_size: int = 10, seed: int = 0,
                 weight_range: tuple[float, float] = (1.0, 1.0)):
        if size < 1:
            raise ValueError(f"need a population of >= 1 virtual "
                             f"clients, got {size}")
        if examples_per_client < 1:
            raise ValueError(f"need examples_per_client >= 1, got "
                             f"{examples_per_client}")
        lo, hi = float(weight_range[0]), float(weight_range[1])
        if not (0.0 < lo <= hi):
            raise ValueError(f"weight_range must satisfy 0 < lo <= hi, "
                             f"got {weight_range}")
        self.size = int(size)
        self.examples_per_client = int(examples_per_client)
        self.image_size = int(image_size)
        self.seed = int(seed)
        self.weight_range = (lo, hi)

    @property
    def weight_max(self) -> float:
        """The known upper bound the weighted sampler rejects against."""
        return self.weight_range[1]

    def _check_cid(self, cid: int) -> int:
        cid = int(cid)
        if not 0 <= cid < self.size:
            raise ValueError(f"virtual client id {cid} outside the "
                             f"population (0..{self.size - 1})")
        return cid

    def shard(self, cid: int) -> tuple[np.ndarray, np.ndarray]:
        """(imgs [S,H,W,3] f32, labels [S] i32), derived lazily: the same
        bytes on every call."""
        cid = self._check_cid(cid)
        return synthetic.make_idc_like(
            self.examples_per_client, size=self.image_size,
            seed=(self.seed, 1, cid))

    def weight(self, cid: int) -> float:
        cid = self._check_cid(cid)
        lo, hi = self.weight_range
        if lo == hi:
            return lo
        u = np.random.default_rng((self.seed, 2, cid)).random()
        return lo + (hi - lo) * u

    def materialize(self, ids) -> tuple[np.ndarray, np.ndarray,
                                        np.ndarray]:
        """Stack a cohort or wave: (imgs [C,S,...], labels [C,S], weights
        [C] f32), O(len(ids)) memory -- the only way client data ever
        exists on the host."""
        imgs, labels, weights = [], [], []
        for cid in np.asarray(ids, np.int64):
            im, lb = self.shard(int(cid))
            imgs.append(im)
            labels.append(lb)
            weights.append(self.weight(int(cid)))
        return (np.stack(imgs), np.stack(labels),
                np.asarray(weights, np.float32))

    def all_weights(self) -> np.ndarray:
        """[size] weights: the one deliberately O(population) helper, for
        checking the weighted sampler's distribution on SMALL populations
        in tests. Never on the training path."""
        out = np.empty((self.size,), np.float32)
        for cid in range(self.size):
            out[cid] = self.weight(cid)
        return out

    def same_config(self, other: "ClientPopulation") -> bool:
        """True when `other` derives the SAME virtual clients: the check
        between a sampler and the round made over it (identity is too
        strict: a process restart makes both again)."""
        return (self.size == other.size
                and self.examples_per_client == other.examples_per_client
                and self.image_size == other.image_size
                and self.seed == other.seed
                and self.weight_range == other.weight_range)

    def __repr__(self) -> str:
        return (f"ClientPopulation(size={self.size}, "
                f"examples_per_client={self.examples_per_client}, "
                f"seed={self.seed}, weight_range={self.weight_range})")


class CohortSampler:
    """Deterministic per-round cohort selection over a `ClientPopulation`.

    `cohort(r)` is a pure function of ``(seed, r)``: there is no mutable
    sampler state, so the driver checkpoints only the server's round and
    a resumed run draws every later cohort again, byte for byte. Uniform
    sampling is Floyd's algorithm (O(cohort) memory, no population-sized
    permutation); ``weighted=True`` samples without replacement in
    proportion to ``population.weight(cid)`` by rejection against the
    population's `weight_max`, in O(cohort) memory."""

    def __init__(self, population: ClientPopulation, cohort_size: int,
                 *, seed: int = 0, weighted: bool = False):
        if not 1 <= cohort_size <= population.size:
            raise ValueError(
                f"cohort_size must be in [1, population={population.size}"
                f"], got {cohort_size} — a cohort cannot exceed the "
                f"population it samples from")
        self.population = population
        self.cohort_size = int(cohort_size)
        self.seed = int(seed)
        self.weighted = bool(weighted)

    def cohort(self, round_idx: int) -> np.ndarray:
        """[cohort_size] sorted unique virtual-client ids for one round,
        the same across calls, processes and resumes."""
        rng = np.random.default_rng((self.seed, 3, int(round_idx)))
        if self.weighted:
            return self._weighted(rng)
        return self._uniform(rng)

    def _uniform(self, rng) -> np.ndarray:
        n, k = self.population.size, self.cohort_size
        chosen: set[int] = set()
        for j in range(n - k, n):
            t = int(rng.integers(0, j + 1))
            if t in chosen:
                t = j
            chosen.add(t)
        return np.sort(np.fromiter(chosen, np.int64, len(chosen)))

    def _weighted(self, rng) -> np.ndarray:
        n, k = self.population.size, self.cohort_size
        w_max = self.population.weight_max
        chosen: set[int] = set()
        draws, limit = 0, max(10_000, 1_000 * k)
        while len(chosen) < k:
            draws += 1
            if draws > limit:
                raise RuntimeError(
                    f"weighted cohort sampling did not converge after "
                    f"{limit} draws (cohort {k} of {n}; is weight_max "
                    f"{w_max} far above the typical weight?)")
            c = int(rng.integers(0, n))
            if c in chosen:
                continue
            if rng.random() * w_max <= self.population.weight(c):
                chosen.add(c)
        return np.sort(np.fromiter(chosen, np.int64, len(chosen)))

    def client_at(self, i: int) -> int:
        """The i-th client of the continuous dispatch stream, the async
        server's unit of selection (with replacement over time): a pure
        function of ``(seed, i)``."""
        rng = np.random.default_rng((self.seed, 4, int(i)))
        n = self.population.size
        if not self.weighted:
            return int(rng.integers(0, n))
        w_max = self.population.weight_max
        for _ in range(100_000):
            c = int(rng.integers(0, n))
            if rng.random() * w_max <= self.population.weight(c):
                return c
        raise RuntimeError("weighted stream sampling did not converge")

    def __repr__(self) -> str:
        return (f"CohortSampler(population={self.population.size}, "
                f"cohort_size={self.cohort_size}, seed={self.seed}, "
                f"weighted={self.weighted})")


def _teach_aggregator(agg) -> str:
    if isinstance(agg, robust.Median):
        return (
            "Median cannot stream: the coordinate-wise median needs "
            "every cohort member's value at once, and a per-wave "
            "median of means is a DIFFERENT estimator with weaker "
            "guarantees. Use trimmed_mean (runs per wave with the "
            "documented per-wave tolerance) or the one-shot "
            "make_fedavg_round for exact cross-cohort order statistics.")
    return (
        f"aggregator {agg!r} has no streaming strategy: streamed "
        f"rounds support mean/norm_clip (exact — per-client transform "
        f"+ weighted mean) and trimmed_mean (per-wave, documented in "
        f"docs/ROBUSTNESS.md).")


def make_population_round(
    model: nn.Module,
    lr: float,
    loss_fn: LossFn,
    population: ClientPopulation,
    sampler: CohortSampler,
    *,
    wave_size: int,
    local_epochs: int = 1,
    batch_size: int = 32,
    aggregator=None,
    faults=None,
    barrier_sleep: bool = False,
    logger=None,
    log_from_round: int = -1,
    mesh=None,
    rules=None,
    device=None,
):
    """Build the streamed population round.

    Returns ``round_fn(server, images, labels, weights, key, *,
    round_idx=None) -> (server, metrics)``, driver-compatible
    (`federated/driver.py` `run_rounds`): `images` and `labels` are
    unused (the population makes each wave's data), and `weights`, when
    given, is a [cohort_size] participation MASK over cohort positions
    (the driver's reseeded-subset retry zeroes members); None or ones is
    full participation. `model` is the working module, moved to `device`
    (CUDA unless "cpu" is asked for); clients train every parameter with
    a fresh RMSprop at `lr`. Each round:

    1. ``sampler.cohort(r)`` draws the round's virtual clients;
    2. the cohort streams through ``cohort_size / wave_size`` waves, each
       uploaded once in the model's dtype, trained, screened and folded
       into the running sums;
    3. the sums are divided once; when no client survives, the incoming
       server is kept and ``loss`` and ``accuracy`` are NaN.

    `faults` is a `faults.PopulationFaultPlan`: its codes address VIRTUAL
    ids and are evaluated per cohort; stragglers replay the server of
    round r - k from a history of clones. With ``barrier_sleep=True`` the
    round also sleeps max(plan delay) over the participants: the barrier
    a straggler imposes on a synchronous round, which the async server
    (`async_fedavg.py`) removes.

    `logger` (`observe.JsonlLogger`) gets one ``fed_cohort`` record per
    round above `log_from_round` (a driver retry does not log twice).

    Over a `mesh` (``mesh.client_mesh(D)``, D dividing `wave_size`) rank
    i trains wave positions ``i*k .. i*k+k-1`` of every wave (k =
    wave_size/D), materializing only those clients, under their cohort
    positions; each wave's sums take one sum over the group and fold into
    the running aggregate on every rank (the JAX package's ``psum``). A
    rank outside the mesh receives the round's result. `rules` resolve
    the server placement as `fedavg.make_fedavg_round`'s do
    (bit-identical to none on the client mesh). The metrics are
    floats: ``loss``, ``accuracy``, ``clients_dropped``,
    the aggregator's, and ``cohort``, ``participants`` and ``waves``."""
    device = resolve_device(device)
    model.to(device)
    agg = robust.get_aggregator(aggregator)
    cohort_size = sampler.cohort_size
    if not population.same_config(sampler.population):
        raise ValueError(
            "sampler and round must draw from the same virtual "
            "population (size/seed/shape differ) — they would train "
            "different clients than they sampled")
    if wave_size < 1 or cohort_size % wave_size:
        raise ValueError(
            f"wave_size {wave_size} must divide the cohort "
            f"({cohort_size}) — waves are fixed-shape so one compiled "
            f"program serves every wave")
    layout = ClientLayout.of(mesh)
    place = place_server(mesh, rules)
    if wave_size % layout.size:
        raise ValueError(
            f"wave_size {wave_size} must be a multiple of the "
            f"{layout.size}-device client mesh (each device trains "
            f"wave_size/devices clients per wave)")
    per_wave_mode = isinstance(agg, robust.TrimmedMean)
    if isinstance(agg, robust.Median) or not isinstance(
            agg, (robust.WeightedMean, robust.NormClip,
                  robust.TrimmedMean)):
        raise ValueError(_teach_aggregator(agg))
    if per_wave_mode and wave_size <= 2 * agg.trim:
        raise ValueError(
            f"trim={agg.trim} can never keep a value inside a "
            f"{wave_size}-client wave (2*trim are always dropped) — "
            f"trimmed_mean runs PER WAVE when streamed, so lower trim "
            f"below {wave_size / 2:.0f} or grow wave_size")
    if faults is not None and faults.population != population.size:
        raise ValueError(
            f"fault plan covers a population of {faults.population} "
            f"but the round trains {population.size} virtual clients")

    local_train = make_local_trainer(
        model, lr, loss_fn, local_epochs=local_epochs,
        batch_size=batch_size)
    history = StaleHistory(faults.max_staleness if faults else 0)
    n_waves = cohort_size // wave_size
    logged_rounds: set[int] = set()
    m_cohort = mreg.REGISTRY.gauge(
        "fed_cohort_size", "virtual clients sampled into the last "
        "federated round's cohort")
    m_sampled = mreg.REGISTRY.counter(
        "fed_clients_sampled_total", "virtual clients sampled into "
        "round cohorts, cumulative")

    def round_fn(server: ServerState, images=None, labels=None,
                 weights=None, key: Key = (0,), *,
                 round_idx: int | None = None):
        r = server.round if round_idx is None else int(round_idx)
        ids = sampler.cohort(r)
        mask = (np.ones((cohort_size,), np.float32) if weights is None
                else np.asarray(torch.as_tensor(weights).cpu(), np.float32))
        if mask.shape != (cohort_size,):
            raise ValueError(
                f"weights must be a [{cohort_size}] cohort-position "
                f"participation mask, got shape {mask.shape}")
        server = place(server.to(device))
        glob = {**server.params, **server.state}
        codes = scales = stale = None
        if faults is not None:
            codes, scales = faults.codes_for(r, ids)
            stale = history(server, r, faults.staleness(r))
            if barrier_sleep and faults.delay_unit_s > 0:
                # the synchronous barrier: the round is not done until
                # its slowest participating member reports
                wait = float(np.max(faults.delay_s(r, ids) * (mask > 0),
                                    initial=0.0))
                if wait > 0:
                    time.sleep(wait)

        if layout.outside:
            server, m = layout.share(copy_tree(server), None)
        else:
            server, m = layout.share(*waves(server, glob, ids, mask, key,
                                             codes, scales, stale))
        participants = int((mask > 0).sum())
        m_cohort.set(cohort_size)
        m_sampled.inc(participants)
        m.update(cohort=cohort_size, participants=participants,
                 waves=n_waves)
        if (logger is not None and r > log_from_round
                and r not in logged_rounds):
            # one record per ROUND: a driver retry re-runs the round
            # but must not append a duplicate to the append-only log
            logged_rounds.add(r)
            logger.log(event="fed_cohort", round=r, mode="sync",
                       population=population.size, cohort=cohort_size,
                       participants=participants, waves=n_waves,
                       wave_size=wave_size)
        return server, m

    def waves(server, glob, ids, mask, key, codes, scales, stale):
        """The round's waves on this rank: (new server, metrics)."""
        dtype = next(model.parameters()).dtype
        zero = torch.zeros((), device=device)
        acc = None
        acc_w = zero
        sums = {"wloss": zero, "wacc": zero, "wtotal": zero,
                "dropped": zero}
        k = wave_size // layout.size
        for wv in range(n_waves):
            # this rank's positions of the wave
            start = wv * wave_size + layout.index * k
            sl = slice(start, start + k)
            imgs_w, labels_w, w_w = population.materialize(ids[sl])
            w_w = w_w * (mask[sl] > 0)
            params, state, losses, accs = train_clients(
                model, local_train, server,
                torch.as_tensor(imgs_w, dtype=dtype, device=device),
                torch.as_tensor(labels_w, device=device), w_w > 0, key,
                first=sl.start)
            faulted = None if codes is None else (
                torch.as_tensor(codes[sl], device=device),
                torch.as_tensor(scales[sl], device=device), stale)
            params, state, weight, dropped = screen_clients(
                params, state, losses, torch.as_tensor(w_w, device=device),
                server, faulted)
            updates, pc_m = agg.per_client({**params, **state}, glob)
            # the one-shot round's metric weighting, as running sums
            wave = {"wloss": robust.weighted_sum(losses, weight),
                    "wacc": robust.weighted_sum(accs, weight),
                    "wtotal": robust.weight_total(weight),
                    "dropped": dropped}
            for name, vals in pc_m.items():
                wave[name] = torch.where(weight > 0, vals, 0.0).sum()
            if per_wave_mode:
                # a wave's trimmed mean, weighted by its live clients; a
                # degenerate wave (no kept band) weighs 0 instead of
                # smuggling the incoming server into the average
                wave["live"] = (weight > 0).sum().float()
                layout.sum(wave)
                wave_agg, agg_m = agg.combine(updates, weight, glob,
                                              layout.group)
                vw = wave.pop("live") * (1.0 - agg_m["trim_degenerate"])
                part = {n: vw.to(x.dtype) * x for n, x in wave_agg.items()}
                acc_w = acc_w + vw
                wave["degenerate_waves"] = agg_m["trim_degenerate"]
                if "clients_trimmed" in agg_m:
                    wave["clients_trimmed"] = agg_m["clients_trimmed"]
            else:
                # the one-shot mean's masked weighted sum, summed over the
                # group with the wave's metrics; the division comes once,
                # after the last wave
                part = {n: robust.weighted_sum(x, weight)
                        for n, x in updates.items()}
                layout.sum({**wave, **part})
                acc_w = acc_w + wave["wtotal"]
            # the first wave's sums are taken as they are, so a single
            # wave divides exactly what the one-shot round divides
            acc = part if acc is None else {n: acc[n] + part[n]
                                            for n in acc}
            sums = {n: sums.get(n, zero) + v for n, v in wave.items()}
            # free this wave's stack before the next one is built
            del params, state, updates, part

        total = torch.clamp(acc_w, min=1e-30)
        floor = torch.clamp(sums["wtotal"], min=1e-30)
        m = {"loss": sums["wloss"] / floor, "accuracy": sums["wacc"] / floor,
             "clients_dropped": sums["dropped"],
             **{n: v for n, v in sums.items()
                if n not in ("wloss", "wacc", "wtotal", "dropped")}}
        if per_wave_mode:
            m["trim_degenerate"] = (sums["degenerate_waves"] > 0).float()
        m = float_metrics(m)
        if float(acc_w) > 0:
            new = {n: a / total.to(a.dtype) for n, a in acc.items()}
        else:
            new = glob
            m["loss"] = m["accuracy"] = float("nan")
        return ServerState(server.round + 1,
                           {n: new[n] for n in server.params},
                           {n: new[n] for n in server.state}), m

    round_fn.sampler = sampler
    round_fn.population = population
    return round_fn
