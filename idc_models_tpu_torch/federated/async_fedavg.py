"""Buffered asynchronous FedAvg (FedBuff): stragglers stop gating the
round.

The counterpart of ``idc_models_tpu/federated/async_fedavg.py`` on one
card. A synchronous round, one-shot or streamed (`population.py`), is a
BARRIER: the server cannot update until its slowest cohort member
reports. The buffered server (Nguyen et al., *FedBuff*) removes it:

- a continuous sampled dispatch stream keeps `concurrency` virtual
  clients in flight; each trains from the server weights of its dispatch
  moment and completes after a seeded duration (base latency plus the
  fault plan's straggler delay);
- completions fill a buffer of size K; a full buffer makes ONE
  staleness-weighted server update (weight x ``staleness_decay**s``, s
  the server updates since the client's dispatch);
- a straggler's slot is refilled: its update lands later with a larger
  discount while the server moves on.

Mapped onto `federated/driver.py` `run_rounds`, one driver round
processes `cohort_size` completions (however many updates they make), so
retries, rollback, checkpoints and ``round_health`` records apply
unchanged.

Memory: the in-flight pool is (arrival, dispatch index, client, version,
code, scale) tuples plus one clone on the card per server version still
referenced, counted by reference: O(concurrency), independent of the
population.

Determinism: every choice (dispatch stream, durations, fault codes, the
client's generator) is a pure function of (seed, dispatch index), and
arrivals pop in (arrival, dispatch index) order, so a run replays bit for
bit, and its schedule (participants, versions, staleness) equals the JAX
package's. A resumed run starts with an empty in-flight pool at the
checkpointed round: in-flight work is not checkpointed, as a real server
restart loses it.

Secure aggregation cannot compose with buffering: pairwise masks cancel
only when the full cohort sums together (`ensure_async_compatible`).
"""

from __future__ import annotations

import heapq
import time
from typing import Any

import numpy as np
import torch
from torch import nn

from idc_models_tpu_torch import faults as faults_lib
from idc_models_tpu_torch import resolve_device
from idc_models_tpu_torch.federated import robust
from idc_models_tpu_torch.observe import metrics_registry as mreg
from idc_models_tpu_torch.federated.fedavg import (
    LossFn, ServerState, client_generator, copy_tree, load_server,
    make_local_trainer,
)
from idc_models_tpu_torch.federated.population import (
    ClientPopulation, CohortSampler,
)

# staleness histogram buckets of the fed_cohort record: updates at lag
# 0, 1, 2, 3, 4 and a 5+ tail (frozen with the record's schema)
STALENESS_BUCKETS = 6


def ensure_async_compatible(*, secure: bool, aggregator=None) -> None:
    """Refuse, at build, compositions the buffered server cannot honour.

    Secure aggregation: pairwise masks cancel only in the sum over the
    FULL round cohort, so a buffered K-of-N update would carry the
    unmatched masks into the server weights. Trimmed mean and median:
    order statistics need a synchronized cohort view, the barrier that
    async removes; norm_clip composes exactly."""
    if secure:
        raise ValueError(
            "async buffered FedAvg cannot compose with secure "
            "aggregation: pairwise masks cancel only when the FULL "
            "cohort sums together in one round, and a buffered K-of-N "
            "update leaves unmatched masks in the aggregate — run "
            "secure rounds synchronously, or drop --async-buffer")
    if aggregator is not None and isinstance(
            aggregator, (robust.TrimmedMean, robust.Median)):
        raise ValueError(
            f"{type(aggregator).__name__} cannot compose with async "
            f"buffering: coordinate-wise order statistics need a "
            f"synchronized cohort view, which is exactly the barrier "
            f"the buffer removes — use norm_clip (per-client bound, "
            f"composes exactly) or the sync streamed round")


def make_async_round(
    model: nn.Module,
    lr: float,
    loss_fn: LossFn,
    population: ClientPopulation,
    sampler: CohortSampler,
    *,
    buffer_size: int,
    staleness_decay: float = 0.9,
    local_epochs: int = 1,
    batch_size: int = 32,
    aggregator=None,
    faults=None,
    base_latency_s: tuple[float, float] = (0.0, 0.0),
    realtime: bool = False,
    seed: int = 0,
    logger=None,
    log_from_round: int = -1,
    device=None,
):
    """Build the buffered asynchronous round on one card.

    ``round_fn(server, images, labels, weights, key, *, round_idx=None)``
    processes `cohort_size` client completions: dispatches keep
    `concurrency` (the cohort size) clients in flight from the
    continuous sampled stream, and every `buffer_size` completions make
    one staleness-weighted server update. `weights`, when given, only
    sets how many completions the attempt processes (the driver's
    reseeded-subset retry shrinks it); `images`, `labels` and `key` are
    unused (the stream is a pure function of (seed, dispatch index)).
    `model` is the working module, moved to `device` (CUDA unless "cpu"
    is asked for); a client trains on it from its dispatch-time snapshot
    every parameter with a fresh RMSprop at `lr` and the generator
    ``client_generator((seed,), dispatch index)``.

    `aggregator` may be None / mean (the staleness-weighted mean) or
    norm_clip (each buffered delta is L2-clipped before weighting);
    trimmed mean and median are refused (`ensure_async_compatible`,
    which the CLI also asks to refuse secure mode). Fault codes transform the buffered
    deltas as the sync round's do; a crashed dispatch never completes and
    its slot is refilled; straggler codes act through the plan's delay.

    ``realtime=True`` maps simulated arrival times onto the wall clock,
    sleeping until each processed completion's arrival: the mode the
    wall-clock drills run.

    The metrics are floats: ``loss`` and ``accuracy`` (weighted by the
    clients' weights), ``clients_dropped``, ``clients_clipped``,
    ``cohort``, ``participants``, ``updates``, ``buffer_fill``,
    ``staleness_mean``, ``staleness_max`` and ``crashed``;
    ``round_fn.last_participants`` holds the round's client ids in
    completion order."""
    device = resolve_device(device)
    model.to(device)
    agg = robust.get_aggregator(aggregator)
    ensure_async_compatible(secure=False, aggregator=agg)
    clip_norm = agg.max_norm if isinstance(agg, robust.NormClip) else None
    if buffer_size < 1:
        raise ValueError(f"need buffer_size >= 1, got {buffer_size}")
    if not 0.0 < staleness_decay <= 1.0:
        raise ValueError(
            f"staleness_decay must be in (0, 1], got {staleness_decay} "
            f"(1.0 = no discount; smaller discounts staler updates "
            f"harder)")
    concurrency = sampler.cohort_size
    if buffer_size > concurrency:
        raise ValueError(
            f"buffer_size {buffer_size} > concurrency {concurrency}: "
            f"the buffer could never fill — shrink the buffer or raise "
            f"concurrency")
    lo, hi = float(base_latency_s[0]), float(base_latency_s[1])
    if not 0.0 <= lo <= hi:
        raise ValueError(f"base_latency_s must be 0 <= lo <= hi, got "
                         f"{base_latency_s}")
    if faults is not None and faults.population != population.size:
        raise ValueError(
            f"fault plan covers a population of {faults.population} "
            f"but the server trains {population.size} virtual clients")
    if not population.same_config(sampler.population):
        raise ValueError(
            "sampler and server must draw from the same virtual "
            "population (size/seed/shape differ) — the server would "
            "train different clients than it sampled")

    local_train = make_local_trainer(
        model, lr, loss_fn, local_epochs=local_epochs,
        batch_size=batch_size)
    K = int(buffer_size)
    m_buffer = mreg.REGISTRY.gauge(
        "fed_buffer_fill", "client updates currently buffered by the "
        "async federated server")
    m_updates = mreg.REGISTRY.counter(
        "fed_async_updates_total", "staleness-weighted buffered server "
        "updates applied")
    m_staleness = mreg.REGISTRY.histogram(
        "fed_update_staleness", "server-update lag (server versions) "
        "of buffered client updates when applied",
        buckets=(0.5, 1.5, 2.5, 3.5, 4.5))

    def train_one(snap: ServerState, cid: int, i: int):
        imgs, lbls = population.shard(cid)
        load_server(model, snap)
        loss, acc = local_train(
            torch.as_tensor(imgs, dtype=next(model.parameters()).dtype,
                            device=device),
            torch.as_tensor(lbls, device=device),
            client_generator((seed,), i, device))
        return ServerState.of(model), float(loss.mean()), float(acc.mean())

    def apply_buffer(server: ServerState, buf):
        """One buffered server update: the staleness-decayed weighted
        mean of K client deltas, each against ITS OWN dispatch-time
        snapshot. The denominator is the RAW weights' sum, so the
        discount shrinks a stale update's step absolutely (a buffer of
        equally stale updates takes a smaller step, not a full one);
        decay 1 is the plain weighted mean. Returns the new server
        weights and the dropped and clipped counts."""
        news = [{**b[0].params, **b[0].state} for b in buf]
        olds = [{**b[1].params, **b[1].state} for b in buf]
        wts, decays = (torch.tensor([b[i] for b in buf], dtype=torch.float32,
                                    device=device) for i in (2, 3))
        codes = torch.tensor([b[4] for b in buf], dtype=torch.int32,
                             device=device)
        scales = torch.tensor([b[5] for b in buf], dtype=torch.float32,
                              device=device)
        cur = {**server.params, **server.state}

        def leaf(name):
            # one tensor of the K buffered updates, faulted as the sync
            # round's apply_faults does (stragglers act through delay)
            new = torch.stack([n[name] for n in news])
            old = torch.stack([o[name] for o in olds])
            if not new.is_floating_point():
                return new, old
            shape = (K,) + (1,) * (new.dim() - 1)
            c = codes.reshape(shape)
            s = scales.reshape(shape).to(new.dtype)
            delta = new - old
            out = torch.where(c == faults_lib.NAN, float("nan"), new)
            out = torch.where(c == faults_lib.INF, float("inf"), out)
            out = torch.where(c == faults_lib.SCALE, old + s * delta, out)
            out = torch.where(c == faults_lib.SIGN_FLIP, old - s * delta,
                              out)
            return out, old

        ok = torch.ones(K, dtype=torch.bool, device=device)
        sq = torch.zeros(K, dtype=torch.float32, device=device)
        for name in cur:
            out, old = leaf(name)
            if out.is_floating_point():
                ok &= torch.isfinite(out.reshape(K, -1)).all(1)
                if clip_norm is not None:
                    d = (out - old).float()
                    sq += (d * d).reshape(K, -1).sum(1)
        raw = torch.clamp(wts, min=0.0)
        w = torch.where(ok, raw, 0.0)
        dropped = ((raw > 0) & ~ok).sum().float()
        if clip_norm is not None:
            norm = torch.sqrt(sq)
            factor = torch.clamp(clip_norm / torch.clamp(norm, min=1e-12),
                                 max=1.0)
            clipped = torch.where(w > 0, (norm > clip_norm).float(),
                                  0.0).sum()
        else:
            factor = torch.ones(K, device=device)
            clipped = torch.zeros((), device=device)
        total = torch.clamp(w.sum(), min=1e-30)
        any_alive = w.sum() > 0
        aw = w * decays
        new_tree = {}
        for name, c in cur.items():
            out, old = leaf(name)
            if not out.is_floating_point():
                new_tree[name] = c
                continue
            shape = (K,) + (1,) * (out.dim() - 1)
            delta = factor.reshape(shape).to(out.dtype) * (out - old)
            wb = aw.reshape(shape).to(out.dtype)
            step = torch.where(wb > 0, wb * delta, 0.0).sum(0)
            new_tree[name] = torch.where(
                any_alive, c + step / total.to(c.dtype), c)
        new = ServerState(server.round,
                          {k: new_tree[k] for k in server.params},
                          {k: new_tree[k] for k in server.state})
        return new, float(dropped), float(clipped)

    # --- simulation state (closure; survives across driver rounds) ----
    state: dict[str, Any] = {
        "version": 0,            # server updates applied so far
        "dispatch_i": 0,         # continuous dispatch-stream index
        "heap": [],              # (arrival_s, dispatch_i, cid, version,
        #                           code, scale)
        "buffer": [],            # completed-but-unapplied updates
        "snapshots": {},         # version -> ServerState clone
        "refs": {},              # version -> in-flight + buffered count
        "sim_t": 0.0,
        "wall_t0": None,
        "crashed": 0,
        "last_round": None,      # retry / rollback detector
        "logged_rounds": set(),  # ONE fed_cohort record per round
    }

    def _reset_inflight() -> None:
        """Drop every in-flight dispatch and buffered update: the driver
        is retrying or rolling back a round, and the pool's work was
        trained from the discarded attempt's weights -- re-applying it to
        the restored server would re-poison what the rollback threw
        away."""
        state["heap"].clear()
        state["buffer"].clear()
        state["snapshots"] = {
            v: s for v, s in state["snapshots"].items()
            if v == state["version"]}
        state["refs"] = {v: 0 for v in state["snapshots"]}

    def _duration(i: int, cid: int, round_idx: int) -> float:
        d = lo if lo == hi else float(
            lo + (hi - lo) * np.random.default_rng((seed, 5, i)).random())
        if faults is not None:
            d += float(faults.delay_s(round_idx, np.asarray([cid]))[0])
        return d

    def _release(v: int) -> None:
        state["refs"][v] -= 1
        if state["refs"][v] == 0 and v != state["version"]:
            del state["snapshots"][v], state["refs"][v]

    def _dispatch(round_idx: int) -> bool:
        """Sample and dispatch one client from the current version;
        False when it crashed (no completion will arrive, and its slot is
        refilled, as a real server sees it)."""
        i = state["dispatch_i"]
        state["dispatch_i"] += 1
        cid = sampler.client_at(i)
        code, scale = faults_lib.OK, 1.0
        if faults is not None:
            c, s = faults.codes_for(round_idx, np.asarray([cid]))
            code, scale = int(c[0]), float(s[0])
        if code == faults_lib.CRASH:
            state["crashed"] += 1
            return False
        v = state["version"]
        state["refs"][v] += 1
        heapq.heappush(state["heap"],
                       (state["sim_t"] + _duration(i, cid, round_idx),
                        i, cid, v, code, scale))
        return True

    def _fill(round_idx: int) -> None:
        misses = 0
        while len(state["heap"]) < concurrency:
            if not _dispatch(round_idx):
                misses += 1
                if misses > 1_000 * concurrency:
                    raise RuntimeError(
                        f"could not keep {concurrency} clients in "
                        f"flight after {misses} crashed dispatches — "
                        f"the fault plan crashes (nearly) the whole "
                        f"population")

    def round_fn(server: ServerState, images=None, labels=None,
                 weights=None, key=None, *, round_idx: int | None = None):
        r = server.round if round_idx is None else int(round_idx)
        n_process = sampler.cohort_size
        if weights is not None:
            mask = np.asarray(torch.as_tensor(weights).cpu(), np.float32)
            n_process = max(int((mask > 0).sum()), 1)
        if state["last_round"] is not None and r <= state["last_round"]:
            # the driver is retrying (or rolled back past) this round:
            # everything in flight belongs to the discarded attempt
            _reset_inflight()
        state["last_round"] = r
        # cleared at ENTRY: an attempt that raises mid-round must not
        # report the previous attempt's completions as its own
        round_fn.last_participants = np.zeros((0,), np.int64)
        if state["wall_t0"] is None:
            state["wall_t0"] = time.monotonic()
        server = server.to(device)
        # the incoming server IS the current version: refresh its
        # snapshot, so dispatches train from what the driver handed in
        # (a rollback re-anchors here)
        state["refs"].setdefault(state["version"], 0)
        state["snapshots"][state["version"]] = copy_tree(server)

        processed_ids: list[int] = []
        stalenesses: list[int] = []
        updates_applied = 0
        dropped_total = clipped_total = 0.0
        crashed_before = state["crashed"]
        wloss = wacc = wtot = 0.0
        _fill(r)
        for _ in range(n_process):
            arrival, i, cid, v, code, scale = heapq.heappop(state["heap"])
            state["sim_t"] = max(state["sim_t"], arrival)
            if realtime:
                ahead = (state["wall_t0"] + state["sim_t"]
                         - time.monotonic())
                if ahead > 0:
                    time.sleep(ahead)
            snap = state["snapshots"][v]
            new, loss, acc = train_one(snap, cid, i)
            s = state["version"] - v
            cw = population.weight(cid)
            state["buffer"].append(
                (new, snap, cw, staleness_decay ** s, code, scale))
            stalenesses.append(s)
            m_staleness.observe(float(s))
            processed_ids.append(cid)
            wloss += cw * loss
            wacc += cw * acc
            wtot += cw
            _release(v)
            _fill(r)

            if len(state["buffer"]) >= K:
                buf, state["buffer"] = (state["buffer"][:K],
                                        state["buffer"][K:])
                server, dropped, clipped = apply_buffer(server, buf)
                dropped_total += dropped
                clipped_total += clipped
                state["version"] += 1
                state["snapshots"][state["version"]] = copy_tree(server)
                state["refs"].setdefault(state["version"], 0)
                updates_applied += 1
                m_updates.inc()
                # prune superseded snapshots nothing references any more
                for old_v in [vv for vv, n in state["refs"].items()
                              if n == 0 and vv != state["version"]]:
                    del state["snapshots"][old_v], state["refs"][old_v]

        m_buffer.set(len(state["buffer"]))
        st = np.asarray(stalenesses, np.float64)
        hist = (np.bincount(
            np.minimum(st.astype(np.int64), STALENESS_BUCKETS - 1),
            minlength=STALENESS_BUCKETS).tolist() if len(st)
            else [0] * STALENESS_BUCKETS)
        safe = max(wtot, 1e-30)
        metrics = {
            "loss": wloss / safe if wtot > 0 else float("nan"),
            "accuracy": wacc / safe if wtot > 0 else float("nan"),
            "clients_dropped": dropped_total,
            "clients_clipped": clipped_total,
            "cohort": sampler.cohort_size,
            "participants": len(processed_ids),
            "updates": updates_applied,
            "buffer_fill": len(state["buffer"]),
            "staleness_mean": float(st.mean()) if len(st) else 0.0,
            "staleness_max": int(st.max()) if len(st) else 0,
            "crashed": state["crashed"] - crashed_before,
        }
        round_fn.last_participants = np.asarray(processed_ids, np.int64)
        if (logger is not None and r > log_from_round
                and r not in state["logged_rounds"]):
            # one record per ROUND: a driver retry re-runs the round but
            # must not log it again
            state["logged_rounds"].add(r)
            logger.log(event="fed_cohort", round=r, mode="async",
                       population=population.size,
                       cohort=sampler.cohort_size,
                       participants=len(processed_ids),
                       buffer=K, updates=updates_applied,
                       staleness_mean=metrics["staleness_mean"],
                       staleness_max=metrics["staleness_max"],
                       staleness_hist=hist)
        return server.replace(round=server.round + 1), metrics

    round_fn.last_participants = np.zeros((0,), np.int64)
    round_fn.sampler = sampler
    round_fn.population = population
    round_fn.buffer_size = K
    round_fn.staleness_decay = float(staleness_decay)
    return round_fn
