"""Self-healing multi-round federated driver.

The counterpart of ``idc_models_tpu/federated/driver.py``:
`make_fedavg_round` hardens one round (non-finite detection, robust
aggregation); this module hardens the run. R rounds with a per-round
wall budget, bounded retries on a reseeded client subset, divergence
detection with rollback to the last good server state, periodic atomic
checkpoints, and per-round ``round_health`` records through
``observe.JsonlLogger``.

Failure semantics, per round:

- **timeout**: a round whose wall time (from the call to the fetched
  metrics, after a ``torch.cuda.synchronize()`` on the card, where CUDA
  runs asynchronously) exceeds `timeout_s` is discarded and retried;
  the driver's first attempt is exempt by default (it pays the card's
  warm-up, not straggling);
- **diverged**: the candidate server holds a non-finite value, the
  round's loss is non-finite (every client dropped), or the loss spiked
  past `loss_spike_ratio` times the last healthy round's; the candidate
  is discarded (the last good state was never overwritten) and the
  round retries;
- **error**: the round function raised; retried like the others, the
  last exception chained into `RoundFailure`.

A retry draws a fresh client subset (`reseeded_subset`) and a fresh key.
After `max_attempts` failures of the same round the driver raises
`RoundFailure`, with the last good state as its ``.server``.

Determinism: attempt a of round r gets the key ``(seed, r, a)`` (the JAX
package's ``fold_in(fold_in(key(seed), r), a)``) and its subset from
``default_rng((seed, r, a))``, so resumed and replayed runs reproduce
the stream.

Observability, as the JAX driver: each attempt is a ``fed.round`` span
(round, attempt, status, participants) holding a ``device.sync`` span
around the wait for the card and, while a tracer is armed, one
``fed.client`` marker per participant with its fault outcome; the
registry counts ``fed_round_attempts_total{status}``,
``fed_round_seconds`` and ``fed_train_loss``; an `SLOEngine` passed as
`slo` sees every attempt; with accounting armed the first attempt runs
counted and is filed as the ``fed.round`` program.
"""

from __future__ import annotations

import dataclasses
import inspect
import os
import sys
import time

import numpy as np
import torch

from idc_models_tpu_torch.federated.fedavg import ServerState, copy_tree
from idc_models_tpu_torch.observe import metrics_registry as mreg
from idc_models_tpu_torch.observe import profile as prof
from idc_models_tpu_torch.observe import trace


class RoundFailure(RuntimeError):
    """A federated round kept failing after the configured retries."""


@dataclasses.dataclass(frozen=True)
class DriverConfig:
    """Knobs for `run_rounds`. `timeout_s=None` disables the wall budget;
    `loss_spike_ratio=None` disables spike detection (non-finite
    divergence detection is always on)."""

    rounds: int
    timeout_s: float | None = None
    # the chronologically first attempt pays the card's warm-up (cuDNN
    # algorithm search, allocator growth): exempting it keeps timeout_s
    # a steady-state budget; False budgets the warm-up too
    timeout_exempt_first: bool = True
    max_attempts: int = 3
    loss_spike_ratio: float | None = 10.0
    retry_subset_fraction: float = 0.7
    checkpoint_path: str | os.PathLike | None = None
    checkpoint_every: int = 10

    def __post_init__(self):
        if self.rounds < 1:
            raise ValueError(f"need rounds >= 1, got {self.rounds}")
        if self.max_attempts < 1:
            raise ValueError(f"need max_attempts >= 1, got "
                             f"{self.max_attempts}")
        if not 0.0 < self.retry_subset_fraction <= 1.0:
            raise ValueError(f"retry_subset_fraction must be in (0, 1], "
                             f"got {self.retry_subset_fraction}")
        if self.loss_spike_ratio is not None and self.loss_spike_ratio <= 1:
            raise ValueError(f"loss_spike_ratio must be > 1, got "
                             f"{self.loss_spike_ratio}")


@dataclasses.dataclass
class DriverResult:
    server: ServerState          # the last GOOD server state
    history: list[dict]          # one entry per completed round
    events: list[dict]           # one entry per attempt (health log)


def reseeded_subset(weights, seed: int, round_idx: int, attempt: int,
                    fraction: float) -> np.ndarray:
    """A deterministic retry population: keep `fraction` of the
    positive-weight clients (at least 1), drawn from
    ``default_rng((seed, round, attempt))``, so a straggling or poisoned
    participant of the failed attempt may be left out without the driver
    knowing who it was."""
    w = np.asarray(torch.as_tensor(weights).cpu(), np.float32).copy()
    pos = np.flatnonzero(w > 0)
    if len(pos) == 0:
        return w
    keep = max(1, int(round(fraction * len(pos))))
    chosen = np.random.default_rng((seed, round_idx, attempt)).choice(
        pos, size=keep, replace=False)
    out = np.zeros_like(w)
    out[chosen] = w[chosen]
    return out


def _all_finite(server: ServerState) -> bool:
    leaves = [v for v in (*server.params.values(), *server.state.values())
              if v.is_floating_point()]
    if not leaves:
        return True
    return bool(torch.stack([torch.isfinite(v).all() for v in leaves])
                .all())


def _synchronize(server: ServerState) -> None:
    """Wait for the card's queued work behind `server`, so the clock
    times the round and not its launch."""
    leaf = next(iter(server.params.values()), None)
    if leaf is not None and leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)


def _takes_round_idx(round_fn) -> bool:
    try:
        return "round_idx" in inspect.signature(round_fn).parameters
    except (TypeError, ValueError):
        return False


def run_rounds(round_fn, server: ServerState, images, labels, weights, *,
               config: DriverConfig, seed: int = 0, eval_fn=None,
               on_round=None, logger=None, clock=time.monotonic,
               verbose: bool = False, log_from_round: int = -1,
               log_round_records: bool = True, fault_plan=None, slo=None,
               participant_ids_fn=None) -> DriverResult:
    """Run `config.rounds` federated rounds with self-healing.

    `round_fn` is a `make_fedavg_round` product (or anything with its
    signature); `eval_fn(server) -> metrics` is an optional per-round
    evaluation folded into the history and the records; `on_round(entry)`
    is called after each healthy round with its history entry. Starts at
    ``server.round``, so a restored checkpoint resumes where it left off.
    `log_from_round` suppresses logger records for rounds <= it (a
    resume's replay must not double-append to an append-only jsonl);
    ``log_round_records=False`` leaves the per-round ``round`` records to
    the caller while the driver still writes ``round_health``.

    `fault_plan` (the round's `faults` plan) labels the ``fed.client``
    markers with each client's fault outcome. `slo` (an `SLOEngine`)
    observes ``round_seconds`` and records ``round_failure_rate`` for
    whichever it declares, and evaluates after every attempt.
    `participant_ids_fn(round_idx) -> ids` names the markers by virtual
    client id (population and async rounds); a plan with
    ``codes_for(round, ids)`` is asked per id.

    Returns the last good server state, the per-round history and the
    per-attempt health events; raises `RoundFailure` when a round
    exhausts its attempts."""
    # a fault-injecting round takes round_idx= for its fault codes
    kw = {"round_idx": None} if _takes_round_idx(round_fn) else {}
    good = server
    ref_loss = None
    first_attempt_done = False
    history: list[dict] = []
    events: list[dict] = []
    start = int(server.round)
    if start >= config.rounds:
        # a fully-trained restore is a no-op run, not an error
        return DriverResult(server=server, history=[], events=[])

    def health(record):
        events.append(record)
        if logger is not None and record["round"] > log_from_round:
            logger.log(event="round_health", **record)

    # process-wide instruments (idempotent: resumed runs and several
    # drivers share them)
    m_attempts = mreg.REGISTRY.counter(
        "fed_round_attempts_total", "federated round attempts by "
        "outcome", labels=("status",))
    m_seconds = mreg.REGISTRY.histogram(
        "fed_round_seconds", "wall seconds per round attempt")
    m_loss = mreg.REGISTRY.gauge(
        "fed_train_loss", "last healthy round's training loss")
    # program accounting while armed (a profile_trace window): the
    # first attempt runs counted, in place of a plain call
    accounted = not prof.accounting_enabled()

    last_error: Exception | None = None
    for r in range(start, config.rounds):
        for attempt in range(config.max_attempts):
            w = (weights if attempt == 0 else reseeded_subset(
                weights, seed, r, attempt, config.retry_subset_fraction))
            # fresh tensors: the anchor survives whatever round_fn does
            # to its input in place -- rollback is keeping `good`
            anchor = copy_tree(good)
            t0 = clock()
            status, tm_host = "ok", {}
            candidate = None
            with trace.span("fed.round", round=r,
                            attempt=attempt) as att_span:
                try:
                    if kw:
                        kw["round_idx"] = r
                    call = (round_fn, anchor, images, labels, w,
                            (seed, r, attempt))
                    if accounted:
                        candidate, tm = call[0](*call[1:], **kw)
                    else:
                        accounted = True
                        _, (candidate, tm) = prof.register_program(
                            "fed.round", *call,
                            arguments=(anchor.params, anchor.state), **kw)
                    # the wait for the card, and the metrics' fetch
                    with trace.span("device.sync"):
                        _synchronize(candidate)
                        tm_host = {k: float(v) for k, v in tm.items()}
                    if not _all_finite(candidate) or not np.isfinite(
                            tm_host.get("loss", np.nan)):
                        status = "diverged"
                    elif (config.loss_spike_ratio is not None
                          and ref_loss is not None
                          and tm_host["loss"]
                          > config.loss_spike_ratio * ref_loss):
                        status = "diverged"
                except Exception as e:  # noqa: BLE001 -- chained into RoundFailure
                    last_error = e
                    status = "error"
                    tm_host = {"error": f"{type(e).__name__}: {e}"}
                elapsed = clock() - t0
                timeout_exempt = (config.timeout_exempt_first
                                  and not first_attempt_done)
                first_attempt_done = True
                if (status == "ok" and config.timeout_s is not None
                        and not timeout_exempt
                        and elapsed > config.timeout_s):
                    status = "timeout"
                w_host = np.asarray(torch.as_tensor(w).cpu())
                record = {"round": r, "attempt": attempt, "status": status,
                          "seconds": round(elapsed, 4),
                          "participants": int((w_host > 0).sum()),
                          **{k: v for k, v in tm_host.items()
                             if k in ("loss", "accuracy", "clients_dropped",
                                      "clients_clipped", "clients_trimmed",
                                      "trim_degenerate", "error")}}
                att_span.set(status=status,
                             participants=record["participants"])
                if trace.get_tracer() is not None:
                    ids = (participant_ids_fn(r)
                           if participant_ids_fn is not None else None)
                    _client_spans(att_span, w_host, r, attempt, fault_plan,
                                  ids=ids)
            m_attempts.inc(status=status)
            m_seconds.observe(elapsed)
            health(record)
            if slo is not None:
                if slo.has("round_seconds"):
                    slo.observe("round_seconds", elapsed)
                if slo.has("round_failure_rate"):
                    slo.record("round_failure_rate", ok=status == "ok")
                slo.evaluate()
            if status == "ok":
                good = candidate
                ref_loss = tm_host["loss"]
                m_loss.set(ref_loss)
                entry = {"round": r, "attempts": attempt + 1, **tm_host}
                if eval_fn is not None:
                    entry.update(eval_fn(good))
                history.append(entry)
                if (log_round_records and logger is not None
                        and r > log_from_round):
                    logger.log(event="round", **entry)
                if on_round is not None:
                    on_round(entry)
                break
            if verbose:
                print(f"[idc_models_tpu_torch] round {r} attempt {attempt} "
                      f"{status} after {elapsed:.2f}s -- "
                      f"{'rolling back and ' if candidate is not None else ''}"
                      f"retrying with a reseeded client subset",
                      file=sys.stderr)
        else:
            err = RoundFailure(
                f"round {r} failed {config.max_attempts} attempt(s) "
                f"(last status: {events[-1]['status']}); last good "
                f"server state is at round {int(good.round)}")
            err.server = good           # the rollback anchor, recoverable
            raise err from last_error
        if (config.checkpoint_path is not None
                and (r + 1) % max(config.checkpoint_every, 1) == 0):
            _save(config.checkpoint_path, good)
    if (config.checkpoint_path is not None
            and int(good.round) % max(config.checkpoint_every, 1) != 0):
        _save(config.checkpoint_path, good)
    return DriverResult(server=good, history=history, events=events)


def _client_spans(att_span, weights, round_idx: int, attempt: int,
                  fault_plan, ids=None) -> None:
    """One ``fed.client`` marker span per participating client, nested
    under the attempt's ``fed.round`` span, carrying the client's fault
    outcome for the round (the plan's pure (plan, round) function: the
    codes the round branched on). Markers, not timings. `weights` is the
    attempt's host array; `ids`, when given, are VIRTUAL client ids of a
    population-scale round (the weight attr is then left out: the
    positional weights do not describe them)."""
    from idc_models_tpu_torch import faults as faults_lib

    w = np.asarray(weights)
    by_position = ids is None
    ids = np.flatnonzero(w > 0) if by_position else np.asarray(ids)
    if not by_position and len(ids) == len(w):
        # sync population rounds: the cohort's ids align with the
        # participation mask a reseeded retry zeroes
        ids = ids[w > 0]
    per_id = fault_plan is not None and hasattr(fault_plan, "codes_for")
    codes = scales = None
    if fault_plan is not None:
        codes, scales = (fault_plan.codes_for(round_idx, ids) if per_id
                         else fault_plan.codes(round_idx))
    for i, cid in enumerate(ids):
        cid = int(cid)
        attrs = {"round": round_idx, "attempt": attempt, "client": cid}
        if by_position:
            attrs["weight"] = float(w[cid])
        # population plans align codes to `ids`; materialized plans index
        # by client position
        ci = i if per_id else cid
        if codes is not None and ci < len(codes):
            code = int(codes[ci])
            attrs["fault"] = faults_lib.kind_of(code)
            if code in (faults_lib.SCALE, faults_lib.SIGN_FLIP):
                attrs["fault_scale"] = float(scales[ci])
            elif code == faults_lib.STRAGGLER:
                attrs["staleness"] = fault_plan.staleness(round_idx)
        trace.point("fed.client", parent=att_span.span_id, **attrs)


def _save(path, server: ServerState) -> None:
    from idc_models_tpu_torch.train.checkpoint import save_checkpoint

    save_checkpoint(path, server.tree())
