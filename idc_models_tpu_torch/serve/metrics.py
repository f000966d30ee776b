"""Serving observability: TTFT, per-token latency, throughput, queue
depth, slot occupancy -- the counterpart of
``idc_models_tpu/serve/metrics.py``.

Counters accumulate in memory and stream, when a logger is given,
through the jsonl record shape every other loop writes; `summary()` is
the serving record (`serve_*` fields) with the JAX package's key set.
The hooks are the ones this slice's scheduler calls (submit, reject,
admit, first token, finish, slot fault, retry, dispatch, cycle); the
shed, clamp, fault-plan, tenant, rollout, speculative, page and
compile-cache hooks come with their items (ROADMAP A9.2-A9.4, A10,
A11), and until then their summary keys hold the values a server
without them reports. Eager PyTorch compiles no serving program, so
`serve_compiles_observed` is 0.
"""

from __future__ import annotations

import time

import numpy as np

from idc_models_tpu_torch.observe import metrics_registry as mreg


def _pct(values, q) -> float | None:
    if not values:
        return None
    return float(np.percentile(np.asarray(values, np.float64), q))


def _r(v, scale) -> float | None:
    return None if v is None else round(v * scale, 2)


class ServingMetrics:
    """Per-request and per-cycle serving counters, fed by the scheduler.
    All times are seconds on the caller's clock. Every hook also updates
    the metrics registry (`registry`, the process-wide one by default);
    `slo` is an optional `observe.slo.SLOEngine` fed the declared subset
    of ``ttft`` / ``queue_wait`` (latency samples) and ``error_rate``
    (bad = rejected, or a finish of error/timeout/deadline), evaluated
    once per cycle."""

    def __init__(self, logger=None, registry=None, slo=None):
        self.logger = logger
        self.slo = slo
        reg = registry if registry is not None else mreg.REGISTRY
        # submissions and terminal outcomes are separate counters: one
        # status-labeled counter would count each request twice
        self._m_submitted = reg.counter(
            "serve_requests_submitted_total", "requests submitted")
        self._m_requests = reg.counter(
            "serve_requests_total",
            "requests by terminal outcome", labels=("status",))
        self._m_tokens = reg.counter(
            "serve_tokens_emitted_total", "decode tokens emitted")
        self._m_ttft = reg.histogram(
            "serve_ttft_seconds", "submit -> first token")
        self._m_itl = reg.histogram(
            "serve_itl_seconds",
            "per-request mean inter-token latency (decode seconds "
            "per token after the first)")
        self._m_queue = reg.gauge(
            "serve_queue_depth", "admission queue depth (last cycle)")
        self._m_occ = reg.gauge(
            "serve_slot_occupancy",
            "fraction of decode slots running (last cycle)")
        # the /healthz freshness anchor (observe/exporter.py)
        self._m_last_tick = reg.gauge(
            "serve_last_tick_monotonic_seconds",
            "time.monotonic() stamp of the last scheduler cycle — "
            "/healthz reports now minus this as last_tick_age_s")
        self._m_slot_faults = reg.counter(
            "serve_slot_faults_total",
            "slots quarantined by the per-cycle health checks, by "
            "fault kind", labels=("kind",))
        self._m_retries = reg.counter(
            "serve_retries_total",
            "quarantined requests re-admitted after backoff")
        self._m_dispatches = reg.counter(
            "serve_decode_dispatches_total",
            "decode dispatches by kind: 'window' (fused one-token-per-"
            "step scan) or 'verify' (speculative draft-and-verify)",
            labels=("kind",))
        self.window_dispatches = 0
        self.submitted = 0
        self.rejected = 0
        self.timed_out = 0
        self.slot_faults = 0
        self.retries = 0
        self.finished = 0
        self.tokens_out = 0
        self.cycles = 0
        self.ttft_s: list[float] = []
        self.queue_wait_s: list[float] = []  # submit -> slot claimed
        self.prefill_s: list[float] = []     # slot claimed -> first token
        self.token_s: list[float] = []       # per-token decode latency
        self.queue_depths: list[int] = []
        self.occupancies: list[float] = []
        self.cycle_tokens: list[int] = []
        self.cycle_prefill_s: list[float] = []  # per-cycle decode stall
        self._wait_by_rid: dict = {}
        self._t_first: float | None = None
        self._t_last: float | None = None

    # -- request lifecycle ----------------------------------------------

    def on_submit(self, rid, t: float) -> None:
        self.submitted += 1
        if self._t_first is None:
            self._t_first = t
        self._m_submitted.inc()
        self._log(event="serve_submit", id=rid)

    def on_reject(self, rid, t: float) -> None:
        self.rejected += 1
        self._m_requests.inc(status="rejected")
        if self.slo is not None and self.slo.has("error_rate"):
            self.slo.record("error_rate", ok=False)
        self._log(event="serve_reject", id=rid)

    def on_admit(self, rid, wait_s: float) -> None:
        """A request claimed a slot `wait_s` seconds after submit: the
        queue-wait half of its TTFT (the rest is prefill compute and the
        first window)."""
        self.queue_wait_s.append(wait_s)
        self._wait_by_rid[rid] = wait_s
        if self.slo is not None and self.slo.has("queue_wait"):
            self.slo.observe("queue_wait", wait_s)
        self._log(event="serve_admit", id=rid, queue_wait_ms=wait_s * 1e3)

    def on_first_token(self, rid, ttft_s: float) -> None:
        self._m_ttft.observe(ttft_s)
        if self.slo is not None and self.slo.has("ttft"):
            self.slo.observe("ttft", ttft_s)
        self.ttft_s.append(ttft_s)
        wait = self._wait_by_rid.pop(rid, None)
        prefill = None if wait is None else max(ttft_s - wait, 0.0)
        if prefill is not None:
            self.prefill_s.append(prefill)
        self._log(event="serve_first_token", id=rid,
                  ttft_ms=ttft_s * 1e3,
                  prefill_ms=None if prefill is None else prefill * 1e3)

    def on_finish(self, rid, *, n_tokens: int, ttft_s: float | None,
                  decode_s: float, reason: str, t: float) -> None:
        # a request cancelled before its first token never reaches
        # on_first_token: drop its queue-wait entry here too
        self._wait_by_rid.pop(rid, None)
        self.finished += 1
        if reason in ("timeout", "deadline"):
            self.timed_out += 1
        self._m_requests.inc(status=str(reason))
        if self.slo is not None and self.slo.has("error_rate"):
            self.slo.record("error_rate", ok=reason not in (
                "error", "timeout", "deadline"))
        if n_tokens:
            self._m_tokens.inc(n_tokens)
        self.tokens_out += n_tokens
        self._t_last = t
        if n_tokens > 1 and decode_s > 0:
            itl = decode_s / (n_tokens - 1)
            self.token_s.append(itl)
            self._m_itl.observe(itl)
        self._log(event="serve_finish", id=rid, tokens=n_tokens,
                  reason=reason,
                  ttft_ms=None if ttft_s is None else ttft_s * 1e3)

    # -- resilience ------------------------------------------------------

    def on_slot_fault(self, rid, *, kind: str, slot=None) -> None:
        """A running or prefilling slot was quarantined; `kind` is the
        detector that fired (nonfinite_logits / logit_magnitude /
        invariant / prefill_error)."""
        self.slot_faults += 1
        self._m_slot_faults.inc(kind=kind)
        self._log(event="serve_slot_fault", id=rid, kind=kind, slot=slot)

    def on_retry(self, rid, *, attempt: int, delay_s: float) -> None:
        """A quarantined request will re-enter the queue `delay_s`
        seconds from now, as attempt number `attempt`."""
        self.retries += 1
        self._m_retries.inc()
        self._log(event="serve_retry", id=rid, attempt=attempt,
                  delay_ms=delay_s * 1e3)

    # -- engine cycle ----------------------------------------------------

    def on_dispatch(self, kind: str) -> None:
        """One decode dispatch was COLLECTED (an aborted one never lands
        tokens, so it is not counted)."""
        self.window_dispatches += 1
        self._m_dispatches.inc(kind=kind)

    def on_cycle(self, *, queue_depth: int, occupancy: float,
                 tokens: int = 0, prefill_s: float = 0.0) -> None:
        self.cycles += 1
        self._m_queue.set(queue_depth)
        self._m_occ.set(occupancy)
        self._m_last_tick.set(time.monotonic())
        if self.slo is not None:
            self.slo.evaluate()
        self.queue_depths.append(int(queue_depth))
        self.occupancies.append(float(occupancy))
        self.cycle_tokens.append(int(tokens))
        self.cycle_prefill_s.append(float(prefill_s))

    # -- rollup -----------------------------------------------------------

    def summary(self) -> dict:
        """The serving record: throughput from the first submit to the
        last finish, TTFT (queue wait + prefill) and inter-token
        percentiles, mean queue and occupancy."""
        span = ((self._t_last - self._t_first)
                if self._t_first is not None and self._t_last is not None
                else None)
        dispatches = self.window_dispatches
        return {
            "serve_requests": self.finished,
            "serve_rejected": self.rejected,
            "serve_timed_out": self.timed_out,
            "serve_tokens": self.tokens_out,
            "serve_tokens_per_sec": (
                round(self.tokens_out / span, 2)
                if span and span > 0 else None),
            "serve_ttft_ms_p50": _r(_pct(self.ttft_s, 50), 1e3),
            "serve_ttft_ms_p95": _r(_pct(self.ttft_s, 95), 1e3),
            "serve_queue_wait_ms_p50": _r(_pct(self.queue_wait_s, 50),
                                          1e3),
            "serve_queue_wait_ms_p95": _r(_pct(self.queue_wait_s, 95),
                                          1e3),
            "serve_prefill_ms_p50": _r(_pct(self.prefill_s, 50), 1e3),
            "serve_prefill_ms_p95": _r(_pct(self.prefill_s, 95), 1e3),
            "serve_token_ms_p50": _r(_pct(self.token_s, 50), 1e3),
            "serve_token_ms_p95": _r(_pct(self.token_s, 95), 1e3),
            "serve_slot_occupancy": (
                round(float(np.mean(self.occupancies)), 4)
                if self.occupancies else None),
            "serve_queue_depth_mean": (
                round(float(np.mean(self.queue_depths)), 2)
                if self.queue_depths else None),
            "serve_queue_depth_max": (
                max(self.queue_depths) if self.queue_depths else None),
            "serve_window_tokens_mean": (
                round(float(np.mean(self.cycle_tokens)), 2)
                if self.cycle_tokens else None),
            "serve_prefill_stall_ms_mean": (
                _r(float(np.mean(self.cycle_prefill_s)), 1e3)
                if self.cycle_prefill_s else None),
            "serve_prefill_stall_ms_max": (
                _r(float(np.max(self.cycle_prefill_s)), 1e3)
                if self.cycle_prefill_s else None),
            "serve_compiles_observed": 0,
            "serve_slot_faults": self.slot_faults,
            "serve_retries": self.retries,
            # brownout (A9.4): nothing sheds or clamps yet
            "serve_shed": 0,
            "serve_clamped": 0,
            "serve_faults_injected": 0,
            "serve_decode_dispatches": dispatches,
            "serve_tokens_per_dispatch": (
                round(self.tokens_out / dispatches, 3)
                if dispatches else None),
            # speculative decoding (A9.3): no verify dispatch yet
            "serve_spec_verify_dispatches": 0,
            "serve_spec_drafted": 0,
            "serve_spec_accepted": 0,
            "serve_spec_accept_rate": None,
            "serve_spec_tokens_per_dispatch": None,
            "serve_spec_propose_s": None,
            # paged KV (A9.2): contiguous rows only
            "serve_kv_pages_total": None,
            "serve_kv_pages_used_peak": None,
            "serve_kv_resident_tokens_peak": None,
            "serve_kv_resident_bytes_peak": None,
            "serve_kv_tokens_per_hbm_byte": None,
            "serve_page_exhaustions": 0,
            # hot weight rollout (A11)
            "serve_rollouts": 0,
            "serve_rollout_outcome": None,
            "serve_rollout_stage": None,
        }

    def _log(self, **record) -> None:
        if self.logger is not None:
            self.logger.log(**record)


def aggregate_summaries(metrics_list) -> dict:
    """The rollup over several servers' `ServingMetrics`: percentiles
    over the POOLED per-request samples (a p95 of p95s is not a p95),
    throughput over the span from the earliest first submit to the
    latest last finish."""
    metrics_list = list(metrics_list)
    ttft, queue_wait, itl = [], [], []
    tokens = finished = rejected = timed_out = 0
    t_first, t_last = None, None
    for m in metrics_list:
        ttft.extend(m.ttft_s)
        queue_wait.extend(m.queue_wait_s)
        itl.extend(m.token_s)
        tokens += m.tokens_out
        finished += m.finished
        rejected += m.rejected
        timed_out += m.timed_out
        if m._t_first is not None:
            t_first = (m._t_first if t_first is None
                       else min(t_first, m._t_first))
        if m._t_last is not None:
            t_last = (m._t_last if t_last is None
                      else max(t_last, m._t_last))
    span = (t_last - t_first
            if t_first is not None and t_last is not None else None)
    return {
        "cluster_replicas": len(metrics_list),
        "cluster_requests": finished,
        "cluster_rejected": rejected,
        "cluster_timed_out": timed_out,
        "cluster_shed": 0,
        "cluster_tokens": tokens,
        "cluster_tokens_per_sec": (round(tokens / span, 2)
                                   if span and span > 0 else None),
        "cluster_ttft_ms_p50": _r(_pct(ttft, 50), 1e3),
        "cluster_ttft_ms_p95": _r(_pct(ttft, 95), 1e3),
        "cluster_queue_wait_ms_p95": _r(_pct(queue_wait, 95), 1e3),
        "cluster_itl_ms_p95": _r(_pct(itl, 95), 1e3),
    }
