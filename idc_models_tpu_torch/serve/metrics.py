"""Serving observability: TTFT, per-token latency, throughput, queue
depth, slot occupancy, KV pages -- the counterpart of
``idc_models_tpu/serve/metrics.py``.

Counters accumulate in memory and stream, when a logger is given,
through the jsonl record shape every other loop writes; `summary()` is
the serving record (`serve_*` fields) with the JAX package's key set,
and with a prefix cache attached its `serve_prefix_*` fields merged in.
The hooks are the ones the scheduler calls (submit, reject, admit,
first token, finish, slot fault, retry, brownout shed and clamp, injected
fault, dispatch, speculative verify and propose, cycle, pages, page
exhaustion, tenant quota and tenant cycle). With a `Tenancy` armed the
hooks take ``tenant=`` and also keep tenant-labelled series, the
``serve_tenant_finish`` / ``serve_tenant_shed`` /
``serve_tenant_quota_reject`` events and ``summary()["serve_tenants"]``;
without one the registry and every record keep their untenanted shape.
`on_rollout` takes the weight rollout's transitions
(``checkpoint/rollout.py``): the stage gauge, the terminal outcomes and
the ``serve_rollout`` event. `on_compile_cache` takes a
``serve/compile_cache.CompileCache``'s counters after warmup: the
``serve_compile_cache_*`` gauges, registered on first call, and the
``serve_compile_cache`` summary key (absent without a cache). Eager
PyTorch compiles no serving program, so `serve_compiles_observed` is 0.
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
    once per cycle. `tenancy` is a built ``serve/tenancy.Tenancy``: TTFT
    samples then also feed each tenant's own ``ttft:<name>`` objective."""

    def __init__(self, logger=None, prefix_cache=None, registry=None,
                 slo=None, tenancy=None):
        self.logger = logger
        self.slo = slo
        self.tenancy = tenancy
        # an attached prefix cache's serve_prefix_* counters roll into
        # summary() next to the serving fields
        self.prefix_cache = prefix_cache
        reg = registry if registry is not None else mreg.REGISTRY
        # compile-cache rollup: its gauges are registered by the first
        # on_compile_cache, so a cache-less server's exposition keeps
        # its shape
        self._reg = reg
        self.compile_cache_summary: dict | None = None
        self._g_cc: dict | None = None
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
        # the JAX family of jit compiles seen after the first cycle: the
        # eager port compiles no serving program, so it stays at 0 (the
        # fleet exposition keeps JAX's family names)
        reg.counter(
            "serve_compiles_total",
            "serving-program compiles observed after the first cycle "
            "(none in the eager port)")
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
        self._m_shed = reg.counter(
            "serve_shed_total",
            "submits refused by the brownout controller's shed stage")
        self._m_clamped = reg.counter(
            "serve_clamped_total",
            "admissions whose max_new_tokens the brownout clamp "
            "shortened")
        self._m_faults_injected = reg.counter(
            "serve_faults_injected_total",
            "declarative serve faults fired by an armed ServeFaultPlan,"
            " by kind", labels=("kind",))
        self._m_dispatches = reg.counter(
            "serve_decode_dispatches_total",
            "decode dispatches by kind: 'window' (fused one-token-per-"
            "step scan) or 'verify' (speculative draft-and-verify)",
            labels=("kind",))
        # the speculative ledger: acceptance rate and tokens a dispatch
        # derive from these
        self._m_spec_drafted = reg.counter(
            "serve_spec_drafted_tokens_total",
            "draft tokens submitted to speculative verify dispatches")
        self._m_spec_accepted = reg.counter(
            "serve_spec_accepted_tokens_total",
            "draft tokens the verify accepted (emitted as-is)")
        # paged KV: pool occupancy gauges and the page-exhaustion
        # backpressure counter
        self._m_pages_used = reg.gauge(
            "serve_kv_pages_used",
            "KV pool pages currently allocated (slots + prefix-cache "
            "snapshots), last cycle")
        self._m_pages_total = reg.gauge(
            "serve_kv_pages_total",
            "total KV pool pages the paged engine was built with")
        self._m_pages_cached = reg.gauge(
            "serve_kv_pages_cached",
            "distinct KV pool pages pinned by prefix-cache snapshots "
            "(a subset of serve_kv_pages_used; shared zero-copy with "
            "the slots that wrote them), last cycle")
        self._m_page_exhausted = reg.counter(
            "serve_page_exhaustions_total",
            "cycles the paged engine refused work for lack of free "
            "pages (admission gate or mid-decode growth)")
        # the weight rollout: terminal outcomes and the stage an operator
        # watches during a canary
        self._m_rollouts = reg.counter(
            "serve_rollouts_total",
            "weight rollouts by terminal outcome: 'promoted' (canary "
            "healthy, live weights swapped) or 'rolled_back' (staging "
            "spot-check or canary SLO comparison failed)",
            labels=("outcome",))
        self._m_rollout_stage = reg.gauge(
            "serve_rollout_stage_code",
            "current rollout stage: 0 idle, 1 staging, 2 canary, "
            "3 promoted, 4 rolled_back")
        # tenant-labelled instruments, registered only with tenancy so
        # an untenanted server's /metrics stays as it was
        if tenancy is not None:
            self._m_t_requests = reg.counter(
                "serve_tenant_requests_total",
                "requests by tenant and terminal outcome",
                labels=("tenant", "status"))
            self._m_t_tokens = reg.counter(
                "serve_tenant_tokens_emitted_total",
                "decode tokens emitted per tenant", labels=("tenant",))
            self._m_t_ttft = reg.histogram(
                "serve_tenant_ttft_seconds",
                "submit -> first token per tenant", labels=("tenant",))
            self._m_t_queue = reg.gauge(
                "serve_tenant_queue_depth",
                "admission-queue entries each tenant holds (last "
                "cycle)", labels=("tenant",))
            self._m_t_slots = reg.gauge(
                "serve_tenant_slots_used",
                "decode slots (running + prefilling) each tenant "
                "holds (last cycle)", labels=("tenant",))
            self._m_t_pages = reg.gauge(
                "serve_tenant_kv_pages_used",
                "KV pool pages each tenant's admissions have reserved "
                "(last cycle; paged engines)", labels=("tenant",))
            self._m_t_shed = reg.counter(
                "serve_tenant_shed_total",
                "submits refused by the tenant's own brownout shed "
                "stage", labels=("tenant",))
            self._m_t_quota = reg.counter(
                "serve_tenant_quota_rejections_total",
                "submits refused by a per-tenant quota, by quota kind",
                labels=("tenant", "kind"))
        # the per-tenant rollup, keyed by tenant name
        self.tenant_ttft_s: dict[str, list] = {}
        self.tenant_finished: dict[str, int] = {}
        self.tenant_tokens: dict[str, int] = {}
        self.tenant_shed: dict[str, int] = {}
        self.tenant_quota_rejections: dict[str, int] = {}
        # the rollout's last stage and its terminal outcomes
        self.rollout_stage: str | None = None
        self.rollout_outcomes: list[str] = []
        self.kv_pages_total: int | None = None
        self.kv_pages_used_peak = 0
        self.kv_resident_tokens_peak = 0
        self.kv_resident_bytes_peak = 0
        self.kv_tokens_per_byte_peak: float | None = None
        self.page_exhaustions = 0
        self.window_dispatches = 0
        self.verify_dispatches = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_emitted = 0
        # eager PyTorch compiles no serving program: the count the
        # cluster's compile-churn watchdog reads stays 0
        self.compiles_observed = 0
        self.spec_slot_verifies = 0
        self.propose_s = 0.0
        self.propose_calls = 0
        self.submitted = 0
        self.rejected = 0
        self.timed_out = 0
        self.slot_faults = 0
        self.retries = 0
        self.shed = 0
        self.clamped = 0
        self.faults_injected = 0
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

    def on_submit(self, rid, t: float, *, tenant=None) -> None:
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

    def on_first_token(self, rid, ttft_s: float, *, tenant=None) -> None:
        self._m_ttft.observe(ttft_s)
        if self.slo is not None and self.slo.has("ttft"):
            self.slo.observe("ttft", ttft_s)
        if tenant is not None and self.tenancy is not None:
            # the tenant's own ttft:<name> objective: its admission and
            # brownout signal
            self.tenancy.observe_ttft(tenant, ttft_s)
            self._m_t_ttft.observe(ttft_s, tenant=tenant)
            self.tenant_ttft_s.setdefault(tenant, []).append(ttft_s)
        self.ttft_s.append(ttft_s)
        wait = self._wait_by_rid.pop(rid, None)
        prefill = None if wait is None else max(ttft_s - wait, 0.0)
        if prefill is not None:
            self.prefill_s.append(prefill)
        self._log(event="serve_first_token", id=rid,
                  ttft_ms=ttft_s * 1e3,
                  prefill_ms=None if prefill is None else prefill * 1e3)

    def on_finish(self, rid, *, n_tokens: int, ttft_s: float | None,
                  decode_s: float, reason: str, t: float,
                  tenant=None) -> None:
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
        if tenant is not None and self.tenancy is not None:
            # a record of its own: serve_finish keeps its shape
            self.tenant_finished[tenant] = (
                self.tenant_finished.get(tenant, 0) + 1)
            self.tenant_tokens[tenant] = (
                self.tenant_tokens.get(tenant, 0) + n_tokens)
            self._m_t_requests.inc(tenant=tenant, status=str(reason))
            if n_tokens:
                self._m_t_tokens.inc(n_tokens, tenant=tenant)
            self._log(event="serve_tenant_finish", id=rid,
                      tenant=tenant, tokens=n_tokens, reason=reason,
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

    def on_shed(self, rid, *, tenant=None) -> None:
        """A brownout shed stage refused a submit (the server-wide
        controller's or, with `tenant` set, that tenant's own): a
        terminal outcome of its own, not fed to the error-rate SLO
        (shedding is the controller's intended action; scoring it as an
        error would make shedding beget more shedding)."""
        self.shed += 1
        self._m_shed.inc()
        self._m_requests.inc(status="shed")
        self._log(event="serve_shed", id=rid)
        if tenant is not None and self.tenancy is not None:
            self.tenant_shed[tenant] = self.tenant_shed.get(tenant, 0) + 1
            self._m_t_shed.inc(tenant=tenant)
            self._m_t_requests.inc(tenant=tenant, status="shed")
            self._log(event="serve_tenant_shed", id=rid, tenant=tenant)

    def on_tenant_quota(self, rid, *, tenant: str, kind: str) -> None:
        """A per-tenant quota refused a submit (`kind` "queued"; the slot
        and page quotas hold entries in the queue instead). A rejection
        in the aggregate figures, but not fed to the error-rate SLO: the
        refusal is the isolation working, not the service failing."""
        self.rejected += 1
        self._m_requests.inc(status="rejected")
        self.tenant_quota_rejections[tenant] = (
            self.tenant_quota_rejections.get(tenant, 0) + 1)
        self._m_t_quota.inc(tenant=tenant, kind=kind)
        self._m_t_requests.inc(tenant=tenant, status="rejected")
        self._log(event="serve_tenant_quota_reject", id=rid,
                  tenant=tenant, kind=kind)

    def on_tenant_cycle(self, names, *, depths: dict, slots: dict,
                        pages: dict) -> None:
        """The per-cycle tenant gauges: every registered tenant gets a
        point, zero included, so a tenant that drained reads 0."""
        for name in names:
            self._m_t_queue.set(depths.get(name, 0), tenant=name)
            self._m_t_slots.set(slots.get(name, 0), tenant=name)
            self._m_t_pages.set(pages.get(name, 0), tenant=name)

    def on_clamp(self, rid, *, asked: int, clamp: int) -> None:
        """The brownout clamp shortened an admission's budget."""
        self.clamped += 1
        self._m_clamped.inc()
        self._log(event="serve_clamp", id=rid, max_new_tokens=clamp,
                  asked=asked)

    def on_fault_injected(self, kind: str, *, tick: int = 0) -> None:
        """A declarative drill fault fired (`ServeFaultPlan`)."""
        self.faults_injected += 1
        self._m_faults_injected.inc(kind=kind)
        self._log(event="serve_fault_injected", kind=kind, tick=tick)

    def on_compile_cache(self, cache) -> None:
        """Snapshot a `CompileCache`'s counters after warmup: the first
        call registers the serve_compile_cache_* gauges, every call
        re-reads ``cache.summary()`` into them and the rollup."""
        if self._g_cc is None:
            reg = self._reg
            self._g_cc = {
                "hits": reg.gauge(
                    "serve_compile_cache_hits",
                    "persistent compile-cache hits (kernel libraries "
                    "loaded from the store instead of built)"),
                "misses": reg.gauge(
                    "serve_compile_cache_misses",
                    "persistent compile-cache misses (programs whose "
                    "kernels were built and stored; includes corrupt "
                    "evictions)"),
                "deserialize_s": reg.gauge(
                    "serve_compile_cache_deserialize_seconds",
                    "cumulative seconds spent loading cached kernel "
                    "libraries (the warm spin-up cost)"),
            }
        s = cache.summary()
        self.compile_cache_summary = s
        self._g_cc["hits"].set(s["hits"])
        self._g_cc["misses"].set(s["misses"])
        self._g_cc["deserialize_s"].set(s["deserialize_s"])
        self._log(event="serve_compile_cache", **s)

    # -- weight rollout ---------------------------------------------------

    def on_rollout(self, *, stage: str, outcome: str | None = None,
                   canary_requests: int = 0,
                   reason: str | None = None) -> None:
        """One transition of the rollout's state machine (staging ->
        canary -> promoted | rolled_back, ``checkpoint/rollout.py``).
        `outcome` is set on the terminal transitions only; `reason`
        explains a rollback."""
        codes = {"idle": 0, "staging": 1, "canary": 2, "promoted": 3,
                 "rolled_back": 4}
        if stage not in codes:
            raise ValueError(f"unknown rollout stage {stage!r} "
                             f"(one of {sorted(codes)})")
        self.rollout_stage = stage
        self._m_rollout_stage.set(codes[stage])
        if outcome is not None:
            self.rollout_outcomes.append(outcome)
            self._m_rollouts.inc(outcome=outcome)
        self._log(event="serve_rollout", stage=stage, outcome=outcome,
                  canary_requests=canary_requests, reason=reason)

    # -- paged KV ---------------------------------------------------------

    def on_pages(self, *, pages_total: int, pages_used: int,
                 pages_cached: int, resident_tokens: int,
                 resident_bytes: int) -> None:
        """Per-cycle pool occupancy from a paged engine
        (`SlotEngine.page_stats`): the gauges, and the peaks the summary
        reports -- peak resident tokens over the bytes holding them is
        the tokens-per-byte capacity figure. Logs nothing per cycle."""
        if self.kv_pages_total is None:
            self._m_pages_total.set(pages_total)
        self.kv_pages_total = int(pages_total)
        self._m_pages_used.set(pages_used)
        self._m_pages_cached.set(pages_cached)
        self.kv_pages_used_peak = max(self.kv_pages_used_peak,
                                      int(pages_used))
        if resident_tokens > self.kv_resident_tokens_peak:
            self.kv_resident_tokens_peak = int(resident_tokens)
            if resident_bytes > 0:
                self.kv_tokens_per_byte_peak = (resident_tokens
                                                / resident_bytes)
        self.kv_resident_bytes_peak = max(self.kv_resident_bytes_peak,
                                          int(resident_bytes))

    def on_page_exhausted(self, *, rid=None, needed: int = 0) -> None:
        """The paged engine could not grant pages this cycle: admission
        held the queue head back, or a running slot's decode growth
        failed."""
        self.page_exhaustions += 1
        self._m_page_exhausted.inc()
        self._log(event="serve_page_exhausted", id=rid, needed=needed)

    # -- engine cycle ----------------------------------------------------

    def on_dispatch(self, kind: str) -> None:
        """One decode dispatch was COLLECTED: 'window' or 'verify' (an
        aborted one never lands tokens, so it is not counted). The
        tokens-per-dispatch figure divides by both kinds, so spec-on and
        spec-off runs compare on one denominator."""
        if kind == "verify":
            self.verify_dispatches += 1
        else:
            self.window_dispatches += 1
        self._m_dispatches.inc(kind=kind)

    def on_spec(self, *, drafted: int, accepted: int, emitted: int,
                slots: int) -> None:
        """A verify was collected: `drafted` tokens proposed across
        `slots` genuinely proposing rows (ride-alongs excluded),
        `accepted` of them emitted as-is, `emitted` those rows' tokens
        out (accepted plus one bonus pick a row with budget for it)."""
        self.spec_drafted += drafted
        self.spec_accepted += accepted
        self.spec_emitted += emitted
        self.spec_slot_verifies += slots
        if drafted:
            self._m_spec_drafted.inc(drafted)
        if accepted:
            self._m_spec_accepted.inc(accepted)
        self._log(event="serve_spec_verify", drafted=drafted,
                  accepted=accepted, emitted=emitted, slots=slots)

    def on_propose(self, seconds: float) -> None:
        """One drafting pass took `seconds` of wall time (the n-gram
        scans and/or the learned drafter's device calls). Rollup only:
        no event a cycle."""
        self.propose_s += float(seconds)
        self.propose_calls += 1

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
        dispatches = self.window_dispatches + self.verify_dispatches
        paged = self.kv_pages_total is not None
        out = {
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
            "serve_compiles_observed": self.compiles_observed,
            "serve_slot_faults": self.slot_faults,
            "serve_retries": self.retries,
            "serve_shed": self.shed,
            "serve_clamped": self.clamped,
            "serve_faults_injected": self.faults_injected,
            "serve_decode_dispatches": dispatches,
            "serve_tokens_per_dispatch": (
                round(self.tokens_out / dispatches, 3)
                if dispatches else None),
            # speculative decoding: tokens a dispatch is per SLOT a
            # verify (>1: speculation beat one token a step for the
            # slots that ran it); propose seconds None when nothing
            # drafted
            "serve_spec_verify_dispatches": self.verify_dispatches,
            "serve_spec_drafted": self.spec_drafted,
            "serve_spec_accepted": self.spec_accepted,
            "serve_spec_accept_rate": (
                round(self.spec_accepted / self.spec_drafted, 4)
                if self.spec_drafted else None),
            "serve_spec_tokens_per_dispatch": (
                round(self.spec_emitted / self.spec_slot_verifies, 3)
                if self.spec_slot_verifies else None),
            "serve_spec_propose_s": (
                round(self.propose_s, 6) if self.propose_calls else None),
            # paged KV: pool size and peak occupancy, the peak tokens
            # per device byte, how often the pool ran dry (None/0 on a
            # contiguous engine)
            "serve_kv_pages_total": self.kv_pages_total,
            "serve_kv_pages_used_peak": (
                self.kv_pages_used_peak if paged else None),
            "serve_kv_resident_tokens_peak": (
                self.kv_resident_tokens_peak if paged else None),
            "serve_kv_resident_bytes_peak": (
                self.kv_resident_bytes_peak if paged else None),
            "serve_kv_tokens_per_hbm_byte": (
                None if self.kv_tokens_per_byte_peak is None
                else round(self.kv_tokens_per_byte_peak, 6)),
            "serve_page_exhaustions": self.page_exhaustions,
            # the weight rollout: terminal outcomes, the last one, and
            # the stage the machine is in (0 / None without a rollout)
            "serve_rollouts": len(self.rollout_outcomes),
            "serve_rollout_outcome": (self.rollout_outcomes[-1]
                                      if self.rollout_outcomes else None),
            "serve_rollout_stage": self.rollout_stage,
        }
        if self.tenancy is not None:
            # one record per REGISTERED tenant, zeros included
            out["serve_tenants"] = {
                name: {
                    "requests": self.tenant_finished.get(name, 0),
                    "tokens": self.tenant_tokens.get(name, 0),
                    "ttft_ms_p50": _r(
                        _pct(self.tenant_ttft_s.get(name, []), 50), 1e3),
                    "ttft_ms_p95": _r(
                        _pct(self.tenant_ttft_s.get(name, []), 95), 1e3),
                    "shed": self.tenant_shed.get(name, 0),
                    "quota_rejections":
                        self.tenant_quota_rejections.get(name, 0),
                    "slo_breached": self.tenancy.breached(name),
                }
                for name in self.tenancy.names()}
        if self.compile_cache_summary is not None:
            out["serve_compile_cache"] = dict(self.compile_cache_summary)
        if self.prefix_cache is not None:
            out.update(self.prefix_cache.summary())
        return out

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
    tokens = finished = rejected = timed_out = shed = 0
    t_first, t_last = None, None
    for m in metrics_list:
        ttft.extend(m.ttft_s)
        queue_wait.extend(m.queue_wait_s)
        itl.extend(m.token_s)
        tokens += m.tokens_out
        finished += m.finished
        rejected += m.rejected
        timed_out += m.timed_out
        shed += m.shed
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
        "cluster_shed": shed,
        "cluster_tokens": tokens,
        "cluster_tokens_per_sec": (round(tokens / span, 2)
                                   if span and span > 0 else None),
        "cluster_ttft_ms_p50": _r(_pct(ttft, 50), 1e3),
        "cluster_ttft_ms_p95": _r(_pct(ttft, 95), 1e3),
        "cluster_queue_wait_ms_p95": _r(_pct(queue_wait, 95), 1e3),
        "cluster_itl_ms_p95": _r(_pct(itl, 95), 1e3),
    }
