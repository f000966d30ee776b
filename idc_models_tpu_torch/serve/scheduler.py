"""Iteration-level scheduling over the slot engine: admission queue,
deadlines, prefill/decode interleave, slot recycling -- the counterpart
of ``idc_models_tpu/serve/scheduler.py``.

The engine (``serve/engine.py``) is a device-state machine with no
opinion on which request runs where or when; this module is the policy:

- **FIFO admission with backpressure** -- `AdmissionQueue` holds at most
  `max_depth` waiting requests; a submit beyond that is refused (the
  caller sees False and decides: retry, shed or block).
- **Deadlines** -- a request may carry one (seconds from submit).
  Queued requests past it are dropped without occupying a slot; running
  ones are cancelled mid-generation (partial tokens returned, the slot
  recycled); chunked prefills past it are cancelled.
- **Prefill-vs-decode interleave** -- each `tick()` admits at most
  `max_prefills_per_cycle` queued requests into free slots (and, on a
  chunked engine, runs at most that many chunks) before issuing one
  decode window.
- **Slot recycling** -- EOS, budget and deadline finishes release the
  row, and with `admit_after_collect` it refills on the same tick,
  before the next window is issued.
- **Page-aware admission** (paged engines) -- the queue HEAD leaves the
  queue only when the engine can grant pages for its prompt plus the
  decode reservation (`can_admit_pages`); FIFO holds (no skipping past a
  starved head), and the wait is counted as page-exhaustion
  backpressure. Before each window every running slot's grant grows to
  cover the window (`ensure_decode_room`); a slot the pool cannot cover
  is quarantined (``page_exhausted``) under the retry policy.
- **Speculative decoding** -- with a `drafter` and an engine built with
  `draft_k`, each cycle's dispatch may be a VERIFY (up to draft_k + 1
  tokens a slot) instead of a window: `_propose_drafts` builds every
  running slot's stream, asks the drafter (one `propose_batched` call
  when it has one, else `propose(history)` a slot), validates each
  proposal (`_check_proposal`) and falls back to the window when no
  slot proposed or any running slot lacks verify room.
- **Resilience** -- with health checks armed (by default when a
  `RetryPolicy` is), a slot whose last-token logits are non-finite or
  blown up, or whose host invariants fail, is quarantined: the request
  re-queues after a backoff (keeping its deadline and trace id) or
  finishes with status ``error``. An engine failure releases every
  in-flight slot, records the entries as errors (`pop_failed`) and
  re-raises, so the queue stays serviceable. A `ServeFaultPlan`
  (``serve/faults.py``) fires its faults at the start of the cycle its
  tick names, and arms the health checks by default.
- **Journal** -- a `RequestJournal` (``serve/journal.py``) records each
  accepted submit with its original relative deadline, batched progress
  and every finish, so a rebuilt server re-admits what a crash left in
  flight.
- **Brownout** -- a `BrownoutController` (``serve/brownout.py``) is fed
  the queue depth and the cycle's page pressure once a cycle; at its
  shed stage a submit is refused with a terminal ``shed`` status before
  the queue is consulted, and at its clamp stage an admission's budget
  is cut to the clamp (the page gate reads the clamped budget).
- **Tenancy** -- with a `Tenancy` (``serve/tenancy.py``) a submit
  resolves its tenant tag (an unknown tag raises); the tenant's own
  brownout sheds before the server-wide backpressure, and its
  `max_queued` quota refuses without touching the shared queue. The
  admission scan looks past entries whose tenant's slot or page quota
  blocks them (FIFO within each tenant, no tenant blocking the head of
  the line for another), while a global page exhaustion still stops it.
  The server-wide and the tenant's clamp compose by `min`. Every cycle
  evaluates each tenant's brownout on its own queue depth and its
  ``ttft:<name>`` SLO. The per-tenant counts are derived from the live
  queue and slot dicts each time, never kept incrementally.

- **Drain and migration** -- `quiesce` runs one cycle without the
  end-of-tick dispatch, leaving the engine dispatch-idle (the point a
  paged spot-check or a slot export needs). `begin_drain` stops
  admission for good (a submit then sheds); `export_running` lifts a
  decoding request's slot for a peer's `import_running`, and
  `drain_pending` hands back what never reached a slot.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import time
from collections import deque

import numpy as np

from idc_models_tpu_torch.observe import profile as prof
from idc_models_tpu_torch.observe import trace
from idc_models_tpu_torch.serve.engine import HEALTH_KINDS
from idc_models_tpu_torch.serve.faults import (
    InjectedEngineCrash, InjectedPrefillError,
)

# process-unique request trace ids (pid + a counter), stamped on every
# request whether or not a tracer is armed
_TRACE_IDS = itertools.count(1)


def _next_trace_id() -> str:
    return f"{os.getpid():x}-{next(_TRACE_IDS):x}"


@dataclasses.dataclass(eq=False)     # identity eq: prompts are arrays
class Entry:
    """One request's lifetime record inside the scheduler: identity and
    limits in, timestamps, tokens and finish state out. The api layer
    wraps it into the user-facing `Result`."""
    rid: object
    prompt: object                   # int [P]
    budget: int
    eos_id: int | None = None
    rng: object = None               # per-request seed or generator
    trace_id: str | None = None      # assigned at submit if not given
    # the cluster router's cluster.request root span id: this request's
    # serve.request span opens as its child, so a fleet's span export is
    # one tree (None: no router above)
    parent_span: object = None
    # request-lifecycle span handles (detached spans: they outlive any
    # one tick): submit -> finish, and the queued segment inside it
    span: object = None
    queue_span: object = None
    # RELATIVE seconds-from-submit when handed to submit(); rewritten to
    # the absolute clock time there
    deadline: float | None = None
    t_submit: float = 0.0
    t_admit: float | None = None
    t_first: float | None = None
    t_done: float | None = None
    slot: int | None = None
    tokens: list = dataclasses.field(default_factory=list)
    # pending|running|retrying|ok|timeout|rejected|shed|error
    status: str = "pending"
    # eos|budget|deadline|slot_fault|shed|error|None
    finish_reason: str | None = None
    error: str | None = None         # engine failure detail (status=error)
    attempts: int = 1
    retried: bool = False
    not_before: float = 0.0
    clamped: bool = False            # brownout shortened the budget
    # tenancy: the resolved tenant (None without tenancy), its engine
    # gather index, and the admission's page reservation its KV budget
    # is charged
    tenant: str | None = None
    tid: int = 0
    pages_reserved: int = 0


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded re-admission for requests recovered from a quarantined
    slot or a failed prefill. A retried request re-enters the queue
    FRONT after ``backoff_s * backoff_factor**k`` (k = prior retries),
    keeps its deadline and trace id, and restarts from its prompt; a
    retry whose backoff would land past the deadline finishes at once
    with the timeout status instead."""

    max_retries: int = 2
    backoff_s: float = 0.05
    backoff_factor: float = 2.0

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(f"need max_retries >= 0, got "
                             f"{self.max_retries}")
        if self.backoff_s < 0:
            raise ValueError(f"need backoff_s >= 0, got "
                             f"{self.backoff_s}")
        if self.backoff_factor < 1.0:
            raise ValueError(f"need backoff_factor >= 1, got "
                             f"{self.backoff_factor}")

    def delay(self, prior_retries: int) -> float:
        return self.backoff_s * self.backoff_factor ** prior_retries


class AdmissionQueue:
    """Bounded FIFO. `push` returns False at max_depth -- the
    backpressure signal -- instead of growing without bound."""

    def __init__(self, max_depth: int = 64):
        if max_depth < 1:
            raise ValueError(f"need max_depth >= 1, got {max_depth}")
        self.max_depth = max_depth
        self._q: deque[Entry] = deque()

    def __len__(self) -> int:
        return len(self._q)

    def push(self, entry: Entry) -> bool:
        if len(self._q) >= self.max_depth:
            return False
        self._q.append(entry)
        return True

    def pop(self) -> Entry:
        return self._q.popleft()

    def push_front(self, entry: Entry) -> None:
        """Head-of-line insertion for RETRIED entries only: they were
        admitted once already, so they do not cheat the bound."""
        self._q.appendleft(entry)

    def entries(self):
        """A lazy FIFO-order view (the admission scan usually stops at
        the head); do not hold it across a push, pop or take."""
        return iter(self._q)

    def take(self, entry: Entry) -> None:
        """Remove the entry the admission scan picked (identity match)."""
        self._q.remove(entry)

    def expire(self, now: float) -> list[Entry]:
        """Drop queued entries past their deadline; returns them."""
        expired = [e for e in self._q
                   if e.deadline is not None and now >= e.deadline]
        if expired:
            self._q = deque(e for e in self._q if e not in expired)
        return expired


class Scheduler:
    """Continuous-batching loop: one `tick()` = expire deadlines, admit
    up to `max_prefills_per_cycle` requests into free slots, collect the
    in-flight window and recycle its finished slots, issue the next
    window of `window` tokens. Returns the entries that finished."""

    def __init__(self, engine, *, window: int = 8, max_queue_depth: int = 64,
                 max_prefills_per_cycle: int = 1, metrics=None,
                 admit_after_collect: bool = True, clock=time.monotonic,
                 retry=None, fault_plan=None,
                 health_checks: bool | None = None, journal=None,
                 brownout=None, drafter=None, tenancy=None):
        if window < 1:
            raise ValueError(f"need window >= 1, got {window}")
        self.engine = engine
        self.window = window
        # speculative mode: with a drafter AND an engine built with
        # draft_k, a cycle's dispatch may be a verify (_propose_drafts)
        self.drafter = drafter
        self._spec = (drafter is not None
                      and getattr(engine, "draft_k", None) is not None)
        if drafter is not None and not self._spec:
            raise ValueError(
                "a drafter needs an engine built with draft_k — the "
                "verify program checks exactly that fixed draft length")
        # wall seconds spent in the drafting passes (host scans and the
        # learned drafter's device calls)
        self.propose_seconds = 0.0
        self.queue = AdmissionQueue(max_queue_depth)
        self.max_prefills_per_cycle = max(int(max_prefills_per_cycle), 1)
        self.metrics = metrics
        # resilience wiring, all off by default: retry = RetryPolicy,
        # fault_plan = serve/faults.ServeFaultPlan, journal =
        # serve/journal.RequestJournal, brownout =
        # serve/brownout.BrownoutController. Health checks default to
        # armed when quarantine could act on them or a plan poisons
        self.retry = retry
        self.fault_plan = fault_plan
        self.journal = journal
        self.brownout = brownout
        self.tenancy = tenancy
        if health_checks is None:
            health_checks = retry is not None or fault_plan is not None
        self.health_checks = bool(health_checks)
        self._retrying: list[Entry] = []
        self._cycle = 0
        self._prefill_error_pending = 0
        self._closed = False
        # drain mode: submits shed while accepted work finishes or moves
        # off (begin_drain)
        self._draining = False
        # quiesce(): suppress this cycle's end-of-tick dispatch
        self._skip_dispatch = False
        self.admit_after_collect = admit_after_collect
        self.clock = clock
        self._running: dict[int, Entry] = {}
        # chunked engines: entries whose prompt is still being chunked
        # into a reserved slot; they join _running when the final chunk
        # lands
        self._prefilling: dict[int, Entry] = {}
        # entries finalized by a tick that raised (pop_failed)
        self._failed: list[Entry] = []
        self._chunked = engine.prefill_chunk is not None
        # set when a paged engine refused pages this cycle (admission
        # gate or decode growth); the brownout's pressure input, reset
        # once a cycle
        self._page_pressure = False

    # -- admission -------------------------------------------------------

    def close(self) -> None:
        """Every later `submit()` raises: accepted work can still be
        ticked to the end."""
        self._closed = True

    def submit(self, entry: Entry) -> bool:
        """Validate and enqueue. False when the queue is full
        (backpressure) or the brownout sheds it (``entry.status ==
        "shed"``); raises on requests that could NEVER be served (caller
        errors, not load) and after `close()`."""
        if self._closed:
            raise RuntimeError(
                "Scheduler.submit() after close(): the serving loop "
                "has shut down and would never tick this request — "
                "build a new server instead of submitting to a dead "
                "queue")
        p_len = len(entry.prompt)
        if p_len < 1:
            raise ValueError("empty prompt")
        if entry.budget < 1:
            raise ValueError(f"need max_new_tokens >= 1, got "
                             f"{entry.budget}")
        if p_len + entry.budget > self.engine.t_max:
            raise ValueError(
                f"prompt {p_len} + max_new_tokens {entry.budget} exceeds "
                f"t_max {self.engine.t_max}")
        if self.engine.temperature > 0.0 and entry.rng is None:
            raise ValueError("sampling (temperature > 0) needs a "
                             "per-request rng key")
        # the effective stop token (request override, else the engine
        # default; -1 opts out), so finish reasons and the engine agree
        if entry.eos_id is None:
            entry.eos_id = self.engine.eos_id
        if entry.eos_id is not None and entry.eos_id < 0:
            entry.eos_id = None
        tenant_bc = None
        if self.tenancy is not None:
            # an unknown tag raises: billing it to the default tenant
            # would charge one tenant's quota for another's traffic
            t = self.tenancy.resolve(entry.tenant)
            entry.tenant, entry.tid = t.name, t.tid
            tenant_bc = self.tenancy.brownouts.get(t.name)
        entry.t_submit = self.clock()
        # a brownout shed is an honest terminal refusal, decided before
        # the queue is consulted so that shedding relieves the queue; the
        # tenant's own controller sheds that tenant alone
        tenant_shed = tenant_bc is not None and tenant_bc.shedding
        # drain mode sheds exactly like a brownout: a server that is
        # leaving refuses honestly instead of queueing
        shedding = self._draining or (self.brownout is not None
                                      and self.brownout.shedding)
        if shedding or tenant_shed:
            entry.status, entry.finish_reason = "shed", "shed"
            entry.t_done = entry.t_submit
            if entry.trace_id is None:
                entry.trace_id = _next_trace_id()
            tkw = ({"tenant": entry.tenant}
                   if entry.tenant is not None else {})
            trace.point("serve.shed", rid=entry.rid,
                        trace_id=entry.trace_id, **tkw)
            if self.metrics:
                # billed to the tenant only when its OWN controller shed
                # it: a server-wide shed is not the tenant's flood
                self.metrics.on_shed(
                    entry.rid,
                    tenant=entry.tenant if tenant_shed else None)
            return False
        if self.tenancy is not None:
            # the tenant's queue quota refuses without touching the
            # shared queue; not fed to the error-rate SLO (the refusal
            # is the isolation working)
            q = self.tenancy.quota(entry.tenant).max_queued
            if q is not None and self._tenant_queued(entry.tenant) >= q:
                entry.status = "rejected"
                if self.metrics:
                    self.metrics.on_tenant_quota(
                        entry.rid, tenant=entry.tenant, kind="queued")
                return False
        deadline_rel = entry.deadline
        if entry.deadline is not None:
            entry.deadline = entry.t_submit + entry.deadline
        if not self.queue.push(entry):
            entry.status = "rejected"
            if self.metrics:
                self.metrics.on_reject(entry.rid, entry.t_submit)
            return False
        if entry.trace_id is None:
            entry.trace_id = _next_trace_id()
        if self.journal is not None:
            self.journal.record_submit(entry, deadline_s=deadline_rel)
        # the request-lifecycle chain: a detached serve.request span
        # (submit -> finish) with the queued segment as its child; every
        # span carries rid
        tkw = ({"tenant": entry.tenant}
               if entry.tenant is not None else {})
        entry.span = trace.start_span("serve.request",
                                      parent=entry.parent_span,
                                      rid=entry.rid,
                                      trace_id=entry.trace_id, **tkw)
        entry.queue_span = trace.start_span(
            "serve.queued", parent=entry.span.span_id, rid=entry.rid,
            trace_id=entry.trace_id)
        if self.metrics:
            self.metrics.on_submit(entry.rid, entry.t_submit,
                                   tenant=entry.tenant)
        return True

    def _tenant_queued(self, tenant: str) -> int:
        """Queued entries `tenant` holds now, counted from the queue."""
        return sum(1 for e in self.queue.entries() if e.tenant == tenant)

    def _tenant_residency(self) -> tuple[dict, dict]:
        """(slots, pages) each tenant holds over the running and
        prefilling entries, counted from the live dicts: the ledger the
        per-tenant admission quotas read."""
        slots: dict[str, int] = {}
        pages: dict[str, int] = {}
        for e in (*self._running.values(), *self._prefilling.values()):
            if e.tenant is None:
                continue
            slots[e.tenant] = slots.get(e.tenant, 0) + 1
            pages[e.tenant] = pages.get(e.tenant, 0) + e.pages_reserved
        return slots, pages

    def _next_admission(self, clamp, slots_used, pages_used):
        """The entry the next admission takes and the clamp it gets, or
        (None, None): the earliest queued entry that its own tenant's
        slot and page quotas admit, FIFO within each tenant, once the
        page gate passes on the budget the clamp leaves. A GLOBAL page
        exhaustion stops the scan (skipping ahead of it would starve long
        requests forever; gating on the unclamped ask would wedge
        admission at the very stage meant to unwedge it). Without tenancy
        no quota applies, so this is the queue head or nothing."""
        for cand in self.queue.entries():
            quota = (self.tenancy.quota(cand.tenant)
                     if self.tenancy is not None else None)
            if (quota is not None and quota.max_resident_slots is not None
                    and slots_used.get(cand.tenant, 0)
                    >= quota.max_resident_slots):
                continue             # tenant-local: no head-of-line block
            bc = (self.tenancy.brownouts.get(cand.tenant)
                  if self.tenancy is not None else None)
            c = min((x for x in (clamp, bc and bc.token_clamp)
                     if x is not None), default=None)
            eff = cand.budget if c is None else min(cand.budget, c)
            if (quota is not None and quota.kv_page_budget is not None
                    and pages_used.get(cand.tenant, 0)
                    + self.engine.pages_for_admission(len(cand.prompt), eff)
                    > quota.kv_page_budget):
                continue             # waits for its own tenant's releases
            if not self._page_gate(cand, eff):
                return None, None    # global exhaustion: no skipping
            break
        else:
            return None, None
        self.queue.take(cand)
        return cand, c

    def _admit_free_slots(self) -> int:
        """Pop queued entries into free slots, at most
        max_prefills_per_cycle. On a chunked engine admission only
        reserves the slot; `_step_prefills` feeds the chunks."""
        admitted = 0
        free = self.engine.free_slots()
        clamp = (self.brownout.token_clamp if self.brownout is not None
                 else None)
        slots_used, pages_used = self._tenant_residency()
        while (admitted < self.max_prefills_per_cycle and free
               and len(self.queue)):
            e, clamp_e = self._next_admission(clamp, slots_used, pages_used)
            if e is None:
                break
            slot = free.pop(0)
            if clamp_e is not None and e.budget > clamp_e:
                # brownout stage 2 (the server's, the tenant's, or the
                # smaller of both): shorter answers beat no answers
                if self.metrics:
                    self.metrics.on_clamp(e.rid, asked=e.budget,
                                          clamp=clamp_e)
                e.budget, e.clamped = clamp_e, True
            e.pages_reserved = self.engine.pages_for_admission(
                len(e.prompt), e.budget)
            slots_used[e.tenant] = slots_used.get(e.tenant, 0) + 1
            pages_used[e.tenant] = (pages_used.get(e.tenant, 0)
                                    + e.pages_reserved)
            eos = e.eos_id if e.eos_id is not None else -1
            e.slot, e.status, e.t_admit = slot, "running", self.clock()
            # registered BEFORE the engine call: an engine that raises
            # mid-admission finds the entry in the tracking dict and
            # fails it with the others
            if self._chunked:
                self._prefilling[slot] = e
                self.engine.start_prefill(slot, e.prompt, e.budget,
                                          rng=e.rng, eos_id=eos,
                                          tag=e.rid, tid=e.tid)
            else:
                self._running[slot] = e
                self.engine.admit(slot, e.prompt, e.budget, rng=e.rng,
                                  eos_id=eos, tag=e.rid, tid=e.tid)
            if e.queue_span is not None:
                e.queue_span.close(
                    queue_wait_ms=round((e.t_admit - e.t_submit) * 1e3,
                                        3))
            if self.metrics:
                self.metrics.on_admit(e.rid, e.t_admit - e.t_submit)
            admitted += 1
        return admitted

    def _page_gate(self, entry: Entry, eff: int) -> bool:
        """True when the engine can grant pages for the entry's prompt
        and effective budget `eff` now (always, on a contiguous engine);
        on False the wait is recorded as page-exhaustion backpressure,
        the brownout's ``pages`` signal."""
        if self.engine.can_admit_pages(len(entry.prompt), eff):
            return True
        self._page_pressure = True
        if self.metrics:
            self.metrics.on_page_exhausted(
                rid=entry.rid, needed=len(entry.prompt) + entry.budget)
        return False

    def _step_prefills(self, done) -> int:
        """Advance pending chunked prefills: at most
        max_prefills_per_cycle chunks, oldest first. A chunk that raises
        is request-scoped when a retry policy is armed (quarantined,
        every other slot keeps serving); without one the error
        propagates to the tick's failure cleanup."""
        steps = 0
        while steps < self.max_prefills_per_cycle and self._prefilling:
            slot = next(iter(self._prefilling))
            try:
                if self._prefill_error_pending:
                    self._prefill_error_pending -= 1
                    raise InjectedPrefillError(
                        f"injected prefill-chunk failure (slot {slot})")
                finished = self.engine.prefill_step(slot)
            except Exception as exc:
                if self.retry is None:
                    raise
                e = self._prefilling.pop(slot)
                self.engine.cancel_prefill(slot)
                self._quarantine(e, "prefill_error", self.clock(), done,
                                 detail=f"{type(exc).__name__}: {exc}")
                steps += 1
                continue
            if finished:
                self._running[slot] = self._prefilling.pop(slot)
            steps += 1
        return steps

    def _quarantine(self, e: Entry, kind: str, now: float, done,
                    *, detail: str | None = None) -> None:
        """Recover ONE faulted request: re-queue it after the retry
        backoff when the policy and its deadline allow, else finish it
        with an honest status."""
        detail = detail or f"slot fault: {kind}"
        parent = e.span.span_id if e.span is not None else None
        trace.point("serve.slot_fault", parent=parent, rid=e.rid,
                    kind=kind, slot=e.slot, trace_id=e.trace_id)
        if self.metrics:
            self.metrics.on_slot_fault(e.rid, kind=kind, slot=e.slot)
        e.slot = None
        prior = e.attempts - 1
        can_retry = (self.retry is not None
                     and prior < self.retry.max_retries)
        delay = self.retry.delay(prior) if can_retry else 0.0
        deadline_blocks = (e.deadline is not None
                           and now + delay >= e.deadline)
        if can_retry and not deadline_blocks:
            # restart from the prompt: the tokens so far came from (or
            # raced) the poisoned state, and a clean rerun re-derives
            # the request's stream
            e.attempts += 1
            e.retried = True
            e.tokens = []
            e.t_first = None
            e.status = "retrying"
            e.not_before = now + delay
            self._retrying.append(e)
            trace.point("serve.retry", parent=parent, rid=e.rid,
                        attempt=e.attempts,
                        delay_ms=round(delay * 1e3, 3),
                        trace_id=e.trace_id)
            if self.metrics:
                self.metrics.on_retry(e.rid, attempt=e.attempts,
                                      delay_s=delay)
            return
        if deadline_blocks or (e.deadline is not None
                               and now >= e.deadline):
            e.status, e.finish_reason = "timeout", "deadline"
        else:
            e.status, e.finish_reason = "error", "slot_fault"
            e.error = f"{detail} (attempt {e.attempts})"
        e.t_done = now
        self._finish(e, done)

    # -- the cycle -------------------------------------------------------

    def idle(self) -> bool:
        return (not self._running and not self._prefilling
                and not len(self.queue) and not self._retrying
                and self.engine._pending is None)

    def load(self) -> int:
        """Requests this scheduler holds now: queued, prefilling,
        running and waiting to retry. The cluster router's least-loaded
        placement signal: one integer, no device traffic."""
        return (len(self.queue) + len(self._running)
                + len(self._prefilling) + len(self._retrying))

    def _apply_faults(self, cycle: int) -> None:
        """Fire the plan's non-burst faults for this cycle, a pure
        function of (plan, cycle). Bursts are arrivals: the server
        submits them."""
        for f in self.fault_plan.at(cycle):
            if self.metrics:
                self.metrics.on_fault_injected(f.kind, tick=cycle)
            if f.kind == "stall":
                time.sleep(f.seconds)
            elif f.kind == "crash":
                exc = InjectedEngineCrash(
                    f"injected engine crash at cycle {cycle}")
                self._abort_running(exc)
                raise exc
            elif f.kind in ("nan_logits", "garbage_logits"):
                self.engine.inject_slot_fault(f.slot, f.kind)
            elif f.kind == "prefill_error":
                self._prefill_error_pending += 1

    def _requeue_retries(self, now: float, done) -> None:
        """Move quarantined entries whose backoff elapsed back to the
        queue FRONT (oldest first); ones whose deadline died while they
        waited finish honestly."""
        due, waiting = [], []
        for e in self._retrying:
            if e.deadline is not None and now >= e.deadline:
                e.status, e.finish_reason = "timeout", "deadline"
                e.t_done = now
                self._finish(e, done)
            elif now >= e.not_before:
                e.status = "pending"
                due.append(e)
            else:
                waiting.append(e)
        self._retrying = waiting
        for e in reversed(due):
            self.queue.push_front(e)

    def _check_slot_health(self, now: float, got, done) -> list:
        """The per-cycle health pass over the running slots, after the
        collect and before the next window: a poisoned slot is
        quarantined before a token is sampled from it, and its
        just-collected tokens are dropped."""
        codes = self.engine.slot_health()
        quarantined = set()
        for slot, e in list(self._running.items()):
            kind = HEALTH_KINDS.get(int(codes[slot]))
            if kind is None and not self.engine.slot_invariants_ok(slot):
                kind = "invariant"
            if kind is None:
                continue
            self.engine.release(slot)
            del self._running[slot]
            quarantined.add(id(e))
            self._quarantine(e, kind, now, done)
        if not quarantined:
            return got
        return [(e, t) for e, t in got if id(e) not in quarantined]

    def tick(self) -> list[Entry]:
        """One pipelined cycle: admission and result bookkeeping run
        while the previously issued window computes; the tick ends by
        issuing the next window. Traced as one `serve.tick` span with
        `serve.admit`, `serve.collect` and `serve.window` inside it."""
        with trace.span("serve.tick"):
            return self._tick()

    def quiesce(self) -> list[Entry]:
        """One normal cycle with the end-of-tick dispatch suppressed: the
        in-flight window is collected and finalized as `tick` would, and
        nothing new is issued, so the engine is left dispatch-idle (the
        point a paged engine's `spot_check_params` and `export_slot`
        need). The next `tick` dispatches again."""
        self._skip_dispatch = True
        try:
            with trace.span("serve.tick", quiesce=True):
                return self._tick()
        finally:
            self._skip_dispatch = False

    def _tick(self) -> list[Entry]:
        now = self.clock()
        done: list[Entry] = []
        # 0. the fault drill's faults for this cycle fire before any
        #    work, so the cycle a fault names is the cycle it perturbs
        cycle = self._cycle
        self._cycle += 1
        if self.fault_plan is not None:
            self._apply_faults(cycle)
        # 1. queued requests past deadline never occupy a slot
        for e in self.queue.expire(now):
            e.status, e.finish_reason, e.t_done = "timeout", "deadline", now
            self._finish(e, done)
        # 1.5 quarantined entries whose backoff elapsed re-queue
        if self._retrying:
            self._requeue_retries(now, done)
        # 2. admit into known-free slots and advance chunked prefills,
        #    overlapping the in-flight window; an engine failure here
        #    fails every in-flight entry before it propagates
        t_pf = self.clock()
        with trace.span("serve.admit") as _sp, \
                prof.compiling("serve.admit"):
            try:
                admitted = self._admit_free_slots()
                chunk_steps = (self._step_prefills(done) if self._chunked
                               else 0)
            except Exception as e:
                self._failed.extend(done)
                self._abort_running(e)
                raise
            _sp.set(admitted=admitted, chunk_steps=chunk_steps)
        prefill_stall_s = self.clock() - t_pf
        # 3. collect the in-flight window; recycle on EOS / budget
        with trace.span("serve.collect") as _sp:
            try:
                out = self.engine.collect()
            except Exception as e:
                self._failed.extend(done)
                self._abort_running(e)
                raise
            _sp.set(slots=len(out),
                    tokens=sum(len(t) for t in out.values()))
            # counted at collect: an aborted dispatch never lands tokens;
            # a collected verify reports its accept ledger
            spec = self.engine.last_spec
            if (out or spec) and self.metrics:
                self.metrics.on_dispatch("verify" if spec else "window")
            if spec and self.metrics:
                self.metrics.on_spec(**spec)
        t_now = self.clock()
        got: list[tuple[Entry, list]] = []
        finished: list[Entry] = []
        for slot, toks in out.items():
            e = self._running.get(slot)
            if e is None:            # cancelled while the window flew
                continue
            got.append((e, toks))
            if self.engine.finished(slot):
                self.engine.release(slot)
                del self._running[slot]
                finished.append(e)
        # 3.5 per-window slot health
        if self.health_checks and self._running:
            got = self._check_slot_health(now, got, done)
        # 4. running requests past deadline are cancelled (after the
        #    collect, so their partial tokens reach the result);
        #    prefilling ones drop their partial chunks
        cancelled: list[Entry] = []
        for slot, e in list(self._running.items()):
            if e.deadline is not None and now >= e.deadline:
                self.engine.release(slot)
                del self._running[slot]
                cancelled.append(e)
        for slot, e in list(self._prefilling.items()):
            if e.deadline is not None and now >= e.deadline:
                self.engine.cancel_prefill(slot)
                del self._prefilling[slot]
                cancelled.append(e)
        # 5. second admission pass: slots the just-collected window
        #    freed refill before the next window (a recycle idles one
        #    window, not two); its host time joins the decode stall
        if self.admit_after_collect:
            t_pf2 = self.clock()
            try:
                with trace.span("serve.admit", refill=True) as _sp:
                    n2 = self._admit_free_slots()
                    _sp.set(admitted=n2)
                admitted += n2
            except Exception as e:
                self._finalize_window(got, finished, cancelled, t_now,
                                      now, self._failed)
                self._failed.extend(done)
                self._abort_running(e)
                raise
            prefill_stall_s += self.clock() - t_pf2
        # 5.5 paged engines: grow every running slot's grant to cover
        #     the next window; a slot the pool cannot cover even after
        #     reclaiming snapshots is quarantined now (retry or an
        #     honest finish, never a window decoding past its last
        #     page), its just-collected tokens dropped as a health
        #     quarantine's are (a retry restarts from the prompt)
        if self._running:
            need = self.window
            if self._spec:
                need = max(need, self.engine.draft_k + 1)
            starved = self.engine.ensure_decode_room(need)
            if starved:
                self._page_pressure = True
                quarantined = set()
                for slot in starved:
                    e = self._running.pop(slot, None)
                    if e is None:
                        continue
                    if self.metrics:
                        self.metrics.on_page_exhausted(rid=e.rid,
                                                       needed=need)
                    self.engine.release(slot)
                    quarantined.add(id(e))
                    self._quarantine(e, "page_exhausted", now, done)
                got = [(e, t) for e, t in got if id(e) not in quarantined]
        # 6. start the next dispatch over every occupied slot: the
        #    window, or (speculative mode, when the drafter proposed and
        #    every running slot has verify room) one verify
        occupancy = len(self._running) / self.engine.n_slots
        if self._running and not self._skip_dispatch:
            try:
                proposal = (self._propose_drafts(got) if self._spec
                            else None)
                rids = ([e.rid for e in self._running.values()]
                        if trace.get_tracer() is not None else None)
                if proposal is not None:
                    drafts, vlive, proposed = proposal
                    with trace.span("serve.verify",
                                    k=self.engine.draft_k,
                                    slots=int(vlive.sum()),
                                    hits=int(proposed.sum())) as _wsp:
                        if rids is not None:
                            _wsp.set(rids=rids)
                        self.engine.begin_verify(drafts, vlive, proposed)
                else:
                    with trace.span("serve.window", window=self.window,
                                    slots=len(self._running)) as _wsp:
                        if rids is not None:
                            _wsp.set(rids=rids)
                        self.engine.begin_window(self.window)
            except Exception as e:
                self._finalize_window(got, finished, cancelled, t_now,
                                      now, self._failed)
                self._failed.extend(done)
                self._abort_running(e)
                raise
        # 7. deferred bookkeeping, while the new window computes
        emitted = self._finalize_window(got, finished, cancelled, t_now,
                                        now, done)
        # the brownout runs every cycle, drain cycles included (its
        # hysteresis must watch the queue empty), with the cycle's page
        # pressure beside the queue depth
        page_pressure, self._page_pressure = self._page_pressure, False
        if self.brownout is not None:
            self.brownout.evaluate(queue_depth=len(self.queue),
                                   pressure=page_pressure)
        # each tenant's brownout, every cycle too, on ITS queue depth and
        # ttft:<name> SLO: one tenant escalating leaves the others normal
        if self.tenancy is not None:
            depths: dict[str, int] = {}
            for e in self.queue.entries():
                if e.tenant is not None:
                    depths[e.tenant] = depths.get(e.tenant, 0) + 1
            for name, bc in self.tenancy.brownouts.items():
                bc.evaluate(queue_depth=depths.get(name, 0))
            self.tenancy.evaluate()
            if self.metrics:
                slots_used, pages_used = self._tenant_residency()
                self.metrics.on_tenant_cycle(
                    self.tenancy.names(), depths=depths,
                    slots=slots_used, pages=pages_used)
        if (self._running or admitted or chunk_steps) and self.metrics:
            self.metrics.on_cycle(queue_depth=len(self.queue),
                                  occupancy=occupancy, tokens=emitted,
                                  prefill_s=prefill_stall_s)
            stats = self.engine.page_stats()
            if stats is not None:
                self.metrics.on_pages(**stats)
        return done

    def _propose_drafts(self, got):
        """The speculative policy pass, host work before the next
        dispatch: each running slot's FULL stream (prompt, bookkept
        tokens and this cycle's just-collected ones) goes to the drafter,
        and the result is (drafts [S, k], vlive [S], proposed [S]) for a
        verify -- `proposed` marking the rows with a real proposal -- or
        None for the plain window when no slot proposed or ANY running
        slot lacks verify room (`engine.spec_room`: such a slot is
        within draft_k + 1 tokens of finishing). Slots with room but no
        proposal ride along with zero drafts: a verify row whose drafts
        all miss emits exactly a window step's one token. A drafter with
        `propose_batched` (the learned DraftLM, or a chain holding one)
        gets one call for every slot; every proposal passes
        `_check_proposal`, and the pass's wall time accrues to
        `propose_seconds`."""
        eng = self.engine
        k = eng.draft_k
        # one slot without room vetoes the verify: check before drafting
        for slot in self._running:
            if not eng.spec_room(slot):
                return None
        just = {id(e): t for e, t in got}
        drafts = np.zeros((eng.n_slots, k), np.int64)
        vlive = np.zeros(eng.n_slots, bool)
        proposed = np.zeros(eng.n_slots, bool)
        slots, hists = [], []
        for slot, e in self._running.items():
            vlive[slot] = True
            slots.append(slot)
            hists.append(np.concatenate([
                np.asarray(e.prompt, np.int64).ravel(),
                np.asarray(e.tokens + just.get(id(e), []), np.int64)]))
        t0 = self.clock()
        batched = getattr(self.drafter, "propose_batched", None)
        if batched is not None:
            props = batched(eng, slots, hists)
        else:
            props = {s: self.drafter.propose(h)
                     for s, h in zip(slots, hists)}
        dt = self.clock() - t0
        self.propose_seconds += dt
        if self.metrics:
            self.metrics.on_propose(dt)
        for slot in slots:
            prop = self._check_proposal(props.get(slot), k)
            if prop is None:
                continue
            drafts[slot] = prop
            proposed[slot] = True
        if not proposed.any():
            return None
        return drafts, vlive, proposed

    def _check_proposal(self, prop, k: int):
        """The one validation point between a `propose()` return and
        `begin_verify`: a malformed proposal raises an error naming the
        drafter class and the contract. None passes through: it is the
        contract's own nothing-to-verify answer."""
        if prop is None:
            return None
        name = type(self.drafter).__name__
        contract = (f"the models/draft.py contract: propose(history) "
                    f"-> np.ndarray [k={k}] integer token ids in "
                    f"[0, {self.engine.vocab}), or None")
        arr = np.asarray(prop)
        if not np.issubdtype(arr.dtype, np.integer):
            raise ValueError(
                f"{name}.propose returned dtype {arr.dtype}: draft "
                f"tokens are ids the verify program compares against "
                f"the target's own integer picks — {contract}")
        if arr.ndim != 1:
            raise ValueError(
                f"{name}.propose returned shape {tuple(arr.shape)}: the "
                f"verify program takes ONE flat row of drafts per slot "
                f"— {contract}")
        if arr.shape[0] != k:
            raise ValueError(
                f"{name}.propose returned {arr.shape[0]} tokens; the "
                f"verify program checks exactly k={k} — {contract}")
        vocab = self.engine.vocab
        if (arr < 0).any() or (arr >= vocab).any():
            bad = arr[(arr < 0) | (arr >= vocab)][0]
            raise ValueError(
                f"{name}.propose returned out-of-vocab id {int(bad)} "
                f"(vocab is {vocab}): the verify embedding gather would "
                f"read a DIFFERENT token than proposed — {contract}")
        return arr

    def drain(self) -> list[Entry]:
        """Tick until every queued and running request has finished."""
        done = []
        while not self.idle():
            done.extend(self.tick())
        return done

    # -- drain and migration ----------------------------------------------

    @property
    def draining(self) -> bool:
        return self._draining

    def begin_drain(self) -> None:
        """Stop admitting for good: every later submit is refused with
        the terminal ``shed`` status, while what was accepted ticks to
        its end unless moved off first (`drain_pending`,
        `export_running`)."""
        self._draining = True

    def running_ids(self) -> list:
        """Ids of the requests decoding in a slot (not queued, not
        prefilling): what `export_running` can move."""
        return [e.rid for e in self._running.values()]

    def export_running(self, rid):
        """Detach one decoding request for migration: ``(entry,
        snapshot)``, the Entry itself (tokens, timestamps, spans and
        identity travel with it) and its slot's `SlotEngine.export_slot`.
        The slot is released without finishing the entry: no Result, and
        nothing journaled -- this journal's open submit covers the gap
        until the caller records the ``migrated`` finish once a peer's
        import has landed. Needs the engine dispatch-idle (`quiesce`)."""
        for slot, e in self._running.items():
            if e.rid == rid:
                break
        else:
            raise ValueError(f"request {rid!r} is not running here — "
                             f"only decoding slots export "
                             f"(running_ids() lists them)")
        snap = self.engine.export_slot(slot)
        del self._running[slot]
        self.engine.release(slot)
        e.slot = None
        return e, snap

    def import_running(self, entry: Entry, snap: dict) -> bool:
        """The peer half of a migration: claim a free slot, insert the
        snapshot (`SlotEngine.import_slot`) and adopt the entry as
        running; it decodes from this scheduler's next window. False,
        consuming nothing, when this scheduler is closed, draining or has
        no free slot. On success the request is journaled here as a
        normal submit (its deadline made relative), so a crash after this
        point recovers it from this journal."""
        if self._closed or self._draining:
            return False
        free = self.engine.free_slots()
        if not free:
            return False
        slot = free[0]
        self.engine.import_slot(slot, snap, tid=entry.tid)
        entry.slot = slot
        entry.status = "running"
        self._running[slot] = entry
        if self.journal is not None:
            deadline_rel = (None if entry.deadline is None else
                            max(entry.deadline - self.clock(), 0.0))
            self.journal.record_submit(entry, deadline_s=deadline_rel)
        return True

    def drain_pending(self) -> list[Entry]:
        """Take everything accepted but not yet decoding -- the queue,
        the retry waiters and the chunked prefills in progress (their
        partial chunks dropped: a prefill from the prompt elsewhere gives
        the same stream) -- for placement on another server. Each entry
        goes back to pending with no slot and its spans closed
        ``migrated``."""
        out: list[Entry] = []
        while len(self.queue):
            out.append(self.queue.pop())
        out.extend(self._retrying)
        self._retrying = []
        for slot, e in list(self._prefilling.items()):
            self.engine.cancel_prefill(slot)
            del self._prefilling[slot]
            out.append(e)
        for e in out:
            e.status, e.slot = "pending", None
            e.tokens = []
            e.t_first = None
            if e.queue_span is not None:
                e.queue_span.close(migrated=True)
                e.queue_span = None
            if e.span is not None:
                e.span.close(status="migrated", reason="drain")
                e.span = None
        return out

    def pop_failed(self) -> list[Entry]:
        """Entries finalized by a tick that raised, since the last call:
        the engine failure's casualties (status error) and entries that
        tick had already completed, with their true statuses."""
        out, self._failed = self._failed, []
        return out

    def _finalize_window(self, got, finished, cancelled, t_now, now,
                         sink) -> int:
        """The per-window result bookkeeping (token extension, first-
        token stamps, finish statuses), shared by the normal pass and
        the failure salvage. Returns the emitted-token count."""
        emitted = 0
        progress = {} if self.journal is not None else None
        for e, toks in got:
            if toks and e.t_first is None:
                e.t_first = t_now
                trace.point(
                    "serve.first_token",
                    parent=(e.span.span_id if e.span is not None
                            else None),
                    rid=e.rid,
                    ttft_ms=round((t_now - e.t_submit) * 1e3, 3))
                if self.metrics:
                    self.metrics.on_first_token(e.rid, t_now - e.t_submit,
                                                tenant=e.tenant)
            e.tokens.extend(toks)
            emitted += len(toks)
            if progress is not None and toks:
                progress[e.rid] = len(e.tokens)
        if progress:
            # one batched, strided record a cycle
            self.journal.record_progress(progress)
        for e in finished:
            e.status, e.t_done = "ok", t_now
            e.finish_reason = (
                "eos" if (e.eos_id is not None and e.tokens
                          and e.tokens[-1] == e.eos_id)
                else "budget")
            self._finish(e, sink)
        # deadline cancels finish after the extension above folded in
        # what the flying window carried
        for e in cancelled:
            e.status, e.finish_reason = "timeout", "deadline"
            e.t_done = now
            self._finish(e, sink)
        return emitted

    def _abort_running(self, exc: Exception) -> None:
        """Engine failure cleanup: fail every in-flight entry and release
        its slot, so neither the engine nor the queue is wedged when the
        caller survives the re-raised error."""
        now = self.clock()
        detail = f"{type(exc).__name__}: {exc}"
        for slot, e in list(self._running.items()):
            try:
                self.engine.release(slot)
            except Exception:  # noqa: S110 -- engine already failed;
                pass           # cleanup must reach every slot regardless
            e.status, e.finish_reason = "error", "error"
            e.error, e.t_done = detail, now
            self._finish(e, self._failed)
        self._running.clear()
        for slot, e in list(self._prefilling.items()):
            try:
                self.engine.cancel_prefill(slot)
            except Exception:  # noqa: S110 -- same: reach every slot
                pass
            e.status, e.finish_reason = "error", "error"
            e.error, e.t_done = detail, now
            self._finish(e, self._failed)
        self._prefilling.clear()
        # a window the failed engine still holds in flight would wedge
        # idle()/collect(); its work is lost either way
        self.engine.abort_window()

    def _finish(self, e: Entry, done: list[Entry]) -> None:
        done.append(e)
        if self.journal is not None:
            self.journal.record_finish(e.rid, e.status,
                                       reason=e.finish_reason)
        # close the lifecycle chain: the queued child first (a no-op if
        # admission closed it), then serve.request with the outcome
        if e.queue_span is not None:
            e.queue_span.close(expired=True)
        if e.span is not None:
            e.span.close(status=e.status, reason=e.finish_reason,
                         tokens=len(e.tokens))
        if self.metrics:
            ttft = (e.t_first - e.t_submit
                    if e.t_first is not None else None)
            decode_s = (e.t_done - e.t_first
                        if e.t_first is not None and e.t_done is not None
                        else 0.0)
            self.metrics.on_finish(
                e.rid, n_tokens=len(e.tokens), ttft_s=ttft,
                decode_s=decode_s,
                reason=(e.finish_reason or e.status), t=e.t_done,
                tenant=e.tenant)
