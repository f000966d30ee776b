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
- **Resilience** -- with health checks armed (by default when a
  `RetryPolicy` is), a slot whose last-token logits are non-finite or
  blown up, or whose host invariants fail, is quarantined: the request
  re-queues after a backoff (keeping its deadline and trace id) or
  finishes with status ``error``. An engine failure releases every
  in-flight slot, records the entries as errors (`pop_failed`) and
  re-raises, so the queue stays serviceable.

The fault plan, the journal, brownout and tenancy (ROADMAP A9.4), the
speculative window (A9.3) and drain-and-migrate (A10) come with their
items; their knobs raise NotImplementedError naming the label.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import time
from collections import deque

from idc_models_tpu_torch.observe import profile as prof
from idc_models_tpu_torch.observe import trace
from idc_models_tpu_torch.serve.engine import HEALTH_KINDS, later

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
    # pending|running|retrying|ok|timeout|rejected|error
    status: str = "pending"
    # eos|budget|deadline|slot_fault|error|None
    finish_reason: str | None = None
    error: str | None = None         # engine failure detail (status=error)
    attempts: int = 1
    retried: bool = False
    not_before: float = 0.0


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
        for label, what, value in (
                ("A9.4", "the serve fault plan", fault_plan),
                ("A9.4", "the request journal", journal),
                ("A9.4", "brownout", brownout),
                ("A9.4", "tenancy", tenancy),
                ("A9.3", "a drafter (speculative decoding)", drafter)):
            if value is not None:
                raise later(label, what)
        self.engine = engine
        self.window = window
        self.queue = AdmissionQueue(max_queue_depth)
        self.max_prefills_per_cycle = max(int(max_prefills_per_cycle), 1)
        self.metrics = metrics
        self.retry = retry
        if health_checks is None:
            health_checks = retry is not None
        self.health_checks = bool(health_checks)
        self._retrying: list[Entry] = []
        self._closed = False
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

    # -- admission -------------------------------------------------------

    def close(self) -> None:
        """Every later `submit()` raises: accepted work can still be
        ticked to the end."""
        self._closed = True

    def submit(self, entry: Entry) -> bool:
        """Validate and enqueue. False when the queue is full
        (backpressure); raises on requests that could NEVER be served
        (caller errors, not load) and after `close()`."""
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
        entry.t_submit = self.clock()
        if entry.deadline is not None:
            entry.deadline = entry.t_submit + entry.deadline
        if not self.queue.push(entry):
            entry.status = "rejected"
            if self.metrics:
                self.metrics.on_reject(entry.rid, entry.t_submit)
            return False
        if entry.trace_id is None:
            entry.trace_id = _next_trace_id()
        # the request-lifecycle chain: a detached serve.request span
        # (submit -> finish) with the queued segment as its child; every
        # span carries rid
        entry.span = trace.start_span("serve.request", rid=entry.rid,
                                      trace_id=entry.trace_id)
        entry.queue_span = trace.start_span(
            "serve.queued", parent=entry.span.span_id, rid=entry.rid,
            trace_id=entry.trace_id)
        if self.metrics:
            self.metrics.on_submit(entry.rid, entry.t_submit)
        return True

    def _admit_free_slots(self) -> int:
        """Pop queued entries into free slots, at most
        max_prefills_per_cycle. On a chunked engine admission only
        reserves the slot; `_step_prefills` feeds the chunks."""
        admitted = 0
        free = self.engine.free_slots()
        while (admitted < self.max_prefills_per_cycle and free
               and len(self.queue)):
            e = self.queue.pop()
            slot = free.pop(0)
            eos = e.eos_id if e.eos_id is not None else -1
            e.slot, e.status, e.t_admit = slot, "running", self.clock()
            # registered BEFORE the engine call: an engine that raises
            # mid-admission finds the entry in the tracking dict and
            # fails it with the others
            if self._chunked:
                self._prefilling[slot] = e
                self.engine.start_prefill(slot, e.prompt, e.budget,
                                          rng=e.rng, eos_id=eos,
                                          tag=e.rid)
            else:
                self._running[slot] = e
                self.engine.admit(slot, e.prompt, e.budget, rng=e.rng,
                                  eos_id=eos, tag=e.rid)
            if e.queue_span is not None:
                e.queue_span.close(
                    queue_wait_ms=round((e.t_admit - e.t_submit) * 1e3,
                                        3))
            if self.metrics:
                self.metrics.on_admit(e.rid, e.t_admit - e.t_submit)
            admitted += 1
        return admitted

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

    def _tick(self) -> list[Entry]:
        now = self.clock()
        done: list[Entry] = []
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
            # counted at collect: an aborted window never lands tokens
            if out and self.metrics:
                self.metrics.on_dispatch("window")
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
        # 6. issue the next window over every occupied slot
        occupancy = len(self._running) / self.engine.n_slots
        if self._running:
            try:
                with trace.span("serve.window", window=self.window,
                                slots=len(self._running)) as _wsp:
                    if trace.get_tracer() is not None:
                        _wsp.set(rids=[e.rid for e
                                       in self._running.values()])
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
        if (self._running or admitted or chunk_steps) and self.metrics:
            self.metrics.on_cycle(queue_depth=len(self.queue),
                                  occupancy=occupancy, tokens=emitted,
                                  prefill_s=prefill_stall_s)
        return done

    def drain(self) -> list[Entry]:
        """Tick until every queued and running request has finished."""
        done = []
        while not self.idle():
            done.extend(self.tick())
        return done

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
                    self.metrics.on_first_token(e.rid, t_now - e.t_submit)
            e.tokens.extend(toks)
            emitted += len(toks)
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
                reason=(e.finish_reason or e.status), t=e.t_done)
