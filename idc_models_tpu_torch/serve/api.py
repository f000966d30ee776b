"""User-facing serving surface: `Request` / `Result`, the synchronous
`submit()` / `poll()` API and `run(trace)` trace replay -- the
counterpart of ``idc_models_tpu/serve/api.py``.

`LMServer` composes `SlotEngine` (the device state machine, contiguous
or paged), `Scheduler` (admission queue, deadlines, interleave,
recycling, page-aware admission, speculative verify), an optional prefix
cache, `ServingMetrics` (TTFT, throughput, occupancy, pages, the
speculative ledger), the resilience knobs -- a retry policy, a fault
plan, a request journal (with `resubmit_pending` for crash recovery) and
a brownout controller -- tenancy (``serve/tenancy.py``: per-tenant
adapters, quotas, SLOs and brownouts on one engine), and the hooks of a
weight rollout (``checkpoint/rollout.py``): `quiesce`, `swap_params` and
`canary_clone`:

    server = LMServer(params, embed_dim=..., num_heads=...,
                      num_blocks=..., t_max=..., n_slots=4, window=8)
    server.submit(Request(id="a", prompt=(1, 2, 3), max_new_tokens=16))
    while server.poll("a") is None:
        server.step()                  # one scheduler tick
    print(server.poll("a").tokens)

`poisson_trace` synthesizes open-loop Poisson arrivals, and
`save_trace` / `load_trace` move the same ``(arrival_s, Request)`` list
through a JSONL file (byte for byte the JAX package's format).
`run(trace)` replays either, by the wall clock (``realtime=True``) or
as a burst.

**Over ranks** (`mesh` across a world of several processes, one a
rank): JAX drives every device from one process, the port runs one
process a rank, so every rank runs this same server -- the same
submits, the same scheduler -- and must make the same host decisions in
the same order (admissions, slot choice, windows, releases, retries,
sheds, tenancy picks), or a collective deadlocks. The only host input
that can differ between ranks is time, so `Lockstep` hands every clock
the server's decisions read (the scheduler's, the brownout's, the
SLOs', the tenancy's and the replay's, and the drain flag) rank 0's
reading, broadcast over a host group; and after every tick it compares
a digest of what the tick decided across the ranks and raises if any
rank differs. The merged logits are the same on every rank, and each
slot's sampling generator is seeded alike, so the tokens are too.
Rank 0 alone writes the journal (`collectives.is_writer`); the `serve`
verb gives it alone the logger, the exporter and standard output.

`compile_cache` (``serve/compile_cache.py``): the engine's warmup loads
or builds and stores its programs' kernel libraries, and the counters
reach `ServingMetrics.on_compile_cache`.
"""

from __future__ import annotations

import dataclasses
import json
import time
import zlib
from pathlib import Path

import numpy as np
import torch

from idc_models_tpu_torch import collectives


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request. `seed` derives the request's private
    sampling stream (``torch.Generator(device).manual_seed(seed)``, the
    stream a serial `Generator` call given that generator draws);
    `deadline_s` is seconds from submit after which the request is
    dropped (queued) or cancelled (running); `eos_id` overrides the
    server's stop token (-1: never stop early); `trace_id` labels the
    request's spans (None: assigned at submit); `tenant` names the
    registered tenant a multi-tenant server bills it to (None: the
    default tenant)."""
    id: str
    prompt: tuple
    max_new_tokens: int
    eos_id: int | None = None
    seed: int | None = None
    deadline_s: float | None = None
    trace_id: str | None = None
    tenant: str | None = None


@dataclasses.dataclass
class Result:
    """What came back: `tokens` are the generated ids only, cut at EOS
    (inclusive). `status` is "ok" (ran to EOS or budget), "timeout"
    (deadline hit, possibly with partial tokens), "rejected" (queue full
    with on_full="reject"), "shed" (refused by the brownout's shed
    stage: retry later or elsewhere), or "error" (the engine failed
    mid-flight, or a quarantined slot ran out of retries; `error` says
    which). `attempts` / `retried` show the retry policy's work;
    `clamped` that the brownout cut the budget at admission."""
    id: str
    tokens: list
    status: str
    finish_reason: str | None = None
    ttft_ms: float | None = None
    latency_ms: float | None = None
    error: str | None = None
    trace_id: str | None = None
    attempts: int = 1
    retried: bool = False
    clamped: bool = False


class LMServer:
    """Continuous-batching server over one `attention_lm` parameter tree
    (JAX-shaped, or an `AttentionLM`), on `device` (CUDA unless "cpu").
    With `warmup` the engine runs each of its programs once before the
    first request.

    `spec_decode=True` arms speculative decoding: the engine verifies
    `draft_k` drafted tokens a slot, and the scheduler's drafter is
    `drafter` (any object with ``propose(history) -> [k] ids | None``)
    or by default ``NGramDrafter(draft_k, order=draft_order)``. A
    learned drafter (``models/draft_lm.DraftLM``, or a `ChainedDrafter`
    holding one) exposes `.learned`, which arms the engine's drafter
    state.

    `journal` is a `RequestJournal` or a path; `brownout` a
    `BrownoutController`, handed the server's prefix cache unless it
    holds one; `fault_plan` a `ServeFaultPlan`, whose bursts `step`
    submits. `tenancy` is a `TenantRegistry`, built here against this
    model's vocab with the server's logger, registry and clock (an
    adapter of the wrong vocab fails the build, not the first request),
    or a `Tenancy` already built; its adapter bank arms the engine's
    pick-time hook."""

    def __init__(self, params, *, embed_dim: int, num_heads: int,
                 num_blocks: int, t_max: int, n_slots: int = 4,
                 window: int = 8, mesh=None, cache_dtype=None,
                 block_impl: str = "jnp", temperature: float = 0.0,
                 top_k: int | None = None, pad_id: int = 0,
                 eos_id: int | None = None, max_queue_depth: int = 64,
                 max_prefills_per_cycle: int = 1,
                 admit_after_collect: bool = True, logger=None,
                 warmup: bool = True, clock=time.monotonic,
                 prefill_chunk: int | None = None,
                 prefix_cache_mb: float = 0.0,
                 kv_dtype: str | None = None, slo=None, retry=None,
                 fault_plan=None, health_checks: bool | None = None,
                 journal=None, brownout=None, prefix_cache=None,
                 spec_decode: bool = False, draft_k: int = 8,
                 draft_order: int = 3, drafter=None,
                 kv_page_size: int | None = None,
                 kv_pages: int | None = None,
                 kv_decode_reserve: int | None = None, registry=None,
                 tenancy=None, partition_rules=None,
                 draft_partition_rules=None, compile_cache=None,
                 device=None):
        from idc_models_tpu_torch.serve.engine import SlotEngine
        from idc_models_tpu_torch.serve.metrics import ServingMetrics
        from idc_models_tpu_torch.serve.prefix_cache import (
            PagedPrefixCache, PrefixCache,
        )
        from idc_models_tpu_torch.serve.scheduler import Scheduler

        # every setting canary_clone needs to build a config-identical
        # server over candidate weights
        self._clone_cfg = dict(
            embed_dim=embed_dim, num_heads=num_heads,
            num_blocks=num_blocks, t_max=t_max, n_slots=n_slots,
            window=window, mesh=mesh, cache_dtype=cache_dtype,
            block_impl=block_impl, temperature=temperature, top_k=top_k,
            pad_id=pad_id, eos_id=eos_id, max_queue_depth=max_queue_depth,
            max_prefills_per_cycle=max_prefills_per_cycle,
            admit_after_collect=admit_after_collect, warmup=warmup,
            clock=clock, prefill_chunk=prefill_chunk, kv_dtype=kv_dtype,
            spec_decode=spec_decode, draft_k=draft_k,
            draft_order=draft_order, drafter=drafter,
            kv_page_size=kv_page_size, kv_pages=kv_pages,
            kv_decode_reserve=kv_decode_reserve,
            partition_rules=partition_rules,
            draft_partition_rules=draft_partition_rules,
            compile_cache=compile_cache, device=device)
        self._clone_logger = logger
        # prefix reuse rides the chunk grid, so the budget needs chunked
        # admission. An existing cache may be passed instead of a budget
        # (a server rebuilt around the old one's snapshots). With paged
        # KV the budget builds a PagedPrefixCache, its MB converted to
        # pages when the engine binds its allocator.
        if prefix_cache is not None and prefix_cache_mb:
            raise ValueError("pass prefix_cache OR prefix_cache_mb, "
                             "not both")
        if prefix_cache is None and prefix_cache_mb and prefix_cache_mb > 0:
            if prefill_chunk is None:
                raise ValueError("prefix_cache_mb needs prefill_chunk")
            if kv_page_size is not None or kv_pages is not None:
                prefix_cache = PagedPrefixCache(
                    prefill_chunk, budget_mb=prefix_cache_mb,
                    logger=logger, registry=registry)
            else:
                prefix_cache = PrefixCache(
                    prefill_chunk, int(prefix_cache_mb * 1024 * 1024),
                    logger=logger, registry=registry)
        if drafter is not None and not spec_decode:
            raise ValueError("a custom drafter needs spec_decode=True")
        if spec_decode and drafter is None:
            from idc_models_tpu_torch.models.draft import NGramDrafter

            drafter = NGramDrafter(draft_k, order=draft_order)
        # a learned drafter's model handle arms the engine's drafter
        # state; host drafters leave it None
        draft_model = getattr(drafter, "learned", None)
        if draft_model is None and draft_partition_rules is not None:
            raise ValueError(
                "draft_partition_rules without a learned drafter: the "
                "rules place models/draft_lm.DraftLM params — pass "
                "drafter=DraftLM(...) (or a ChainedDrafter containing "
                "one), or drop the rules")
        # ranks that serve together read one clock: rank 0's
        self._lockstep = (Lockstep(mesh.host_group()) if mesh is not None
                          and mesh.size > 1 else None)
        if self._lockstep is not None:
            clock = self._lockstep.wrap(clock)
            if not collectives.is_writer():
                journal = None
        self.compile_cache = compile_cache
        if tenancy is not None and hasattr(tenancy, "build"):
            tenancy = tenancy.build(
                vocab=int(np.shape(_head_kernel(params))[1]),
                logger=logger, registry=registry, clock=clock)
        dad = getattr(draft_model, "adapters", None)
        if (tenancy is not None and dad is not None
                and np.shape(dad[0])[0] != len(tenancy.names())):
            raise ValueError(
                f"drafter adapter bank has {np.shape(dad[0])[0]} tenant "
                f"rows but the tenancy registers {len(tenancy.names())} "
                f"tenants — the drafter's heads are gathered by the same "
                f"tenant ids, so give it one row per registered tenant "
                f"(zeros for tenants without a drafter head)")
        self.tenancy = tenancy
        self.engine = SlotEngine(
            params, embed_dim=embed_dim, num_heads=num_heads,
            num_blocks=num_blocks, t_max=t_max, n_slots=n_slots,
            mesh=mesh,
            cache_dtype=(torch.bfloat16 if cache_dtype is None
                         else cache_dtype),
            block_impl=block_impl, temperature=temperature, top_k=top_k,
            pad_id=pad_id, eos_id=eos_id, prefill_chunk=prefill_chunk,
            prefix_cache=prefix_cache, kv_dtype=kv_dtype,
            draft_k=draft_k if spec_decode else None,
            kv_page_size=kv_page_size, kv_pages=kv_pages,
            kv_decode_reserve=kv_decode_reserve,
            adapter_bank=tenancy.bank if tenancy is not None else None,
            partition_rules=partition_rules, draft_model=draft_model,
            draft_partition_rules=draft_partition_rules, device=device)
        self.metrics = ServingMetrics(logger, prefix_cache=prefix_cache,
                                      registry=registry, slo=slo,
                                      tenancy=tenancy)
        # the WAL of accepted work a rebuilt server recovers from
        if journal is not None and not hasattr(journal, "record_submit"):
            from idc_models_tpu_torch.serve.journal import RequestJournal

            journal = RequestJournal(journal)
        self.journal = journal
        # the brownout degrades the prefix cache first: hand it ours
        # unless the caller wired its own
        if (brownout is not None and brownout.prefix_cache is None
                and prefix_cache is not None):
            brownout.prefix_cache = prefix_cache
        self.brownout = brownout
        self._fault_plan = fault_plan
        self.scheduler = Scheduler(
            self.engine, window=window, max_queue_depth=max_queue_depth,
            max_prefills_per_cycle=max_prefills_per_cycle,
            admit_after_collect=admit_after_collect,
            metrics=self.metrics, clock=clock, retry=retry,
            fault_plan=fault_plan, health_checks=health_checks,
            journal=journal, brownout=brownout, drafter=drafter,
            tenancy=tenancy)
        if self._lockstep is not None:
            self._lockstep.wrap_clocks(
                brownout, getattr(brownout, "slo", None), slo,
                getattr(tenancy, "slo", None),
                *getattr(tenancy, "brownouts", {}).values())
        self._results: dict[str, Result] = {}
        self._inflight: set[str] = set()
        if warmup:
            self.engine.warmup(window, compile_cache=compile_cache)
        if compile_cache is not None:
            self.metrics.on_compile_cache(compile_cache)

    # -- synchronous API -------------------------------------------------

    def submit(self, request: Request, *, parent_span=None) -> bool:
        """Enqueue a request. False = backpressure (queue at max depth)
        or a brownout shed (then `poll` answers a "shed" Result); raises
        ValueError for requests that could never be served. `parent_span`
        (a span id) parents the request's serve.request span: the cluster
        router passes its cluster.request root."""
        from idc_models_tpu_torch.serve.scheduler import Entry

        prior = self._results.get(request.id)
        if ((prior is not None and prior.status != "shed")
                or request.id in self._inflight):
            # a duplicate in flight would overwrite the other's Result;
            # a shed id, refused before any work, may try again
            raise ValueError(f"request id {request.id!r} already used")
        entry = Entry(
            rid=request.id,
            prompt=np.asarray(request.prompt, np.int64),
            budget=int(request.max_new_tokens),
            eos_id=request.eos_id, rng=request.seed,
            deadline=request.deadline_s, trace_id=request.trace_id,
            parent_span=parent_span, tenant=request.tenant)
        if not self.scheduler.submit(entry):
            if entry.status == "shed":
                # a shed is terminal, not transient backpressure
                r = _to_result(entry)
                self._results[r.id] = r
            # backpressure: no Result, the caller may retry the same id
            return False
        # a resubmit after a shed: poll answers None until it finishes
        self._results.pop(request.id, None)
        self._inflight.add(request.id)
        return True

    def close(self) -> None:
        """Shut the server down: submit() afterwards raises, and the
        journal, if any, is flushed closed. Accepted work can still be
        drained first."""
        self.scheduler.close()
        if self.journal is not None:
            self.journal.close()

    def resubmit_pending(self, journal_path) -> list[str]:
        """Crash recovery: re-admit every request `journal_path` shows
        accepted but unfinished, in submit order, through the normal
        admission path (chunked prefill and prefix-cache hits included);
        returns the re-admitted ids. Each keeps its journaled id, seed,
        deadline, trace id and tenant (billed to that tenant again), and
        its greedy or seeded tokens are the uncrashed run's (the engine's
        serial-parity contract). A request this server can never serve
        (a tenant since decommissioned, a prompt past a smaller t_max) is
        skipped with a warning and stays in the WAL, so one stale entry
        does not stop the others coming back."""
        import warnings

        from idc_models_tpu_torch.serve.journal import pending_requests

        out = []
        for req in pending_requests(journal_path):
            try:
                ok = self.submit(req)
            except ValueError as e:
                warnings.warn(
                    f"journal recovery skipped request {req.id!r}: "
                    f"{e} — it remains in the WAL; rerun against a "
                    f"configuration that can serve it",
                    stacklevel=2)
                continue
            if ok:
                out.append(req.id)
        return out

    def _fire_bursts(self) -> None:
        """Submit the fault plan's burst arrivals for the next scheduler
        cycle, through the normal (backpressure- and shed-visible) path;
        the cycle counter moves once a tick, so each burst fires once."""
        cycle = self.scheduler._cycle
        for f in self._fault_plan.bursts_at(cycle):
            self.metrics.on_fault_injected("burst", tick=cycle)
            for req in self._fault_plan.burst_requests(
                    f, vocab=self.engine.vocab, t_max=self.engine.t_max):
                self.submit(req)

    def step(self) -> list[Result]:
        """One scheduler tick (admissions + one decode window); returns
        the requests that finished on it. If the ENGINE fails mid-tick
        the error propagates, but the in-flight requests are first
        recorded as status="error" Results (slots released, queue
        intact), so poll() answers for them and a caller can go on."""
        if self._fault_plan is not None:
            self._fire_bursts()
        return self._cycle(self.scheduler.tick)

    def quiesce(self) -> list[Result]:
        """One cycle that collects the in-flight window without issuing
        another (`Scheduler.quiesce`): the dispatch-idle point a paged
        engine's spot-check and a slot export need. The same result and
        failure bookkeeping as `step`."""
        return self._cycle(self.scheduler.quiesce)

    def _cycle(self, tick_fn) -> list[Result]:
        finished = []
        try:
            ticked = tick_fn()
        except Exception:
            for e in self.scheduler.pop_failed():
                r = _to_result(e)
                self._results[r.id] = r
                self._inflight.discard(r.id)
            raise
        for e in ticked:
            r = _to_result(e)
            self._results[r.id] = r
            self._inflight.discard(r.id)
            finished.append(r)
        if self._lockstep is not None:
            sched = self.scheduler
            self._lockstep.check(
                f"tick {sched._cycle}",
                (sched._cycle, len(sched.queue), sorted(self._inflight),
                 [(r.id, r.status, r.tokens) for r in finished],
                 self.engine.free_slots()))
        return finished

    def poll(self, rid: str) -> Result | None:
        """The finished Result for `rid`, or None while it is queued or
        running."""
        return self._results.get(rid)

    def results(self) -> list[Result]:
        """Every finished Result so far (what a caller salvages when
        run() is interrupted by an engine failure)."""
        return list(self._results.values())

    def drain(self) -> list[Result]:
        """Tick until idle; returns everything that finished."""
        out = []
        while not self.scheduler.idle():
            out.extend(self.step())
        return out

    # -- trace replay ----------------------------------------------------

    def idle(self) -> bool:
        """Nothing queued, prefilling, retrying, running or in flight."""
        return self.scheduler.idle()

    def begin_drain(self) -> None:
        """Stop admitting for good (`Scheduler.begin_drain`): later
        submits are shed, what was accepted ticks to its end."""
        self.scheduler.begin_drain()

    def target(self, request: Request) -> "LMServer":
        """The server whose queue `request` enters: this one (a rollout's
        controller splits the traffic over two)."""
        return self

    def run(self, trace, *, realtime: bool = False,
            on_full: str = "block", stop=None) -> list[Result]:
        """Replay ``[(arrival_s, Request), ...]`` and drain (`replay`).
        With ``realtime=True`` requests are held until their arrival
        offset on the wall clock (the honest open-loop TTFT); with False
        the trace replays as fast as the engine drains it, arrival order
        kept. `on_full` is the client's backpressure policy: "block"
        re-offers the head request every tick until the queue takes it;
        "reject" records a rejected Result and moves on. `stop()`, polled
        between cycles, ends the offers and drains what was accepted."""
        if self._lockstep is not None and stop is not None:
            stop = self._lockstep.agree(stop)
        return replay(self, trace, clock=self.scheduler.clock,
                      realtime=realtime, on_full=on_full, stop=stop)

    def summary(self) -> dict:
        return self.metrics.summary()

    def swap_adapters(self, u, v) -> None:
        """Hot-swap the per-tenant adapter bank (the base weights stay):
        see `SlotEngine.swap_adapters` for the shapes and the error on a
        server without tenancy."""
        self.engine.swap_adapters(u, v)

    # -- weight rollout ----------------------------------------------------

    def swap_params(self, params) -> None:
        """Promote candidate weights onto this server's engine in place
        (`SlotEngine.swap_params`). The rollout's metrics are its
        controller's (``checkpoint/rollout.py``)."""
        self.engine.swap_params(params)

    def canary_clone(self, params, *, registry=None,
                     logger=None) -> "LMServer":
        """A second server over CANDIDATE weights, built with every
        setting of this one: the canary a rollout routes a fraction of
        traffic onto. It shares the tenancy (quotas and per-tenant SLOs
        bill across both sides of the split) and nothing else: no prefix
        cache (its snapshots were computed under the live weights), no
        journal, no fault plan, no brownout, and a fresh metrics
        registry unless `registry` is given."""
        if registry is None:
            from idc_models_tpu_torch.observe import MetricsRegistry

            registry = MetricsRegistry()
        return LMServer(
            params, tenancy=self.tenancy, registry=registry,
            logger=self._clone_logger if logger is None else logger,
            **self._clone_cfg)


class Lockstep:
    """The host half of a server whose ranks serve together (module
    docstring, "Over ranks"), over `group` (``Mesh.host_group``): rank
    0's clock readings and flags on every rank, and a per-tick check that
    every rank decided alike. Every rank must make the same calls in the
    same order."""

    def __init__(self, group):
        self.group = group

    def wrap(self, clock):
        """`clock` as rank 0 reads it, on every rank."""
        if getattr(clock, "lockstep", False):
            return clock

        def read():
            return collectives.broadcast_host(
                [clock() if collectives.is_writer() else 0.0],
                self.group)[0]

        read.lockstep = True
        return read

    def wrap_clocks(self, *owners) -> None:
        """Give each of `owners` that has a ``clock`` (a brownout, an
        SLO engine; None is skipped) rank 0's reading of it."""
        for o in owners:
            if o is not None and hasattr(o, "clock"):
                o.clock = self.wrap(o.clock)

    def agree(self, flag):
        """`flag()` as rank 0 answers it, on every rank (the drain's
        stop flag: a signal reaches ranks at different moments)."""
        return lambda: bool(collectives.broadcast_host(
            [float(bool(flag())) if collectives.is_writer() else 0.0],
            self.group)[0])

    def check(self, where: str, decided) -> None:
        """Raise unless every rank's `decided` (a repr-able record of a
        tick's decisions) equals rank 0's."""
        digest = zlib.crc32(repr(decided).encode())
        digests = collectives.all_gather(
            torch.tensor([digest], dtype=torch.int64),
            self.group)[:, 0].tolist()
        bad = [r for r, d in enumerate(digests) if d != digests[0]]
        if bad:
            raise RuntimeError(
                f"serving ranks {bad} decided otherwise than rank 0 at "
                f"{where}: every rank must run the same calls in the "
                f"same order")


def replay(front, trace, *, clock, realtime: bool = False,
           on_full: str = "block", on_offer=None, stop=None) -> list[Result]:
    """The one trace-replay loop, of `LMServer.run` and
    ``checkpoint.run_with_rollout``: offer ``[(arrival_s, Request), ...]``
    to `front` in arrival order and tick it until every accepted request
    has finished. `front` submits, polls, steps, reports `idle` and
    begins a drain as `LMServer` does, and ``front.target(request)`` is
    the server whose queue the request enters. `on_offer(i)` runs before
    the i-th request is offered. `stop()` is polled before every cycle,
    between ticks: once it returns true the front stops admitting
    (`begin_drain`), nothing more of the trace is offered, and the loop
    ticks on until what was accepted has finished (the serve verb's
    SIGTERM drain). Returns the Results of the accepted requests, and of
    those refused for good (shed, or rejected with ``on_full="reject"``)."""
    if on_full not in ("block", "reject"):
        raise ValueError(f"on_full must be 'block' or 'reject', "
                         f"got {on_full!r}")
    trace = sorted(trace, key=lambda tr: tr[0])
    t0 = clock()
    out, i, draining = [], 0, False
    while i < len(trace) or not front.idle():
        if not draining and stop is not None and stop():
            draining = True
            front.begin_drain()
        if draining:
            if front.idle():
                break
            out.extend(front.step())
            continue
        now = clock() - t0
        while i < len(trace) and (not realtime or trace[i][0] <= now):
            if on_offer is not None:
                on_offer(i)
            req = trace[i][1]
            target = front.target(req)
            # in block mode, do not OFFER a request the queue cannot
            # take: each refused submit counts as a rejection (a
            # shedding server answers at once, so it is offered)
            shedding = (target.brownout is not None
                        and target.brownout.shedding)
            if (on_full == "block" and not shedding
                    and len(target.scheduler.queue)
                    >= target.scheduler.queue.max_depth):
                break
            if front.submit(req):
                i += 1
                continue
            shed = front.poll(req.id)
            if shed is not None and shed.status == "shed":
                out.append(shed)
                i += 1
            elif on_full == "reject":
                r = Result(id=req.id, tokens=[], status="rejected")
                target._results[r.id] = r
                out.append(r)
                i += 1
            else:
                break
        if realtime and front.idle() and i < len(trace):
            # nothing running and the next arrival is in the future
            time.sleep(min(max(trace[i][0] - (clock() - t0), 0.0),
                           0.005))
            continue
        out.extend(front.step())
    return out


def _head_kernel(params):
    """The vocab head's kernel [E, V] of a JAX-shaped tree or an
    `AttentionLM`."""
    if isinstance(params, dict):
        return params["head"]["kernel"]
    return params.head.kernel


def _to_result(e) -> Result:
    return Result(
        id=e.rid, tokens=list(e.tokens), status=e.status,
        finish_reason=e.finish_reason, error=e.error,
        trace_id=e.trace_id, attempts=e.attempts, retried=e.retried,
        clamped=e.clamped,
        ttft_ms=(None if e.t_first is None
                 else (e.t_first - e.t_submit) * 1e3),
        latency_ms=(None if e.t_done is None
                    else (e.t_done - e.t_submit) * 1e3))


# -- traces ---------------------------------------------------------------


def poisson_trace(n_requests: int, *, rate_per_s: float, vocab: int,
                  t_max: int, prompt_lens=(4, 16), budgets=(4, 16),
                  eos_id: int | None = None,
                  deadline_s: float | None = None, seed: int = 0,
                  sampled: bool = False, tenants=None):
    """Synthetic open-loop arrivals: exponential inter-arrival times at
    `rate_per_s`, prompt lengths and budgets uniform over the inclusive
    ranges (clamped so prompt + budget <= t_max). With ``sampled=True``
    each request carries its own seed. `tenants` tags arrivals
    round-robin. The same draws as the JAX package's, so the same
    arguments give the same trace. Returns ``[(arrival_s, Request),
    ...]``."""
    rng = np.random.default_rng(seed)
    t, trace = 0.0, []
    lo_p, hi_p = prompt_lens
    lo_b, hi_b = budgets
    tenants = list(tenants) if tenants else None
    for i in range(n_requests):
        t += float(rng.exponential(1.0 / rate_per_s))
        p_len = int(rng.integers(lo_p, hi_p + 1))
        p_len = min(p_len, t_max - 1)
        budget = int(rng.integers(lo_b, hi_b + 1))
        budget = min(budget, t_max - p_len)
        prompt = tuple(int(x) for x in rng.integers(0, vocab, p_len))
        trace.append((t, Request(
            id=f"r{i}", prompt=prompt, max_new_tokens=budget,
            eos_id=eos_id, deadline_s=deadline_s,
            seed=(int(rng.integers(0, 2**31)) if sampled else None),
            tenant=(tenants[i % len(tenants)] if tenants else None))))
    return trace


def save_trace(path, trace) -> str:
    """Write ``[(arrival_s, Request), ...]`` as JSONL, one request per
    line -- the format `run` / `load_trace` and ``serve --trace``
    share."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for t, r in trace:
            rec = {
                "t": t, "id": r.id, "prompt": list(r.prompt),
                "max_new_tokens": r.max_new_tokens, "eos_id": r.eos_id,
                "seed": r.seed, "deadline_s": r.deadline_s}
            if r.tenant is not None:
                # written only when tagged: untagged traces keep the
                # format's original bytes
                rec["tenant"] = r.tenant
            f.write(json.dumps(rec) + "\n")
    return str(path)


def load_trace(path):
    """Read a `save_trace` JSONL file back into ``[(t, Request), ...]``."""
    trace = []
    for line in Path(path).read_text().splitlines():
        if not line.strip():
            continue
        d = json.loads(line)
        trace.append((float(d.get("t", 0.0)), Request(
            id=str(d["id"]), prompt=tuple(d["prompt"]),
            max_new_tokens=int(d["max_new_tokens"]),
            eos_id=d.get("eos_id"), seed=d.get("seed"),
            deadline_s=d.get("deadline_s"), tenant=d.get("tenant"))))
    return trace
