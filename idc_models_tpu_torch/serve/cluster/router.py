"""The cluster router: one public submit/poll/drain surface over N
`LMServer` replicas — SLO-aware placement, prefill/decode
disaggregation over the prefix-registry handoff, straggler hedging,
graceful drain, and journal-backed failover -- the counterpart of
``idc_models_tpu/serve/cluster/router.py``, on the port's own control
plane:

- **Placement** reads each replica's health document (the in-process
  twin of `/healthz`): a replica is a candidate only while live, not
  draining, not brownout-shedding, under its queue bound, and — paged
  engines — holding page headroom for THIS request; candidates order
  by (SLO burning, load, fewest free slots), ties broken by fleet
  order, so placement is a pure function of observable state and
  drills replay deterministically.
- **Disaggregation**: with dedicated `role="prefill"` replicas armed,
  a prompt reaching the first chunk boundary is first driven through
  `Replica.prefill_only` — chunked prefill to the last boundary, each
  boundary snapshot published into the cluster `PrefixRegistry` — and
  the decode replica's normal admission then ADOPTS the published
  prefix: the decode replica never runs those chunks, and the tokens
  are bit-identical to a single-replica run because the snapshot IS
  the chunk program's output (gated by test). A prompt the registry
  already covers skips the prefill replica entirely — the hot system
  prompt is prefilled once, cluster-wide.
- **Hedging** (`hedge_after_s`): a request still unfinished that long
  after placement is duplicated onto the least-loaded OTHER replica;
  the first finisher answers under the original id and the loser is
  discarded — the classic tail-latency trade (bounded duplicated
  work), bounded per request by the `RetryPolicy`'s max_retries.
- **Drain**: `drain_replica` flips the replica to draining (placement
  stops; its brownout — when armed — jumps to the shed stage) while
  its in-flight work steps to completion — or, `migrate=True`, leaves
  WITH it: queued work re-places onto the fleet and RUNNING slots
  move live (mid-decode KV + sampling state export/import, output
  bit-identical), the source journal staying open across the
  export→import gap so a crash inside it replays the request.
- **Elasticity** (`autoscaler=`): an `Autoscaler` reads the health
  documents every step and the router applies its decisions — scale-
  up builds a replica through `replica_factory`, scale-down drains
  the least-loaded live replica with slot migration. When EVERY
  decode-capable replica is draining or dead, `submit` answers with a
  terminal shed instead of a retry-forever False.
- **Failover**: a replica whose step raises (or is killed by the
  drill) is marked dead; terminal results its final tick salvaged are
  adopted, and everything its journal WAL shows accepted-but-
  unfinished is resubmitted through the NORMAL placement path onto
  survivors — original id, seed, relative deadline, and trace_id
  preserved (the journal contract), so recovered greedy/seeded output
  is bit-identical (the engine's serial-parity contract; gated by
  test).
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np

from idc_models_tpu_torch.observe import metrics_registry as mreg
from idc_models_tpu_torch.observe import trace
from idc_models_tpu_torch.serve.api import Request, Result
from idc_models_tpu_torch.serve.journal import pending_requests
from idc_models_tpu_torch.serve.metrics import aggregate_summaries
from idc_models_tpu_torch.serve.scheduler import _next_trace_id


def _entry_request(entry) -> Request:
    """Rebuild a `Request` from a scheduler entry — the drain path's
    fallback for work this router never placed itself (a direct
    replica submit) or can no longer seat live. Mirrors the journal's
    submit record: id, prompt, budget, eos, integer seed, trace and
    tenant identity (an explicit generator is not re-placeable — the
    same documented limit as the WAL's)."""
    seed = (int(entry.rng)
            if isinstance(entry.rng, (int, np.integer)) else None)
    return Request(
        id=str(entry.rid),
        prompt=tuple(int(t) for t in np.asarray(entry.prompt)
                     .reshape(-1)),
        max_new_tokens=int(entry.budget), eos_id=entry.eos_id,
        seed=seed, trace_id=entry.trace_id,
        tenant=getattr(entry, "tenant", None))


class Router:
    """Front end over a fleet of `Replica`s (serve/cluster/replica.py).

    The router owns the public surface: `submit`/`poll`/`step`/
    `drain`/`run(trace)` mirror `LMServer`'s so a caller scales from
    one replica to N without changing shape. `retry` (a scheduler
    `RetryPolicy`) bounds per-request re-placements (migrations +
    hedges); `prefix_registry` arms cross-replica prefix reuse and the
    prefill/decode handoff; `slo` (an `observe.slo.SLOEngine`) is fed
    cluster-level TTFT/error samples — the router's own burn-rate
    alerting over the whole fleet."""

    def __init__(self, replicas, *, retry=None, hedge_after_s=None,
                 prefix_registry=None, slo=None, logger=None,
                 registry=None, clock=time.monotonic,
                 tenant_affinity_slack: int | None = 4,
                 autoscaler=None, replica_factory=None):
        replicas = list(replicas)
        if not replicas:
            raise ValueError("need at least one replica")
        ids = [r.replica_id for r in replicas]
        if len(set(ids)) != len(ids):
            raise ValueError(f"replica ids must be unique, got {ids}")
        if hedge_after_s is not None and hedge_after_s <= 0:
            raise ValueError(f"need hedge_after_s > 0, got "
                             f"{hedge_after_s}")
        if autoscaler is not None and replica_factory is None:
            raise ValueError(
                "an autoscaler needs a replica_factory: a scale-up "
                "decision has to BUILD the replica it adds (a callable "
                "replica_id -> Replica; serve/cluster/replica.py's "
                "build_replica partial is the usual one)")
        # misconfigured disaggregation fails at FLEET BUILD, not on the
        # first caller's submit: a prefill replica is useless without
        # chunked prefill (boundary snapshots are the artifact) and
        # without a registry to publish through, and its chunk grid
        # must match the registry's
        for r in replicas:
            if r.role != "prefill":
                continue
            chunk = r.server.engine.prefill_chunk
            if chunk is None:
                raise ValueError(
                    f"prefill replica {r.replica_id!r} was built "
                    f"without prefill_chunk — boundary snapshots are "
                    f"the handoff artifact")
            if prefix_registry is None:
                raise ValueError(
                    f"prefill replica {r.replica_id!r} needs a "
                    f"prefix_registry: the handoff artifact travels "
                    f"through it")
            if chunk != prefix_registry.chunk:
                raise ValueError(
                    f"prefill replica {r.replica_id!r} chunk {chunk} "
                    f"!= registry chunk {prefix_registry.chunk} — "
                    f"snapshots live on one grid")
        self.replicas = replicas
        self._by_id = {r.replica_id: r for r in replicas}
        self.retry = retry
        self.hedge_after_s = hedge_after_s
        self.prefix_registry = prefix_registry
        self.slo = slo
        self.logger = logger
        self.clock = clock
        reg = registry if registry is not None else mreg.REGISTRY
        # kept public: ClusterTelemetry folds the router's own
        # cluster_* series into the fleet exposition from here
        self.registry = reg
        self._m_placements = reg.counter(
            "cluster_placements_total",
            "requests placed on a replica by the router",
            labels=("replica",))
        self._m_migrations = reg.counter(
            "cluster_migrations_total",
            "journaled requests migrated off a dead replica onto "
            "survivors")
        self._m_handoffs = reg.counter(
            "cluster_handoffs_total",
            "prefill->decode handoffs (a dedicated prefill replica "
            "published the prompt's boundary snapshot for the decode "
            "replica to adopt)")
        self._m_hedges = reg.counter(
            "cluster_hedges_total",
            "straggler requests duplicated onto a second replica")
        self._m_deaths = reg.counter(
            "cluster_replica_deaths_total",
            "replicas marked dead (step failure or kill drill)")
        self._m_slot_migrations = reg.counter(
            "cluster_slot_migrations_total",
            "mid-decode slots exported off a draining replica and "
            "imported live onto a peer (KV + sampling state move; "
            "decode continues bit-identically)")
        self._m_scale = reg.counter(
            "cluster_scale_events_total",
            "autoscaler decisions applied to the fleet",
            labels=("action",))
        # tenant affinity (serve/tenancy.py): a tenant's
        # requests stick to the replica that last served them — its
        # prefix cache holds the tenant's system-prompt snapshots and
        # its engine the tenant's warm state — unless that replica is
        # more than `tenant_affinity_slack` requests more loaded than
        # the best candidate (None disables affinity). Affinity never
        # overrides admissibility: a draining/shedding/full home just
        # loses the tenant to the normal least-loaded placement.
        self.tenant_affinity_slack = tenant_affinity_slack
        self._tenant_home: dict[str, object] = {}
        self._m_affinity = reg.counter(
            "cluster_tenant_affinity_placements_total",
            "placements routed to the tenant's home replica by "
            "affinity (prefix-cache / adapter warmth)",
            labels=("tenant",))
        self._g_live = reg.gauge(
            "cluster_replicas_live",
            "replicas currently live (placeable fleet size)")
        self._g_live.set(len(replicas))
        # results finalized OUTSIDE a replica's step return (failover
        # adoption, retry-exhausted/journal-less losses) — drained into
        # the next step()'s return so drain()/run() keep their
        # "returns everything that finished" contract
        self._out_of_band: list[Result] = []
        # rid -> current owning replica / original Request / submit
        # stamp / total placement attempts; hedge copy id -> original
        self._owner: dict = {}
        self._requests: dict = {}
        self._submit_t: dict = {}
        self._attempts: dict = {}
        self._hedges: dict = {}
        self._hedged: set = set()
        # hedge copy id -> the replica it runs on (failover cleanup)
        self._hedge_target: dict = {}
        # rids already routed through the handoff decision — submit()
        # re-offers under backpressure, and each re-offer must not
        # re-prefill or duplicate the handoff record
        self._handed_off: set = set()
        self._results: dict[str, Result] = {}
        # migrated requests waiting for a survivor with room, in the
        # dead replica's original submit order
        self._pending_migration: list[Request] = []
        # rid -> DRAINING source replica whose journal still holds the
        # open submit: once the re-placement lands, the source writes
        # the terminal "migrated" finish (a dead source — failover —
        # never appears here; its journal is closed and the WAL itself
        # is the recovery record)
        self._migrating_from: dict = {}
        self.placements: dict[str, int] = {i: 0 for i in ids}
        self.migrations: list[dict] = []
        self.handoffs: list[dict] = []
        # live mid-decode slot moves ({rid, from, to}), distinct from
        # `migrations` (re-placements that re-run from the prompt)
        self.slot_migrations: list[dict] = []
        self.hedges_sent = 0
        # elasticity (serve/cluster/autoscaler.py): the autoscaler
        # reads the health documents each step and the router applies
        # its decisions — scale-up through replica_factory/add_replica,
        # scale-down through drain_replica(migrate=True)
        self.autoscaler = autoscaler
        self.replica_factory = replica_factory
        self._next_replica_ordinal = len(replicas)
        # cluster-wide sheds happen at the ROUTER (no replica ever
        # sees the request), so they must be counted here — replica
        # metrics cannot
        self.cluster_sheds = 0
        # the open weight rollout, if any (start_rollout/finish_rollout)
        self._rollout: dict | None = None
        # an armed ClusterWatchdog (serve/cluster/telemetry.py) runs
        # its detector pass once per step — assigned after
        # construction (the watchdog needs the router to exist first)
        self.watchdog = None
        # fleet trace context: the router assigns each
        # request its trace_id AT THE DOOR (so every hop event carries
        # it even before any replica accepts the work), numbers the
        # hops per request, and holds one detached cluster.request root
        # span per in-flight request — each replica's serve.request
        # span opens as its child, so the merged cross-process span
        # export is one tree under one trace_id
        self._trace_ids: dict[str, str] = {}
        self._hop_seq: dict[str, int] = {}
        self._root_span: dict[str, object] = {}
        # rid -> source replica_id of a pending from-the-prompt
        # re-placement (drain or failover) so the cluster_migrate hop
        # can name where the work came FROM, not just where it landed
        self._migration_src: dict[str, str] = {}

    # -- placement --------------------------------------------------------

    def _score(self, replica, health) -> tuple:
        """Lower is better. SLO-burning replicas sort last among the
        admissible; then least loaded; then fewest free slots as the
        tiebreak (prefer topping up an already-warm replica over waking
        an idle one is the WRONG call for latency — most free slots
        first); fleet order makes the whole thing deterministic."""
        return (1 if health["slo_breached"] else 0,
                health["load"],
                -health["free_slots"],
                self.replicas.index(replica))

    def _place(self, request: Request):
        """The best replica that can take `request` right now, or
        None. Pure function of the replicas' observable health — no
        randomness, so placement (and every drill built on it)
        replays."""
        p_len = len(request.prompt)
        cands = [r for r in self.replicas
                 if r.can_take(p_len, int(request.max_new_tokens))]
        if not cands:
            return None
        best = min(cands, key=lambda r: self._score(r, r.health()))
        tenant = getattr(request, "tenant", None)
        if tenant is not None and self.tenant_affinity_slack is not None:
            home = self._tenant_home.get(tenant)
            if (home is not None and home is not best and home in cands
                    and not home.health()["slo_breached"]
                    and home.load()
                    <= best.load() + self.tenant_affinity_slack):
                self._m_affinity.inc(tenant=tenant)
                return home
        return best

    # -- fleet trace context ----------------------------------------------

    def _hop(self, rid) -> int:
        """The next hop sequence number for `rid` — every placement/
        handoff/hedge/migration/canary event a request crosses gets one,
        so the merged timeline orders hops even when two land inside
        one wall-clock tick."""
        n = self._hop_seq.get(rid, 0) + 1
        self._hop_seq[rid] = n
        return n

    def _trace_context(self, request: Request) -> Request:
        """Stamp the router-assigned trace_id onto `request` — assigned
        once per rid at the fleet door and sticky across re-offers,
        re-placements, and hedges, so every hop event and every
        replica-side span carries ONE identity. A caller-provided (or
        journal-recovered) trace_id is adopted, never replaced."""
        tid = self._trace_ids.get(request.id)
        if tid is None:
            tid = request.trace_id or _next_trace_id()
            self._trace_ids[request.id] = tid
        if request.trace_id != tid:
            request = dataclasses.replace(request, trace_id=tid)
        return request

    def _finalize_trace(self, rid, status) -> None:
        """Close the request's cluster.request root span (hop count as
        the closing attribute) and drop its trace bookkeeping — every
        terminal path (normal finish, shed, failover loss) funnels
        through here so nothing leaks."""
        root = self._root_span.pop(rid, None)
        if root is not None:
            root.close(status=status, hops=self._hop_seq.get(rid, 0))
        self._trace_ids.pop(rid, None)
        self._hop_seq.pop(rid, None)

    def _submit_to(self, replica, request: Request) -> bool:
        rid = request.id
        root = self._root_span.get(rid)
        if root is None:
            root = trace.start_span("cluster.request", rid=rid,
                                    trace_id=request.trace_id)
            self._root_span[rid] = root
        ok = replica.submit(request, parent_span=root.span_id)
        if not ok:
            return False
        self._owner[rid] = replica
        self._requests[rid] = request
        self._submit_t[rid] = self.clock()
        tenant = getattr(request, "tenant", None)
        if tenant is not None:
            # the tenant's home for affinity: last successful placement
            # wins, so a tenant displaced by load rehomes where it
            # actually landed
            self._tenant_home[tenant] = replica
        self._attempts[rid] = self._attempts.get(rid, 0) + 1
        self._results.pop(rid, None)
        self.placements[replica.replica_id] += 1
        self._m_placements.inc(replica=replica.replica_id)
        hop = self._hop(rid)
        trace.point("cluster.place", parent=root.span_id, rid=rid,
                    replica=replica.replica_id,
                    attempt=self._attempts[rid],
                    trace_id=request.trace_id, hop=hop)
        self._log(event="cluster_place", id=rid,
                  replica=replica.replica_id,
                  attempt=self._attempts[rid],
                  trace_id=request.trace_id, hop=hop)
        if (self._rollout is not None
                and replica is self._rollout["canary"]):
            # canary assignment is a hop of its own: the divergence
            # watchdog and the merged timeline both need to know WHICH
            # requests rode the candidate weights
            chop = self._hop(rid)
            trace.point("cluster.canary", parent=root.span_id, rid=rid,
                        replica=replica.replica_id,
                        trace_id=request.trace_id, hop=chop)
            self._log(event="cluster_canary", id=rid,
                      replica=replica.replica_id,
                      trace_id=request.trace_id, hop=chop)
        return True

    def submit(self, request: Request) -> bool:
        """Place `request` on the best replica. False = cluster-wide
        backpressure (every admissible queue full — retry later) or a
        cluster-wide shed (every live replica shedding — a terminal
        ``shed`` Result is recorded, mirroring `LMServer.submit`)."""
        prior = self._results.get(request.id)
        if ((prior is not None and prior.status != "shed")
                or request.id in self._owner
                or request.id in self._hedges):
            # the _hedges check closes the id-namespace door: a caller
            # id colliding with an in-flight hedge copy's would be
            # silently renamed by the first-result-wins mapping
            raise ValueError(f"request id {request.id!r} already used")
        request = self._trace_context(request)
        self._maybe_handoff(request)
        target = self._place(request)
        if target is None:
            live = [r for r in self.replicas
                    if r.state == "live" and r.role != "prefill"]
            if not live:
                # every decode-capable replica is draining or dead:
                # there is NOTHING for a re-offer loop to wait out, so
                # spinning would hang the caller forever. The honest
                # terminal answer is a shed — and because submit()
                # admits ids whose prior result was a shed, the same
                # id may resubmit once add_replica revives the fleet.
                self._results[request.id] = Result(
                    id=request.id, tokens=[], status="shed",
                    finish_reason="shed",
                    error="no live decode-capable replica "
                          "(all draining or dead)",
                    trace_id=request.trace_id)
                self.cluster_sheds += 1
                trace.point("cluster.shed", rid=request.id,
                            trace_id=request.trace_id,
                            reason="no_live_replica")
                self._log(event="cluster_shed", id=request.id,
                          trace_id=request.trace_id,
                          reason="no_live_replica")
                self._finalize_trace(request.id, "shed")
                if self.slo is not None and self.slo.has("error_rate"):
                    self.slo.record("error_rate", ok=False)
                return False
            if live and all(r.server.brownout is not None
                            and r.server.brownout.shedding
                            for r in live):
                # every live replica is shedding: the honest terminal
                # answer, not a queue race to wait out
                self._results[request.id] = Result(
                    id=request.id, tokens=[], status="shed",
                    finish_reason="shed",
                    trace_id=request.trace_id)
                self.cluster_sheds += 1
                trace.point("cluster.shed", rid=request.id,
                            trace_id=request.trace_id,
                            reason="all_shedding")
                self._log(event="cluster_shed", id=request.id,
                          trace_id=request.trace_id,
                          reason="all_shedding")
                self._finalize_trace(request.id, "shed")
                if self.slo is not None and self.slo.has("error_rate"):
                    # a cluster-wide shed IS the fleet failing its
                    # users, even though each replica sheds by design
                    self.slo.record("error_rate", ok=False)
            return False
        return self._submit_to(target, request)

    # -- disaggregated prefill --------------------------------------------

    def _maybe_handoff(self, request: Request) -> None:
        """Route the prompt's chunk-grid prefix through a dedicated
        prefill replica (publishing its boundary snapshot for the
        decode replica to adopt) — unless the registry already covers
        it, in which case the prompt is hot cluster-wide and nobody
        prefills it again."""
        if self.prefix_registry is None:
            return
        if request.id in self._handed_off:
            return                      # a re-offered blocked submit
        pre = [r for r in self.replicas
               if r.role == "prefill" and r.state == "live"]
        if not pre:
            return
        chunk = pre[0].server.engine.prefill_chunk
        p_len = len(request.prompt)
        boundary = (p_len // chunk) * chunk
        if boundary < chunk:
            return                      # nothing on the snapshot grid
        if p_len + 1 > pre[0].server.engine.t_max:
            # a caller error (prompt too long to ever admit) — let the
            # normal submission path raise the honest ValueError; it
            # must not read as a prefill-replica fault below
            return
        cached = self.prefix_registry.covered(request.prompt)
        if cached >= boundary:
            rec = {"rid": request.id, "replica": None,
                   "prefix_tokens": cached, "cached": True}
        else:
            rep = min(pre, key=lambda r: (r.load(),
                                          self.replicas.index(r)))
            try:
                done = rep.prefill_only(request.prompt)
            except Exception as exc:
                # a prefill replica that cannot prefill is dead to the
                # fleet; the request itself just loses the handoff and
                # prefills on its decode replica
                self._fail_replica(rep, exc)
                return
            rec = {"rid": request.id, "replica": rep.replica_id,
                   "prefix_tokens": done, "cached": False}
        self._handed_off.add(request.id)
        self.handoffs.append(rec)
        self._m_handoffs.inc()
        hop = self._hop(request.id)
        trace.point("cluster.handoff", trace_id=request.trace_id,
                    hop=hop, **rec)
        self._log(event="cluster_handoff", id=rec["rid"],
                  replica=rec["replica"],
                  prefix_tokens=rec["prefix_tokens"],
                  cached=rec["cached"],
                  trace_id=request.trace_id, hop=hop)

    # -- the step loop ----------------------------------------------------

    def step(self) -> list[Result]:
        """One cluster tick: place any migration backlog, tick every
        live/draining replica (a step that raises marks the replica
        dead and migrates its journal), collect finished Results, and
        evaluate hedging. Returns the requests that finished."""
        self._place_migrations()
        out: list[Result] = []
        for rep in self.replicas:
            if rep.state == "dead":
                continue
            try:
                finished = rep.step()
            except Exception as exc:
                self._fail_replica(rep, exc)
                continue
            for r in finished:
                out.extend(self._record(rep, r))
        if self._out_of_band:
            # failover-finalized results (adopted terminal answers,
            # journal-less/retry-exhausted losses) join this step's
            # return — drain()'s contract covers every finish
            out.extend(self._out_of_band)
            self._out_of_band = []
        if self.hedge_after_s is not None:
            self._maybe_hedge()
        if self.slo is not None:
            self.slo.evaluate()
        if self.autoscaler is not None:
            self._autoscale()
        if self.watchdog is not None:
            self.watchdog.check()
        return out

    def _record(self, replica, result: Result) -> list[Result]:
        rid = result.id
        orig = self._hedges.get(rid)
        if orig is not None:
            # a hedge copy finished: first result answers under the
            # original id, the second is discarded (its work was the
            # hedge's price)
            del self._hedges[rid]
            self._hedge_target.pop(rid, None)
            if orig in self._results:
                return []
            result = dataclasses.replace(result, id=orig)
            rid = orig
        elif rid in self._results:
            return []                   # hedged original lost the race
        self._results[rid] = result
        self._owner.pop(rid, None)
        self._requests.pop(rid, None)
        self._submit_t.pop(rid, None)
        self._finalize_trace(rid, result.status)
        if self.slo is not None:
            if result.ttft_ms is not None and self.slo.has("ttft"):
                self.slo.observe("ttft", result.ttft_ms / 1e3)
            if self.slo.has("error_rate"):
                self.slo.record("error_rate", ok=result.status == "ok")
        return [result]

    def poll(self, rid: str) -> Result | None:
        return self._results.get(rid)

    def results(self) -> list[Result]:
        return list(self._results.values())

    def idle(self) -> bool:
        return (not self._pending_migration
                and not self._owner
                and all(r.idle() for r in self.replicas
                        if r.state != "dead"))

    def _check_liveness(self, *, submitting: bool = False) -> None:
        """Raise instead of spinning: with no live decode-capable
        replica, a migration backlog (or unsubmitted trace work) can
        never place and stepping makes no progress. Draining replicas
        still FINISH what they hold, so only the work that needs a
        fresh placement trips this."""
        if any(r.state == "live" and r.role != "prefill"
               for r in self.replicas):
            return
        if self._pending_migration or submitting:
            raise RuntimeError(
                "no live decode-capable replica left — the journals "
                "hold the unfinished requests; rebuild the fleet and "
                "migrate them")

    def begin_drain(self) -> None:
        """Stop admitting for good: every live replica drains (its
        scheduler sheds later submits, its brownout jumps to shed) while
        what was accepted steps to its end. The serve-cluster verb's
        SIGTERM path."""
        for rep in self.replicas:
            if rep.state == "live":
                rep.drain()

    def drain(self, *, stop=None) -> list[Result]:
        """Step until every placed request (and migration backlog) has
        finished; returns everything that finished. `stop()`, polled
        between steps, drains every live replica once it returns true
        (`begin_drain`)."""
        out = list(self._out_of_band)
        self._out_of_band = []
        stopping = False
        while not self.idle():
            if not stopping and stop is not None and stop():
                stopping = True
                self.begin_drain()
            self._check_liveness()
            out.extend(self.step())
        return out

    def run(self, trace_reqs, *, realtime: bool = False,
            on_full: str = "block", stop=None) -> list[Result]:
        """Replay `[(arrival_s, Request), ...]` across the fleet and
        drain — `LMServer.run`'s contract at cluster scope. `stop()` is
        polled between router steps: once it returns true nothing more
        of the trace is offered, every live replica drains
        (`begin_drain`) and the fleet steps until what was accepted has
        finished."""
        if on_full not in ("block", "reject"):
            raise ValueError(f"on_full must be 'block' or 'reject', "
                             f"got {on_full!r}")
        trace_reqs = sorted(trace_reqs, key=lambda tr: tr[0])
        t0 = self.clock()
        out, i = [], 0
        stopping = False
        while i < len(trace_reqs) or not self.idle():
            if not stopping and stop is not None and stop():
                stopping = True
                self.begin_drain()
            if stopping:
                if self.idle():
                    break
                self._check_liveness()
                out.extend(self.step())
                continue
            self._check_liveness(submitting=i < len(trace_reqs))
            now = self.clock() - t0
            while i < len(trace_reqs) and (not realtime
                                           or trace_reqs[i][0] <= now):
                req = trace_reqs[i][1]
                if self.submit(req):
                    i += 1
                    continue
                shed = self._results.get(req.id)
                if shed is not None and shed.status == "shed":
                    out.append(shed)
                    i += 1
                elif on_full == "reject":
                    r = Result(id=req.id, tokens=[], status="rejected")
                    self._results[r.id] = r
                    out.append(r)
                    i += 1
                else:
                    break               # blocked: re-offer next tick
            if realtime and self.idle() and i < len(trace_reqs):
                time.sleep(min(max(trace_reqs[i][0]
                                   - (self.clock() - t0), 0.0), 0.005))
                continue
            out.extend(self.step())
        return out

    # -- hedging ----------------------------------------------------------

    def _maybe_hedge(self) -> None:
        now = self.clock()
        for rid, rep in list(self._owner.items()):
            if rid in self._hedged or rid in self._hedges:
                continue                # one hedge per request (and
                #                         never hedge a hedge)
            if now - self._submit_t.get(rid, now) < self.hedge_after_s:
                continue
            if (self.retry is not None
                    and self._attempts.get(rid, 0)
                    > self.retry.max_retries):
                continue
            request = self._requests.get(rid)
            if request is None:
                continue
            p_len = len(request.prompt)
            others = [r for r in self.replicas
                      if r is not rep
                      and r.can_take(p_len,
                                     int(request.max_new_tokens))]
            if not others:
                continue
            hid = f"{rid}#h"
            if (hid in self._owner or hid in self._results
                    or hid in self._requests):
                # a REAL request already owns the hedge id's name —
                # don't hedge rather than collide namespaces
                continue
            target = min(others,
                         key=lambda r: self._score(r, r.health()))
            copy = dataclasses.replace(request, id=hid)
            # the copy decodes under the ORIGINAL's hop context: its
            # serve.request span parents under the same cluster.request
            # root, so the merged tree shows both carriers of one rid
            root = self._root_span.get(rid)
            pspan = root.span_id if root is not None else None
            if not target.submit(copy, parent_span=pspan):
                continue
            self._hedges[copy.id] = rid
            self._hedge_target[copy.id] = target
            self._hedged.add(rid)
            self._attempts[rid] = self._attempts.get(rid, 0) + 1
            self.hedges_sent += 1
            self._m_hedges.inc()
            hop = self._hop(rid)
            trace.point("cluster.hedge", parent=pspan, rid=rid,
                        replica=target.replica_id,
                        trace_id=request.trace_id, hop=hop)
            self._log(event="cluster_hedge", id=rid,
                      replica=target.replica_id,
                      trace_id=request.trace_id, hop=hop)

    # -- elasticity (serve/cluster/autoscaler.py) -------------------------

    def add_replica(self, replica) -> None:
        """Grow the fleet live — the autoscaler's scale-up path, and
        the operator's drain-then-revive move. The replica joins
        placement immediately: the very next submit/step can land on
        it, and a fleet the honest-shed branch declared dead becomes
        placeable again (shed ids may resubmit)."""
        if replica.replica_id in self._by_id:
            raise ValueError(
                f"replica id {replica.replica_id!r} is already in "
                f"the fleet")
        self.replicas.append(replica)
        self._by_id[replica.replica_id] = replica
        self.placements.setdefault(replica.replica_id, 0)
        self._g_live.set(sum(1 for r in self.replicas
                             if r.state == "live"))
        trace.point("cluster.scale_up", replica=replica.replica_id)
        self._log(event="cluster_scale_up",
                  replica=replica.replica_id,
                  live=sum(1 for r in self.replicas
                           if r.state == "live"))

    def _next_auto_id(self) -> str:
        while True:
            rid = f"auto{self._next_replica_ordinal}"
            self._next_replica_ordinal += 1
            if rid not in self._by_id:
                return rid

    def _autoscale(self) -> None:
        """Apply the autoscaler's decision for this tick: ``up`` builds
        a replica through `replica_factory` and adds it; ``down`` drains the
        least-loaded live decode replica with live slot migration, so
        shrinking never drops or re-runs in-flight work."""
        decision = self.autoscaler.evaluate(self.healths(),
                                            now=self.clock())
        if decision is None:
            return
        action = decision["action"]
        if action == "up":
            rep = self.replica_factory(self._next_auto_id())
            self.add_replica(rep)
            self._m_scale.inc(action="up")
        elif action == "down":
            live = [r for r in self.replicas
                    if r.state == "live" and r.role != "prefill"]
            if len(live) <= 1:
                return                  # never drain the last one
            victim = min(live, key=lambda r: (r.load(),
                                              self.replicas.index(r)))
            self._m_scale.inc(action="down")
            self.drain_replica(victim.replica_id, migrate=True)

    # -- drain / failover -------------------------------------------------

    def drain_replica(self, replica_id: str, *, wait: bool = False,
                      migrate: bool = False) -> list[str]:
        """Graceful drain: placement stops immediately (the scheduler
        enters its sticky drain mode and sheds stragglers; the
        brownout, when armed, jumps to shed). With ``migrate=True``
        the replica's unfinished work leaves with it — queued entries
        re-enter the NORMAL placement path and RUNNING slots move
        LIVE: mid-decode KV, position, rng chain, and budget exported
        and imported into a peer's free slot, decode continuing there
        bit-identically (the elastic scale-down path). With
        `wait=True` the fleet steps until the replica is idle.
        Returns the ids whose work moved."""
        rep = self._by_id[replica_id]
        rep.drain()
        trace.point("cluster.drain", replica=replica_id)
        self._log(event="cluster_drain", replica=replica_id)
        moved = self._migrate_out(rep) if migrate else []
        while wait and not rep.idle():
            self.step()
        return moved

    def _migrate_out(self, rep) -> list[str]:
        """Empty a draining replica onto the fleet. Queued (and still-
        prefilling / retry-parked) entries are re-placed through
        `_place_migrations` — original id, seed, relative deadline
        preserved, the request re-runs from the prompt. Running slots
        migrate live instead: `Scheduler.export_running` lifts the
        slot's KV + sampling state, a compatible peer's
        `import_running` seats it, and decode resumes mid-request with
        bit-identical output (the engine's serial-parity contract).

        Journal protocol across the export→import gap: the SOURCE
        journal's submit stays open until the peer's import (which
        journals a normal submit on the TARGET) has landed; only then
        does the source write ``journal_migrate`` + the terminal
        ``"migrated"`` finish. A crash anywhere inside the gap
        therefore leaves the request pending in exactly one WAL — the
        source's — and the normal failover replay re-runs it from the
        prompt, bit-identically."""
        sch = rep.server.scheduler
        moved: list[str] = []
        # 1. work that never reached a slot re-enters normal placement
        for entry in sch.drain_pending():
            rid = entry.rid
            orig = self._hedges.pop(rid, None)
            if orig is not None:
                # a queued hedge copy: the original still runs on its
                # own replica — drop the copy (and close its WAL entry
                # so a later kill of THIS replica cannot resurrect it)
                self._hedge_target.pop(rid, None)
                self._hedged.discard(orig)
                if sch.journal is not None:
                    sch.journal.record_finish(rid, "shed",
                                              reason="drain")
                continue
            req = self._requests.get(rid)
            if req is None:
                # never placed by this router (a direct replica
                # submit): rebuild the Request from the entry so the
                # drain still honors it
                req = _entry_request(entry)
            self._owner.pop(rid, None)
            self._results.pop(rid, None)
            self._pending_migration.append(req)
            self._migrating_from[rid] = rep
            self._migration_src[rid] = rep.replica_id
            moved.append(rid)
        # 2. running slots move live. quiesce() first: it collects the
        # in-flight decode window without dispatching another, which is
        # the dispatch-idle point export_slot requires — and any
        # request that window finished is adopted, not migrated.
        running = list(sch.running_ids())
        if running and rep.server.engine.supports_slot_migration:
            for r in rep.server.quiesce():
                self._out_of_band.extend(self._record(rep, r))
            for rid in list(sch.running_ids()):
                target = self._slot_target(rep, rid)
                if target is not None:
                    # the peer may hold its own in-flight dispatched
                    # window — collect it (import needs the engine
                    # dispatch-idle, same as export does)
                    for r in target.server.quiesce():
                        self._out_of_band.extend(
                            self._record(target, r))
                entry, snap = sch.export_running(rid)
                seated = (target is not None
                          and target.server.scheduler.import_running(
                              entry, snap))
                if not seated:
                    # no compatible peer with a free slot right now:
                    # fall back to a from-the-prompt re-placement (the
                    # source submit is still open, so the journal
                    # contract already covers this path)
                    req = self._requests.get(rid)
                    if req is None:
                        req = _entry_request(entry)
                    self._owner.pop(rid, None)
                    self._results.pop(rid, None)
                    self._pending_migration.append(req)
                    self._migrating_from[rid] = rep
                    self._migration_src[rid] = rep.replica_id
                    moved.append(rid)
                    continue
                self._owner[rid] = target
                # the import landed: close the gap on the source WAL
                if sch.journal is not None:
                    sch.journal.record_migrate(
                        rid, "out", peer=target.replica_id)
                    sch.journal.record_finish(rid, "migrated")
                tj = target.server.scheduler.journal
                if tj is not None:
                    tj.record_migrate(rid, "in", peer=rep.replica_id)
                self.slot_migrations.append(
                    {"rid": rid, "from": rep.replica_id,
                     "to": target.replica_id})
                self._m_slot_migrations.inc()
                tid = self._trace_ids.get(rid)
                hop = self._hop(rid)
                root = self._root_span.get(rid)
                trace.point("cluster.slot_migrate",
                            parent=(root.span_id if root is not None
                                    else None),
                            rid=rid, src=rep.replica_id,
                            dst=target.replica_id,
                            trace_id=tid, hop=hop)
                self._log(event="cluster_slot_migrate", id=rid,
                          src=rep.replica_id,
                          dst=target.replica_id,
                          trace_id=tid, hop=hop)
                moved.append(rid)
        self._place_migrations()
        return moved

    def _slot_target(self, rep, rid) -> object | None:
        """The peer a running slot can move into: live, decode-
        capable, migration-capable, geometry-identical (head/block
        layout and cache dtype — import_slot re-validates), not
        draining, t_max at least the source's, and holding a free
        slot. Least-loaded first, fleet order breaking ties — the same
        determinism contract as placement."""
        e1 = rep.server.engine
        cands = []
        for r in self.replicas:
            if r is rep or r.state != "live" or r.role == "prefill":
                continue
            e2 = r.server.engine
            if (not e2.supports_slot_migration
                    or r.server.scheduler.draining
                    or not e2.free_slots()
                    or e2.t_max < e1.t_max
                    or e2._cfg.embed_dim != e1._cfg.embed_dim
                    or e2._cfg.num_heads != e1._cfg.num_heads
                    or e2._cfg.num_blocks != e1._cfg.num_blocks
                    or e2._cfg.cache_dtype != e1._cfg.cache_dtype):
                continue
            cands.append(r)
        if not cands:
            return None
        return min(cands, key=lambda r: (r.load(),
                                         self.replicas.index(r)))

    def kill_replica(self, replica_id: str) -> list[str]:
        """The failover drill: hard-kill a replica (its journal WAL is
        all that survives) and migrate its accepted-but-unfinished
        requests onto the survivors. Returns the migrated ids."""
        rep = self._by_id[replica_id]
        return self._fail_replica(
            rep, RuntimeError("killed by operator drill"))

    def _fail_replica(self, replica, exc) -> list[str]:
        """THE cluster recovery entry point (the serve/ exception-
        discipline scan recognizes it next to the scheduler's
        `_quarantine`/`_abort_running`): mark the replica dead, adopt
        any terminal Results its final tick salvaged, and queue its
        journal's pending requests for migration onto survivors."""
        already_dead = replica.state == "dead"
        replica.kill()
        # a dead home cannot serve affinity: drop its tenants so their
        # next placement rehomes on a survivor
        self._tenant_home = {t: r for t, r in self._tenant_home.items()
                             if r is not replica}
        if not already_dead:
            self._m_deaths.inc()
            self._g_live.set(sum(1 for r in self.replicas
                                 if r.state == "live"))
            trace.point("cluster.replica_dead",
                        replica=replica.replica_id,
                        error=f"{type(exc).__name__}: {exc}")
            self._log(event="cluster_replica_dead",
                      replica=replica.replica_id,
                      error=f"{type(exc).__name__}: {exc}")
        # hedge copies RUNNING ON the dying replica die with it: drop
        # their mappings so (a) the original — when still live on its
        # own replica — is no longer considered hedged and may
        # re-hedge, and (b) the journal replay below cannot resurrect
        # the copy. An original BOTH of whose carriers are now gone
        # (its own replica died journal-less earlier) is an honest
        # loss, recorded here.
        dead_copies = set()
        for hid, tgt in list(self._hedge_target.items()):
            if tgt is not replica:
                continue
            dead_copies.add(hid)
            del self._hedge_target[hid]
            orig = self._hedges.pop(hid, None)
            if orig is None:
                continue
            self._hedged.discard(orig)
            if orig not in self._owner and orig not in self._results:
                lost = Result(
                    id=orig, tokens=[], status="error",
                    finish_reason="error",
                    error=f"replica {replica.replica_id} died holding "
                          f"the hedge copy of an already-lost request",
                    trace_id=self._trace_ids.get(orig))
                self._results[orig] = lost
                self._out_of_band.append(lost)
                self._finalize_trace(orig, "error")
        # terminal results the dying tick already finalized (an
        # engine-failure tick salvages completed entries with their
        # true statuses — api.step's pop_failed path) are real answers;
        # adopt them instead of re-running finished work
        for rid, owner in list(self._owner.items()):
            if owner is not replica:
                continue
            r = replica.poll(rid)
            if r is not None and r.status != "error":
                self._out_of_band.extend(self._record(replica, r))
        migrated: list[str] = []
        if replica.journal_path is not None:
            for req in pending_requests(replica.journal_path):
                if req.id in dead_copies:
                    continue            # a hedge copy handled above
                if self._owner.get(req.id) not in (None, replica):
                    # a live mid-decode migration moved this slot onto
                    # a survivor before the death closed the source
                    # WAL: the open submit is stale — the survivor is
                    # decoding it right now, and replaying here would
                    # answer the id twice
                    continue
                if any(p.id == req.id
                       for p in self._pending_migration):
                    continue            # a drain already queued it
                orig = self._hedges.get(req.id, req.id)
                if orig in self._results:
                    continue            # already answered (hedge won,
                    #                     or adopted above)
                if req.id in self._hedges:
                    # a dead hedge copy: the original is still running
                    # on its own replica — don't resurrect the copy
                    del self._hedges[req.id]
                    self._hedge_target.pop(req.id, None)
                    self._hedged.discard(orig)
                    continue
                if req.id in self._hedges.values():
                    # the original died but its hedge copy is still
                    # running elsewhere: the copy IS the in-flight
                    # recovery — let it answer instead of migrating a
                    # duplicate
                    self._owner.pop(req.id, None)
                    continue
                if (self.retry is not None
                        and self._attempts.get(req.id, 0)
                        > self.retry.max_retries):
                    lost = Result(
                        id=req.id, tokens=[], status="error",
                        finish_reason="error",
                        error=f"replica {replica.replica_id} died and "
                              f"the retry budget is exhausted",
                        trace_id=req.trace_id)
                    self._results[req.id] = lost
                    self._out_of_band.append(lost)
                    self._owner.pop(req.id, None)
                    self._finalize_trace(req.id, "error")
                    continue
                self._owner.pop(req.id, None)
                self._results.pop(req.id, None)
                self._pending_migration.append(req)
                self._migration_src[req.id] = replica.replica_id
                migrated.append(req.id)
        else:
            # no WAL: the in-flight requests are honestly lost —
            # except ones whose hedge copy still runs elsewhere (the
            # copy answers under the original id when it finishes)
            for rid, owner in list(self._owner.items()):
                if owner is not replica:
                    continue
                self._owner.pop(rid, None)
                if rid in self._hedges.values():
                    continue
                lost = Result(
                    id=rid, tokens=[], status="error",
                    finish_reason="error",
                    error=f"replica {replica.replica_id} died "
                          f"without a journal",
                    trace_id=self._trace_ids.get(rid))
                self._results[rid] = lost
                self._out_of_band.append(lost)
                self._finalize_trace(rid, "error")
        self._place_migrations()
        return migrated

    def _place_migrations(self) -> None:
        """Offer the migration backlog to survivors, original submit
        order preserved; a backlog head the fleet cannot take yet
        blocks the rest (FIFO — recovered requests must not reorder
        behind each other)."""
        while self._pending_migration:
            req = self._pending_migration[0]
            # a journal-recovered (or direct-submitted) request may not
            # have crossed submit(): adopt its WAL trace_id into the
            # router's context — failover must keep the original
            # identity, never mint a new one
            req = self._trace_context(req)
            target = self._place(req)
            if target is None or not self._submit_to(target, req):
                return
            self._pending_migration.pop(0)
            src = self._migrating_from.pop(req.id, None)
            if src is not None:
                # the re-placement landed and the TARGET journaled its
                # own submit — only now does the still-open source WAL
                # close with the terminal migrated finish (a crash any
                # earlier replays the request from the source)
                sj = src.server.scheduler.journal
                if sj is not None and src.state != "dead":
                    sj.record_migrate(req.id, "out",
                                      peer=target.replica_id)
                    sj.record_finish(req.id, "migrated")
            self.migrations.append({"rid": req.id,
                                    "replica": target.replica_id,
                                    "trace_id": req.trace_id})
            self._m_migrations.inc()
            src_id = self._migration_src.pop(req.id, None)
            hop = self._hop(req.id)
            root = self._root_span.get(req.id)
            trace.point("cluster.migrate",
                        parent=(root.span_id if root is not None
                                else None),
                        rid=req.id, replica=target.replica_id,
                        src=src_id, trace_id=req.trace_id, hop=hop)
            self._log(event="cluster_migrate", id=req.id,
                      replica=target.replica_id, src=src_id,
                      trace_id=req.trace_id, hop=hop)

    # -- weight rollout (checkpoint/rollout.py at fleet scope) ------------

    def start_rollout(self, candidate, *, replica_id=None) -> str:
        """Open a fleet rollout: ONE replica becomes the canary. The
        candidate (a params tree, or a sharded-checkpoint directory —
        checkpoint/sharded.py — restored whole: a replica is one device
        under no partition rules) is spot-checked through the canary's
        own prefill first; a NaN/garbage candidate raises here and the
        fleet is untouched. On success the canary's live weights are
        kept as a host tree (the swap copies in place, so a rollback
        needs them) and the candidate is swapped in place (its in-flight
        slots keep decoding) while the
        rest of the fleet keeps the old weights — normal placement
        keeps routing live traffic onto the canary, which is the
        controlled-exposure mechanism at cluster scope. Returns the
        canary's replica_id; `finish_rollout` reads the health
        documents and promotes the rest or swaps the canary back."""
        if self._rollout is not None:
            raise RuntimeError(
                f"a rollout is already open (canary "
                f"{self._rollout['canary'].replica_id!r}) — "
                f"finish_rollout() it before starting another")
        cands = [r for r in self.replicas
                 if r.state == "live" and r.role != "prefill"]
        if replica_id is not None:
            rep = self._by_id[replica_id]
            if rep.state != "live" or rep.role == "prefill":
                raise ValueError(
                    f"replica {replica_id!r} is "
                    f"{rep.state}/{rep.role} — the canary must be a "
                    f"live decode-capable replica")
        elif not cands:
            raise RuntimeError("no live decode-capable replica to "
                               "canary on")
        else:
            # least-loaded live replica: the cheapest place to expose
            # candidate weights, deterministic via the placement score
            rep = min(cands, key=lambda r: self._score(r, r.health()))
        if isinstance(candidate, (str, os.PathLike)):
            from idc_models_tpu_torch.checkpoint.sharded import (
                restore_sharded,
            )

            candidate = restore_sharded(candidate, mesh=None, rules=None,
                                        logger=self.logger)
        rep.server.metrics.on_rollout(stage="staging")
        if rep.server.engine.paged and rep.server.engine._pending is not None:
            # the paged spot-check runs a chunk through the pool the
            # window in flight is writing: collect that window first
            for r in rep.server.quiesce():
                self._out_of_band.extend(self._record(rep, r))
        check = rep.server.engine.spot_check_params(candidate)
        if not check["ok"]:
            detail = {1: "non-finite logits",
                      2: f"magnitude-blown logits (max |x| = "
                         f"{check['max_abs']:.3g})"}
            rep.server.metrics.on_rollout(
                stage="rolled_back", outcome="rolled_back",
                reason=f"spot-check: {detail[check['code']]}")
            raise ValueError(
                f"candidate failed the spot-check on canary "
                f"{rep.replica_id!r}: {detail[check['code']]} — the "
                f"fleet was not touched")
        from idc_models_tpu_torch import convert

        old = convert.to_jax(rep.server.engine._model)[0]
        rep.server.swap_params(candidate)
        self._rollout = {"canary": rep, "candidate": candidate,
                         "old": old,
                         "baseline": {r.replica_id: r.health()
                                      for r in self.replicas
                                      if r is not rep
                                      and r.state == "live"}}
        rep.server.metrics.on_rollout(stage="canary")
        trace.point("cluster.rollout_canary", replica=rep.replica_id)
        self._log(event="cluster_rollout", stage="canary",
                  replica=rep.replica_id)
        return rep.replica_id

    def finish_rollout(self) -> str:
        """Decide the open rollout from the HEALTH DOCUMENTS: the
        canary must not be SLO-breached, brownout-shedding, or dead
        while the rest of the fleet is clean. Healthy -> promote: every
        other live replica's weights are swapped in place (in-flight
        work keeps decoding; the eager engines build nothing new).
        Unhealthy -> the canary swaps BACK to the old weights; nothing
        else ever saw the candidate. Returns
        "promoted" or "rolled_back"."""
        ro = self._rollout
        if ro is None:
            raise RuntimeError("no rollout open — start_rollout() "
                               "first")
        rep = ro["canary"]
        h = rep.health() if rep.state != "dead" else {"status": "dead"}
        fleet_breached = any(b["slo_breached"]
                             for b in ro["baseline"].values())
        reasons = []
        if rep.state != "live":
            reasons.append(f"canary is {rep.state}")
        else:
            if h["slo_breached"] and not fleet_breached:
                reasons.append("canary SLO breached while the fleet "
                               "is clean")
            if h["shedding"]:
                reasons.append(f"canary shedding (brownout stage "
                               f"{h['brownout_stage']})")
        if reasons:
            if rep.state == "live":
                rep.server.swap_params(ro["old"])
            reason = "; ".join(reasons)
            rep.server.metrics.on_rollout(
                stage="rolled_back", outcome="rolled_back",
                reason=reason)
            verdict = "rolled_back"
        else:
            for other in self.replicas:
                if other is rep or other.state != "live":
                    continue
                other.server.swap_params(ro["candidate"])
            rep.server.metrics.on_rollout(stage="promoted",
                                          outcome="promoted")
            reason = None
            verdict = "promoted"
        trace.point("cluster.rollout_done", replica=rep.replica_id,
                    outcome=verdict)
        self._log(event="cluster_rollout", stage=verdict,
                  replica=rep.replica_id, reason=reason)
        self._rollout = None
        return verdict

    # -- lifecycle / observability ----------------------------------------

    @property
    def rollout_canary(self):
        """The open rollout's canary replica, or None — the read the
        canary-divergence watchdog (and an operator poll) uses without
        reaching into the rollout dict."""
        return (None if self._rollout is None
                else self._rollout["canary"])

    def close(self) -> None:
        """Shut every replica down (journals flushed); the router's
        surface then refuses new work through the replicas' own closed
        schedulers."""
        for rep in self.replicas:
            if rep.state != "dead":
                rep.server.close()

    def healths(self) -> list[dict]:
        """Every replica's placement-signal document — the fleet view
        an operator (or test) reads in one call."""
        return [r.health() for r in self.replicas]

    def summary(self) -> dict:
        """The cluster rollup: pooled per-request aggregates over
        every replica (serve/metrics.aggregate_summaries), the
        router's own counters, and the prefix registry's — the record
        the CLI epilogue reports."""
        out = aggregate_summaries([r.server.metrics
                                   for r in self.replicas])
        # replica-level sheds (a straggling direct submit refused by a
        # draining replica's brownout) plus the router-level
        # cluster-wide ones — either way the caller got status="shed"
        out["cluster_shed"] += self.cluster_sheds
        out.update({
            "cluster_replicas_live": sum(1 for r in self.replicas
                                         if r.state == "live"),
            "cluster_replicas_draining": sum(
                1 for r in self.replicas if r.state == "draining"),
            "cluster_replicas_dead": sum(1 for r in self.replicas
                                         if r.state == "dead"),
            "cluster_placements": dict(self.placements),
            "cluster_migrations": len(self.migrations),
            "cluster_slot_migrations": len(self.slot_migrations),
            "cluster_handoffs": len(self.handoffs),
            "cluster_hedges": self.hedges_sent,
        })
        if self.prefix_registry is not None:
            out.update(self.prefix_registry.summary())
        return out

    def _log(self, **record) -> None:
        if self.logger is not None:
            self.logger.log(**record)
