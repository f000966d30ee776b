"""Fleet-level observability: one merged /metrics, one fleet /healthz,
and the anomaly watchdogs -- the counterpart of
``idc_models_tpu/serve/cluster/telemetry.py``.

Every replica already owns an honest per-replica `MetricsRegistry`
(build_replica) and health document (`Replica.health`), and the router
keeps its own registry of cluster_* series. What was missing is the
operator's single pane:

- `ClusterTelemetry.merged_registry()` folds every replica registry
  into ONE fresh registry per scrape — each per-replica series gains a
  ``replica`` label (histograms merge state-wise, no re-observation) —
  then derives the fleet rollups FROM the just-merged series:
  ``cluster_fleet_queue_depth``, ``cluster_fleet_kv_pages_used`` /
  ``_total``, and per-tenant fleet totals. Because the rollups are
  sums over the very series the same exposition carries, "fleet rollup
  == sum of per-replica series" holds by construction at every
  instant.
- `ClusterTelemetry.health()` is the fleet /healthz: every replica's
  health document embedded verbatim, plus fleet aggregates, the
  cluster SLO engine's state, the autoscaler's live hysteresis clocks
  (`Autoscaler.state_doc`), and a shared compile cache's hit/miss
  counters when one is given (``serve/compile_cache.py``). The
  NON-cluster /healthz document is untouched —
  `observe.MetricsExporter` only serves this shape when armed with a
  ClusterTelemetry.
- `ClusterWatchdog` runs four windowed detectors over the live fleet
  objects and emits a frozen-schema ``cluster_anomaly`` jsonl record
  (plus a ``cluster_anomalies_total{kind}`` counter) on each
  TRANSITION into the anomalous state — hysteresis like `SLOEngine`,
  so a persistent fault fires once, not once per tick, and a clean
  run stays silent.

Watchdog detectors (all windowed over `WatchdogConfig.window_s`):

``accept_collapse``     fleet speculative accept rate over the window
                        fell below ``accept_rate_floor`` (only judged
                        once ``accept_min_drafted`` tokens were
                        drafted in the window — a cold drafter is not
                        a collapsed one).
``compile_churn``       one replica observed more than
                        ``compile_churn_limit`` fresh compiles in the
                        window (`ServingMetrics.compiles_observed`,
                        which stays 0 on the eager port: it compiles
                        no serving program).
``migration_spike``     more than ``migration_spike_limit`` journal +
                        live-slot migrations fleet-wide in the window
                        — replicas are dying or draining faster than
                        steady state.
``canary_divergence``   the rollout canary's own SLO engine is
                        breached while NO baseline decode replica's
                        is — the new weights themselves are the
                        regression, so the operator should roll back
                        rather than scale out.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

from idc_models_tpu_torch.observe.metrics_registry import (
    MetricsRegistry,
)


class ClusterTelemetry:
    """The fleet aggregation surface over one `Router`: merged
    replica-labeled metrics with derived rollups, and the fleet
    health document. Stateless per scrape — every call reads the live
    fleet, so a replica added or killed between scrapes just appears
    or disappears."""

    def __init__(self, router, *, compile_cache=None):
        self.router = router
        # the fleet's shared persistent compile cache, when spin-up
        # uses one: its hit/miss counters belong on the fleet health
        # document (absent when None)
        self.compile_cache = compile_cache

    # -- merged metrics ---------------------------------------------------

    def merged_registry(self) -> MetricsRegistry:
        """One fresh registry holding: the router's own cluster_*
        series verbatim, every replica registry's series re-labeled
        with ``replica=<id>``, and the fleet rollup series derived
        from the merged copies."""
        out = MetricsRegistry()
        router_reg = getattr(self.router, "registry", None)
        if router_reg is not None:
            for inst in router_reg.instruments():
                self._copy(out, inst, None)
        for rep in self.router.replicas:
            reg = getattr(rep, "registry", None)
            if reg is None or reg is router_reg:
                # a replica sharing the router's (or the process)
                # registry has no per-replica series to re-label —
                # the verbatim copy above already carries it
                continue
            for inst in reg.instruments():
                self._copy(out, inst, rep.replica_id)
        self._rollups(out)
        return out

    @staticmethod
    def _copy(out: MetricsRegistry, inst, replica_id) -> None:
        extra = {} if replica_id is None else {"replica": replica_id}
        if "replica" in inst.label_names and extra:
            # already replica-labeled at the source — re-labeling
            # would double-report; copy verbatim instead
            extra = {}
        names = inst.label_names + tuple(extra)
        existing = out.get(inst.name)
        if existing is not None and (
                existing.kind != inst.kind
                or existing.label_names != names):
            # same metric name registered with an incompatible shape
            # (e.g. the router's shared-registry copy of a serve_*
            # gauge vs. a replica's) — the first writer wins; merging
            # two label schemas into one series would lie
            return
        if inst.kind == "counter":
            m = out.counter(inst.name, inst.help, labels=names)
            for labels, val in inst._series():
                if val:
                    m.inc(val, **labels, **extra)
                else:
                    m.inc(0.0, **labels, **extra)
        elif inst.kind == "gauge":
            m = out.gauge(inst.name, inst.help, labels=names)
            for labels, val in inst._series():
                m.set(val, **labels, **extra)
        elif inst.kind == "histogram":
            m = out.histogram(inst.name, inst.help, labels=names,
                              buckets=inst.buckets)
            for labels, val in inst._series():
                m.merge_state(val, **labels, **extra)

    @staticmethod
    def _rollups(out: MetricsRegistry) -> None:
        """Derive the fleet series from the merged replica-labeled
        copies — summing the exposition's own series, not the live
        objects, is what makes "rollup == sum of scrapes" exact."""

        def fleet_sum(name):
            inst = out.get(name)
            if inst is None:
                return None
            vals = [v for labels, v in inst._series()
                    if labels.get("replica")]
            return sum(vals) if vals else None

        q = fleet_sum("serve_queue_depth")
        if q is not None:
            out.gauge(
                "cluster_fleet_queue_depth",
                "sum of every replica's admission queue depth "
                "(rollup of serve_queue_depth{replica=...})").set(q)
        for src, dst in (("serve_kv_pages_used",
                          "cluster_fleet_kv_pages_used"),
                         ("serve_kv_pages_total",
                          "cluster_fleet_kv_pages_total")):
            v = fleet_sum(src)
            if v is not None:
                out.gauge(dst, f"fleet rollup of {src} across "
                               f"replicas").set(v)
        for src, dst in (("serve_tenant_requests_total",
                          "cluster_fleet_tenant_requests_total"),
                         ("serve_tenant_tokens_emitted_total",
                          "cluster_fleet_tenant_tokens_total")):
            inst = out.get(src)
            if inst is None:
                continue
            sums: dict[str, float] = {}
            for labels, v in inst._series():
                t = labels.get("tenant")
                if t is not None:
                    sums[t] = sums.get(t, 0.0) + v
            if sums:
                c = out.counter(
                    dst, f"per-tenant fleet total (rollup of {src} "
                         f"across replicas and statuses)",
                    labels=("tenant",))
                for t, v in sums.items():
                    c.inc(v, tenant=t)

    def prometheus_text(self) -> str:
        return self.merged_registry().prometheus_text()

    # -- fleet health -----------------------------------------------------

    def health(self) -> dict:
        """The fleet /healthz document: per-replica health docs
        embedded verbatim under ``replicas``, fleet aggregates under
        ``fleet``, plus the cluster SLO engine state, the autoscaler's
        live hysteresis clocks, and the shared compile cache's
        hit/miss counters when each is armed."""
        r = self.router
        reps = {rep.replica_id: rep.health() for rep in r.replicas}
        live = [h for h in reps.values() if h["state"] == "live"]
        fleet = {
            "replicas_live": len(live),
            "replicas_draining": sum(
                1 for h in reps.values() if h["state"] == "draining"),
            "replicas_dead": sum(
                1 for h in reps.values() if h["state"] == "dead"),
            "queue_depth": sum(h["queue_depth"] for h in live),
            "load": sum(h["load"] for h in live),
            "kv_pages_used": sum(
                h["kv_pages_used"] or 0 for h in live),
            "kv_pages_total": sum(
                h["kv_pages_total"] or 0 for h in live),
        }
        slo_breached = bool(r.slo is not None and r.slo.breached())
        status = ("ok" if live and not fleet["replicas_dead"]
                  and not slo_breached else "degraded")
        doc = {"status": status, "replicas": reps, "fleet": fleet}
        if r.slo is not None:
            doc["slo"] = r.slo.state_doc()
        if r.autoscaler is not None:
            doc["autoscaler"] = r.autoscaler.state_doc()
        if self.compile_cache is not None:
            cs = self.compile_cache.summary()
            doc["compile_cache"] = {
                "hits": cs["hits"], "misses": cs["misses"],
                "stores": cs["stores"]}
        return doc


@dataclasses.dataclass(frozen=True)
class WatchdogConfig:
    """The anomaly detectors' knobs, validated at construction."""

    window_s: float = 5.0
    accept_rate_floor: float = 0.2
    accept_min_drafted: int = 64
    compile_churn_limit: int = 3
    migration_spike_limit: int = 4

    def __post_init__(self):
        if self.window_s <= 0:
            raise ValueError(f"need window_s > 0, got {self.window_s}")
        if not 0 <= self.accept_rate_floor <= 1:
            raise ValueError(f"need 0 <= accept_rate_floor <= 1, got "
                             f"{self.accept_rate_floor}")
        if self.accept_min_drafted < 1:
            raise ValueError(f"need accept_min_drafted >= 1, got "
                             f"{self.accept_min_drafted}")
        if self.compile_churn_limit < 0 or self.migration_spike_limit < 0:
            raise ValueError(
                f"limits must be >= 0, got compile_churn_limit="
                f"{self.compile_churn_limit} migration_spike_limit="
                f"{self.migration_spike_limit}")


class ClusterWatchdog:
    """Windowed anomaly detectors over the live fleet. Drive `check()`
    once per router step (or health poll); each detector samples a
    CUMULATIVE reading into its window and judges the windowed delta,
    then fires only on the transition into the anomalous state.

    A firing appends one frozen-schema record — ``{ts, event:
    "cluster_anomaly", kind, replica, value, threshold, window_s}``
    (``replica`` null for fleet-wide kinds) — to the logger, bumps
    ``cluster_anomalies_total{kind}``, and records it in
    `self.anomalies`. `check()` returns the records fired by THAT
    call, so a test can assert fire-on-fault / silent-on-clean
    directly."""

    KINDS = ("accept_collapse", "compile_churn", "migration_spike",
             "canary_divergence")

    def __init__(self, router, cfg: WatchdogConfig | None = None, *,
                 logger=None, registry=None, clock=time.monotonic):
        self.router = router
        self.cfg = cfg if cfg is not None else WatchdogConfig()
        self.logger = logger
        self.clock = clock
        reg = (registry if registry is not None
               else getattr(router, "registry", None))
        self._m_anomalies = (
            None if reg is None else reg.counter(
                "cluster_anomalies_total",
                "anomaly watchdog firings by kind",
                labels=("kind",)))
        self.anomalies: list[dict] = []
        # (kind-scope key) -> deque of (t, cumulative value)
        self._samples: dict[tuple, deque] = {}
        self._alerting: dict[tuple, bool] = {}

    def _windowed(self, key: tuple, now: float, value: float) -> float:
        """Append one cumulative reading and return the delta over the
        trailing window (value minus the oldest retained reading)."""
        q = self._samples.setdefault(key, deque())
        q.append((now, value))
        cutoff = now - self.cfg.window_s
        while len(q) > 1 and q[0][0] < cutoff:
            q.popleft()
        return value - q[0][1]

    def _judge(self, fired: list, *, kind: str, replica, anomalous: bool,
               value: float, threshold: float) -> None:
        key = (kind, replica)
        if not anomalous:
            self._alerting[key] = False
            return
        if self._alerting.get(key):
            return
        self._alerting[key] = True
        rec = {"kind": kind, "replica": replica,
               "value": round(float(value), 4),
               "threshold": float(threshold),
               "window_s": self.cfg.window_s}
        self.anomalies.append(rec)
        fired.append(rec)
        if self._m_anomalies is not None:
            self._m_anomalies.inc(kind=kind)
        if self.logger is not None:
            self.logger.log(event="cluster_anomaly", **rec)

    def check(self, now: float | None = None) -> list[dict]:
        """One detector pass; returns the anomaly records fired by
        this call (empty on a healthy fleet)."""
        now = self.clock() if now is None else now
        cfg = self.cfg
        r = self.router
        fired: list[dict] = []
        live = [rep for rep in r.replicas if rep.state != "dead"]

        # 1. fleet speculative accept-rate collapse
        drafted = sum(rep.server.metrics.spec_drafted for rep in live)
        accepted = sum(rep.server.metrics.spec_accepted for rep in live)
        d_drafted = self._windowed(("drafted", None), now, drafted)
        d_accepted = self._windowed(("accepted", None), now, accepted)
        if d_drafted >= cfg.accept_min_drafted:
            rate = d_accepted / d_drafted
            self._judge(fired, kind="accept_collapse", replica=None,
                        anomalous=rate < cfg.accept_rate_floor,
                        value=rate, threshold=cfg.accept_rate_floor)
        # too little drafting in the window to judge: hold state — a
        # quiet drafter neither fires nor clears a standing alert

        # 2. per-replica compile churn
        for rep in live:
            d = self._windowed(("compiles", rep.replica_id), now,
                               rep.server.metrics.compiles_observed)
            self._judge(fired, kind="compile_churn",
                        replica=rep.replica_id,
                        anomalous=d > cfg.compile_churn_limit,
                        value=d, threshold=cfg.compile_churn_limit)

        # 3. fleet migration-rate spike (journal failover + live slot)
        migs = len(r.migrations) + len(r.slot_migrations)
        d = self._windowed(("migrations", None), now, migs)
        self._judge(fired, kind="migration_spike", replica=None,
                    anomalous=d > cfg.migration_spike_limit,
                    value=d, threshold=cfg.migration_spike_limit)

        # 4. canary-vs-baseline SLO divergence
        canary = getattr(r, "rollout_canary", None)
        if canary is not None and canary.state == "live":
            ch = canary.health()
            baseline_breached = any(
                rep.health()["slo_breached"] for rep in r.replicas
                if rep is not canary and rep.state == "live"
                and rep.role != "prefill")
            self._judge(
                fired, kind="canary_divergence",
                replica=canary.replica_id,
                anomalous=bool(ch["slo_breached"]
                               and not baseline_breached),
                value=1.0 if ch["slo_breached"] else 0.0,
                threshold=1.0)
        else:
            # rollout closed (or no canary): clear any standing canary
            # alert so the NEXT rollout's divergence fires fresh
            for key in list(self._alerting):
                if key[0] == "canary_divergence":
                    self._alerting[key] = False
        return fired
