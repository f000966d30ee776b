"""The port's fleet observability (idc_models_tpu_torch/serve/cluster/
telemetry.py: `ClusterTelemetry`, `ClusterWatchdog`; the router's hop
events; `MetricsExporter(cluster=)`) on the CPU, against the JAX
package's on the same weights, requests and fake clocks.

The oracle is the JAX package's tests/test_fleet_observability.py: an
autoscaled 1 -> 2 -> 1 run with a live slot migration renders one merged
timeline under one trace id; the merged exposition carries every
replica's series under a ``replica`` label and its rollups equal the
per-replica sums; the fleet /healthz embeds every replica's document;
the pooled SLO sees a skew no replica sees; each watchdog fires once on
its fault and stays silent when clean. Where the host logic is shared,
the records, metric families, document keys and anomalies are held
equal to JAX's."""

from __future__ import annotations

import functools
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idc_models_tpu import serve as jserve
from idc_models_tpu.models import lm as jlm
from idc_models_tpu.observe import JsonlLogger as JJsonlLogger
from idc_models_tpu.observe import metrics_registry as jreg
from idc_models_tpu_torch import serve as tserve
from idc_models_tpu_torch.observe import (
    SLO, JsonlLogger, MetricsExporter, MetricsRegistry, SLOEngine,
)
from idc_models_tpu_torch.observe.stats import (
    format_request_timeline, summarize_jsonl,
)

VOCAB, SEQ, E, HEADS, MLP, BLOCKS = 11, 32, 32, 2, 64, 1
KW = dict(embed_dim=E, num_heads=HEADS, num_blocks=BLOCKS, t_max=SEQ)
CHUNK = 8
PKGS = {"port": tserve, "jax": jserve}
REGS = {"port": MetricsRegistry, "jax": jreg.MetricsRegistry}
LOGGERS = {"port": JsonlLogger, "jax": JJsonlLogger}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share a few cores: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _params():
    """The JAX LM's seed-0 weights as host arrays, the head sharpened so
    greedy picks win by more than the packages' rounding."""
    model = jlm.attention_lm(VOCAB, SEQ, embed_dim=E, num_heads=HEADS,
                             mlp_dim=MLP, num_blocks=BLOCKS)
    params = jax.tree.map(np.array, jax.device_get(
        model.init(jax.random.key(0)).params))
    params["head"]["kernel"] = params["head"]["kernel"] * 8.0
    return params


def _rep(pkg, rid, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("window", 4)
    if pkg == "port":
        return tserve.build_replica(_params(), replica_id=rid,
                                    device="cpu",
                                    cache_dtype=torch.float32, **KW, **kw)
    return jserve.build_replica(_params(), replica_id=rid,
                                cache_dtype=jnp.float32, **KW, **kw)


def _records(paths):
    recs = []
    for p in paths:
        for line in p.read_text().splitlines():
            if line.strip():
                recs.append(json.loads(line))
    return recs


def _schemas(recs, event):
    return {frozenset(r) for r in recs if r.get("event") == event}


def _series(reg, name):
    inst = reg.get(name)
    if inst is None:
        return {}
    return {tuple(sorted(labels.items())): val
            for labels, val in inst._series()}


# -- the merged cross-replica timeline --------------------------------------


def _elastic_drill(pkg, tmp_path):
    """JAX's acceptance drill: 1 -> 2 -> 1 under the autoscaler on a
    manual clock, with a prefill replica, each process writing its own
    jsonl; returns the router, the long requests' Results and the log
    paths."""
    p = PKGS[pkg]
    logs = {name: LOGGERS[pkg](tmp_path / pkg / f"{name}.jsonl")
            for name in ("router", "rp", "r0", "auto1")}
    registry = p.PrefixRegistry(CHUNK, 64 << 20, logger=logs["router"])
    prefix_kw = dict(prefill_chunk=CHUNK, prefix_cache_mb=8.0,
                     shared_prefix=registry)
    rp = _rep(pkg, "rp", role="prefill", logger=logs["rp"], **prefix_kw)
    r0 = _rep(pkg, "r0", window=2, logger=logs["r0"], **prefix_kw)
    t = [0.0]
    auto = p.Autoscaler(p.AutoscaleConfig(
        min_replicas=1, max_replicas=2, queue_high=2.0, queue_low=1.5,
        dwell_s=0.5, cooldown_s=2.0), logger=logs["router"])
    router = p.Router(
        [r0, rp], prefix_registry=registry, clock=lambda: t[0],
        logger=logs["router"], autoscaler=auto,
        replica_factory=lambda rid: _rep(
            pkg, rid, window=2, logger=logs["auto1"], **prefix_kw))
    shorts = [p.Request(id=f"s{i}", prompt=(1, 2, 3, 4),
                        max_new_tokens=2) for i in range(6)]
    for q in shorts:
        assert router.submit(q)
    router.step()
    t[0] = 1.0
    router.step()
    for _ in range(200):
        if all(router.poll(q.id) is not None for q in shorts):
            break
        router.step()
    # two chunks of in-vocab tokens (JAX clamps an out-of-vocab id in
    # its embedding gather; the port refuses it)
    longs = [p.Request(id=f"big{i}",
                       prompt=tuple(1 + j % (VOCAB - 1) for j in range(16)),
                       max_new_tokens=12) for i in range(2)]
    for q in longs:
        assert router.submit(q)
    for _ in range(2):
        router.step()
    t[0] = 11.0
    router.step()
    for _ in range(200):
        if all(router.poll(q.id) is not None for q in longs):
            break
        router.step()
    res = {q.id: router.poll(q.id) for q in longs}
    for lg in logs.values():
        lg.close()
    return router, res, [lg.path for lg in logs.values()]


def _hops(recs):
    """The router's hop records, without wall times and trace ids."""
    return [{k: v for k, v in r.items() if k not in ("ts", "trace_id")}
            for r in recs if str(r.get("event")).startswith(
                ("cluster_", "autoscale_"))]


def test_autoscaled_migration_renders_one_merged_timeline(tmp_path):
    """Scale up on a burst, two long prompts handed off through the
    prefill replica onto the two decode replicas, scale down with the
    victim's running slot moved live: the migrated request's merged
    timeline (four logs) holds place, handoff, slot migrate and finish
    under ONE trace id with rising hop numbers, and the hop records,
    slot moves and tokens equal JAX's record for record; every hop
    schema is JAX's frozen one."""
    router, res, paths = _elastic_drill("port", tmp_path)
    jrouter, jres, jpaths = _elastic_drill("jax", tmp_path)
    assert router.slot_migrations == jrouter.slot_migrations
    mig = router.slot_migrations[0]
    assert mig["from"] == "r0" and mig["to"].startswith("auto")
    assert {k: r.tokens for k, r in res.items()} == {
        k: r.tokens for k, r in jres.items()}
    assert {r.status for r in res.values()} == {"ok"}
    recs, jrecs = _records(paths), _records(jpaths)
    assert _hops(recs) == _hops(jrecs)
    rid = mig["rid"]
    merged = summarize_jsonl(paths)
    tl = merged["requests"][rid]
    whats = [e["what"] for e in tl]
    assert {"cluster_place", "cluster_handoff", "cluster_slot_migrate",
            "serve_finish"} <= set(whats)
    assert whats.index("cluster_slot_migrate") < whats.index(
        "serve_finish")
    tids = {e["detail"]["trace_id"] for e in tl
            if e["what"].startswith("cluster_")}
    assert tids == {res[rid].trace_id}
    hops = [e["detail"]["hop"] for e in tl if "hop" in e["detail"]]
    assert hops == sorted(hops) and len(set(hops)) == len(hops)
    text = format_request_timeline(merged, rid)
    assert "cluster_slot_migrate" in text and "(+" in text
    doc = tserve.ClusterTelemetry(router).health()
    assert set(doc["autoscaler"]) == set(
        jserve.ClusterTelemetry(jrouter).health()["autoscaler"])
    frozen = {
        "cluster_place": {"ts", "event", "id", "replica", "attempt",
                          "trace_id", "hop"},
        "cluster_handoff": {"ts", "event", "id", "replica",
                            "prefix_tokens", "cached", "trace_id", "hop"},
        "cluster_slot_migrate": {"ts", "event", "id", "src", "dst",
                                 "trace_id", "hop"},
        "cluster_scale_up": {"ts", "event", "replica", "live"},
        "cluster_drain": {"ts", "event", "replica"},
        "autoscale_decision": {"ts", "event", "action", "reason", "live",
                               "queued", "t"},
        "cluster_prefix_publish": {"ts", "event", "prefix_tokens",
                                   "nbytes"},
    }
    for event, keys in frozen.items():
        assert _schemas(recs, event) == {frozenset(keys)}, event


# -- merged fleet metrics and the fleet /healthz ----------------------------


def _fleet_run(pkg):
    reps = [_rep(pkg, f"r{i}") for i in range(2)]
    router = PKGS[pkg].Router(reps, registry=REGS[pkg]())
    rng = np.random.default_rng(3)
    reqs = [PKGS[pkg].Request(
        id=f"q{i}", prompt=tuple(int(x) for x in
                                 rng.integers(0, VOCAB, 3 + i)),
        max_new_tokens=9) for i in range(4)]
    out = router.run([(0.0, q) for q in reqs])
    assert {r.status for r in out} == {"ok"}
    return router, reps


def test_fleet_metrics_rollups_equal_the_per_replica_sums():
    """The merged exposition carries each replica's series verbatim
    under a ``replica`` label; the fleet rollups equal the sums of those
    series in the same scrape and of the live per-replica registries;
    histograms merge by state (the fleet TTFT count is the request
    count); the router's cluster_* series ride along; and the metric
    families and every counter's value equal JAX's merged exposition."""
    router, reps = _fleet_run("port")
    jrouter, _ = _fleet_run("jax")
    merged = tserve.ClusterTelemetry(router).merged_registry()
    jmerged = jserve.ClusterTelemetry(jrouter).merged_registry()
    for rep in reps:
        own = _series(rep.registry, "serve_requests_total")
        lifted = {tuple(kv for kv in key if kv[0] != "replica"): val
                  for key, val in _series(merged,
                                          "serve_requests_total").items()
                  if ("replica", rep.replica_id) in key}
        assert lifted == own and own
    qsum = sum(val for key, val in _series(merged,
                                           "serve_queue_depth").items()
               if any(k == "replica" for k, _ in key))
    assert _series(merged, "cluster_fleet_queue_depth") == {(): qsum}
    assert qsum == sum(rep.registry.get("serve_queue_depth").value()
                       for rep in reps)
    fleet_ttft = sum(st["count"] for _, st in
                     merged.get("serve_ttft_seconds")._series())
    assert fleet_ttft == 4
    assert _series(merged, "cluster_placements_total")
    names = {i.name for i in merged.instruments()}
    jnames = {i.name for i in jmerged.instruments()}
    assert names == jnames
    for inst in merged.instruments():
        if inst.kind == "counter":
            assert _series(merged, inst.name) == _series(
                jmerged, inst.name), inst.name
    s = router.summary()
    assert s["cluster_itl_ms_p95"] is not None
    text = tserve.ClusterTelemetry(router).prometheus_text()
    assert 'replica="r0"' in text and "cluster_fleet_queue_depth" in text


def test_fleet_healthz_has_the_jax_keys_and_serves_over_http():
    """The fleet /healthz embeds every replica's health document, the
    fleet aggregates with JAX's keys, no autoscaler, SLO or compile-cache
    block when none is armed, and degrades on a dead replica; a
    cluster-armed exporter serves it and the merged /metrics, while a
    plain exporter keeps its one-server document."""
    router, reps = _fleet_run("port")
    jrouter, _ = _fleet_run("jax")
    tele = tserve.ClusterTelemetry(router)
    doc, jdoc = tele.health(), jserve.ClusterTelemetry(jrouter).health()
    assert set(doc) == set(jdoc) == {"status", "replicas", "fleet"}
    assert set(doc["fleet"]) == set(jdoc["fleet"])
    assert doc["fleet"] == jdoc["fleet"]
    for rid, h in doc["replicas"].items():
        assert set(h) == set(jdoc["replicas"][rid])
    assert doc["status"] == "ok"
    router.kill_replica("r1")
    doc = tele.health()
    assert doc["status"] == "degraded"
    assert doc["fleet"]["replicas_dead"] == 1
    with MetricsExporter(router.registry, port=0, cluster=tele) as exp:
        with urllib.request.urlopen(exp.url + "/healthz") as resp:
            served = json.loads(resp.read())
        assert set(served) == set(doc)
        assert served["replicas"]["r1"]["state"] == "dead"
        with urllib.request.urlopen(exp.url + "/metrics") as resp:
            body = resp.read().decode()
        assert "cluster_fleet_queue_depth" in body
        assert 'replica="r0"' in body
    solo = MetricsExporter(MetricsRegistry()).health()
    assert set(solo) == {"status", "last_tick_age_s", "queue_depth",
                         "slot_occupancy", "kv_pages_used",
                         "kv_pages_total", "brownout_stage"}


def test_fleet_slo_fires_on_skew_no_single_replica_sees():
    """The router's pooled SLO engine sees a breach spread over both
    replicas, each below its own engine's min_samples: the fleet
    document is degraded while every embedded replica stays clean."""
    def mk():
        return SLOEngine([SLO.latency("ttft", threshold_s=1e-9)],
                         min_samples=10, registry=MetricsRegistry())

    reps = [_rep("port", f"r{i}", slo=mk()) for i in range(2)]
    fleet_slo = mk()
    router = tserve.Router(reps, slo=fleet_slo, registry=MetricsRegistry())
    out = router.run([(0.0, tserve.Request(id=f"w{i}", prompt=(1, 2, 3),
                                           max_new_tokens=2))
                      for i in range(16)])
    assert {r.status for r in out} == {"ok"}
    fleet_slo.evaluate()
    assert fleet_slo.breached("ttft")
    assert not any(h["slo_breached"] for h in router.healths())
    doc = tserve.ClusterTelemetry(router).health()
    assert doc["status"] == "degraded"
    assert doc["slo"]["ttft"]["breached"]


# -- the anomaly watchdogs --------------------------------------------------


class _FakeMetrics:
    def __init__(self):
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.compiles_observed = 0


class _FakeReplica:
    def __init__(self, rid):
        self.replica_id = rid
        self.state = "live"
        self.role = "mixed"
        self.server = type("S", (), {})()
        self.server.metrics = _FakeMetrics()
        self.breached = False

    def health(self):
        return {"slo_breached": self.breached}


class _FakeRouter:
    def __init__(self, reps, registry):
        self.replicas = reps
        self.migrations = []
        self.slot_migrations = []
        self.registry = registry
        self.rollout_canary = None


def _watchdog_drill(pkg, path):
    """JAX's detector drill over a faked fleet: each fault injected in
    turn on a clock the drill moves. Returns every pass's firings, the
    anomalies, the counter series and the logged records."""
    reps = [_FakeReplica("a"), _FakeReplica("b")]
    fr = _FakeRouter(reps, REGS[pkg]())
    wt = [0.0]
    log = LOGGERS[pkg](path)
    wd = PKGS[pkg].ClusterWatchdog(
        fr, PKGS[pkg].WatchdogConfig(
            window_s=5.0, accept_rate_floor=0.2, accept_min_drafted=10,
            compile_churn_limit=2, migration_spike_limit=2),
        logger=log, clock=lambda: wt[0])
    fired = []

    def tick(dt=1.0):
        wt[0] += dt
        fired.append(wd.check())
        return fired[-1]

    m0, m1 = reps[0].server.metrics, reps[1].server.metrics
    for _ in range(6):
        assert tick() == []
    m0.spec_drafted += 100
    m0.spec_accepted += 60
    tick()
    m1.spec_drafted += 400
    m1.spec_accepted += 2
    tick()
    m1.spec_drafted += 100
    tick()
    wt[0] += 10.0
    wd.check()
    m0.spec_drafted += 100
    m0.spec_accepted += 90
    tick()
    m0.spec_drafted += 400
    tick()
    wt[0] += 10.0
    wd.check()
    m0.spec_drafted += 3
    tick()
    m1.compiles_observed += 5
    tick()
    fr.migrations.extend([{}, {}])
    fr.slot_migrations.append({})
    tick()
    fr.rollout_canary = reps[1]
    reps[1].breached = reps[0].breached = True
    tick()
    reps[0].breached = False
    tick()
    tick()
    fr.rollout_canary = None
    tick()
    fr.rollout_canary = reps[1]
    tick()
    log.close()
    recs = [{k: v for k, v in r.items() if k != "ts"}
            for r in _records([path])]
    return (fired, wd.anomalies,
            _series(fr.registry, "cluster_anomalies_total"), recs,
            _schemas(_records([path]), "cluster_anomaly"))


def test_watchdog_detectors_fire_once_like_jax(tmp_path):
    """Each detector is silent on a clean fleet, fires once on the
    transition into its fault (hysteresis), clears and can fire again,
    and logs one frozen-schema ``cluster_anomaly`` record with a
    labelled counter bump: every pass's firings, the records and the
    counters equal JAX's."""
    got = _watchdog_drill("port", tmp_path / "port.jsonl")
    want = _watchdog_drill("jax", tmp_path / "jax.jsonl")
    assert got[:4] == want[:4]
    kinds = [[f["kind"] for f in fired] for fired in got[0]]
    assert sum(kinds, []) == ["accept_collapse", "accept_collapse",
                              "compile_churn", "migration_spike",
                              "canary_divergence", "canary_divergence"]
    assert got[2] == {(("kind", "accept_collapse"),): 2,
                      (("kind", "canary_divergence"),): 2,
                      (("kind", "compile_churn"),): 1,
                      (("kind", "migration_spike"),): 1}
    assert got[4] == {frozenset({"ts", "event", "kind", "replica",
                                 "value", "threshold", "window_s"})}


def test_watchdog_config_validates_like_jax():
    for pkg in PKGS:
        cfg = PKGS[pkg].WatchdogConfig
        for bad, match in ((dict(window_s=0), "window_s"),
                           (dict(accept_rate_floor=1.5),
                            "accept_rate_floor"),
                           (dict(accept_min_drafted=0),
                            "accept_min_drafted"),
                           (dict(compile_churn_limit=-1), "limits")):
            with pytest.raises(ValueError, match=match):
                cfg(**bad)


def test_a_real_fleet_stays_silent_and_counts_no_compiles():
    """On a clean two-replica run the armed watchdog fires nothing; the
    eager port's replicas observe no compile (the churn detector reads
    0), and the summary reports it."""
    router, reps = _fleet_run("port")
    wd = tserve.ClusterWatchdog(router)
    router.watchdog = wd
    router.run([(0.0, tserve.Request(id=f"x{i}", prompt=(1, 2),
                                     max_new_tokens=3)) for i in range(4)])
    assert wd.anomalies == []
    assert all(r.server.metrics.compiles_observed == 0 for r in reps)
    assert reps[0].server.summary()["serve_compiles_observed"] == 0


def test_canary_and_shed_events_carry_the_trace_schema(tmp_path):
    """A fleet rollout's canary markers and a cluster-wide shed ride the
    trace chain with JAX's frozen schemas; each canary marker shares
    its request's placement trace id, and the shed names its reason."""
    log = JsonlLogger(tmp_path / "router.jsonl")
    reps = [_rep("port", f"r{i}") for i in range(2)]
    router = tserve.Router(reps, logger=log, registry=MetricsRegistry())
    assert router.start_rollout(_params()) in {"r0", "r1"}
    reqs = [tserve.Request(id=f"c{i}", prompt=(1, 2, 3), max_new_tokens=2)
            for i in range(4)]
    for q in reqs:
        assert router.submit(q)
    router.drain()
    assert router.finish_rollout() == "promoted"
    router.kill_replica("r0")
    router.kill_replica("r1")
    assert not router.submit(tserve.Request(id="lost", prompt=(1, 2),
                                            max_new_tokens=2))
    log.close()
    recs = _records([log.path])
    assert _schemas(recs, "cluster_canary") == {frozenset(
        {"ts", "event", "id", "replica", "trace_id", "hop"})}
    placed = {r["id"]: r["trace_id"] for r in recs
              if r.get("event") == "cluster_place"}
    canaried = [r for r in recs if r.get("event") == "cluster_canary"]
    assert canaried and all(r["trace_id"] == placed[r["id"]]
                            for r in canaried)
    assert _schemas(recs, "cluster_shed") == {frozenset(
        {"ts", "event", "id", "trace_id", "reason"})}
    shed = [r for r in recs if r.get("event") == "cluster_shed"]
    assert shed[0]["id"] == "lost"
    assert shed[0]["reason"] == "no_live_replica"
    base = {"ts", "event", "stage", "replica"}
    assert _schemas(recs, "cluster_rollout") <= {
        frozenset(base), frozenset(base | {"reason"})}
