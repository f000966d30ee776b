"""The port's serving cluster (idc_models_tpu_torch/serve/cluster/: the
prefix registry, replicas, router, autoscaler; `PrefixCache(shared=)`;
the `serve-cluster` verb) on the CPU, against the JAX package's on the
same weights (seed 0, JAX-initialised, carried across as a host tree),
the same requests and, where time matters, the same fake clock.

The oracles are the JAX package's tests/test_cluster.py and
test_elastic.py (`:82-182`, `:257-532`): placement, disaggregation,
failover, drain with live slot migration, autoscaling, tenant affinity,
hedging and the verb. The router's host logic is the same in both
packages, so placements, handoffs, migrations, the `cluster_*` counters
and the autoscaler's decisions are held EQUAL; greedy tokens are held
equal too (f32 at a tiny width, the head sharpened so every pick wins by
more than the packages' rounding). Sampled streams draw from different
generators in the two packages, so a sampled slot migration is held
bit for bit against the port's own unmigrated run."""

from __future__ import annotations

import contextlib
import functools
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idc_models_tpu import serve as jserve
from idc_models_tpu.models import lm as jlm
from idc_models_tpu.serve.cluster import autoscaler as jasc
from idc_models_tpu_torch import cli
from idc_models_tpu_torch import serve as tserve
from idc_models_tpu_torch.observe import MetricsRegistry
from idc_models_tpu_torch.serve.cluster import autoscaler as tasc

VOCAB, SEQ, E, HEADS, MLP, BLOCKS = 11, 32, 32, 2, 64, 1
KW = dict(embed_dim=E, num_heads=HEADS, num_blocks=BLOCKS, t_max=SEQ)
CHUNK = 8
PKGS = {"port": tserve, "jax": jserve}


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


class _Records:
    """A logger keeping its records."""

    def __init__(self):
        self.records = []

    def log(self, **rec):
        self.records.append(rec)

    def close(self):
        pass

    def events(self, name, *keys):
        return [tuple(r[k] for k in keys) for r in self.records
                if r.get("event") == name]


def _requests(pkg, n, seed=5, budget=None, **kw):
    rng = np.random.default_rng(seed)
    return [PKGS[pkg].Request(
        id=f"r{i}", prompt=tuple(int(x) for x in
                                 rng.integers(0, VOCAB, 3 + 2 * i)),
        max_new_tokens=budget or 4 + (i % 5) * 2, **kw)
        for i in range(n)]


def _counters(summary) -> dict:
    """The summary without the wall-clock figures (ms, tokens/s)."""
    return {k: v for k, v in summary.items()
            if "_ms_" not in k and "per_sec" not in k}


def _tokens(router, reqs) -> dict:
    return {q.id: router.poll(q.id).tokens for q in reqs}


# -- placement, tokens and counters -----------------------------------------


def test_router_places_and_counts_like_jax():
    """Two replicas, six greedy requests through `Router.run`: the
    sequence of placements, every request's tokens and every `cluster_*`
    counter equal the JAX router's; least-loaded placement over an idle
    fleet alternates."""
    got = {}
    for pkg in PKGS:
        log = _Records()
        router = PKGS[pkg].Router([_rep(pkg, f"r{i}") for i in range(2)],
                                  logger=log)
        reqs = _requests(pkg, 6)
        out = router.run([(0.0, q) for q in reqs])
        assert sorted(r.id for r in out) == sorted(q.id for q in reqs)
        assert {r.status for r in out} == {"ok"}
        got[pkg] = (log.events("cluster_place", "id", "replica",
                               "attempt"),
                    _tokens(router, reqs), _counters(router.summary()))
    assert got["port"] == got["jax"]
    places, _, summary = got["port"]
    assert [p[1] for p in places] == ["r0", "r1"] * 3
    assert summary["cluster_placements"] == {"r0": 3, "r1": 3}
    assert summary["cluster_requests"] == 6


def test_placement_skips_draining_and_sheds_cluster_wide_like_jax():
    """A draining replica takes no placement; with every live replica
    shedding, submit records the terminal cluster-wide shed. With every
    decode replica draining, the shed names the condition, and
    `add_replica` revives the fleet for the same id."""
    got = {}
    for pkg in PKGS:
        reps = [_rep(pkg, f"r{i}", brownout_queue_high=4)
                for i in range(2)]
        router = PKGS[pkg].Router(reps)
        router.drain_replica("r0")
        q = _requests(pkg, 1, seed=2)[0]
        assert router.submit(q)
        owner = router._owner[q.id].replica_id
        router.drain()
        reps[1].server.brownout.force_stage(3, reason="test")
        shed = PKGS[pkg].Request(id="shed-me", prompt=(1, 2),
                                 max_new_tokens=2)
        assert router.submit(shed) is False
        router.drain_replica("r1", wait=True)
        orphan = PKGS[pkg].Request(id="orphan", prompt=(1, 2, 3),
                                   max_new_tokens=4)
        assert router.submit(orphan) is False
        lost = router.poll("orphan")
        router.add_replica(_rep(pkg, "r2"))
        assert router.submit(orphan)
        router.drain()
        got[pkg] = (owner, router.poll("shed-me").status, lost.status,
                    lost.error, router.poll("orphan").status,
                    router.poll("orphan").tokens,
                    _counters(router.summary()))
    assert got["port"] == got["jax"]
    assert got["port"][:3] == ("r1", "shed", "shed")
    assert "no live decode-capable replica" in got["port"][3]


def test_router_build_errors_carry_the_jax_messages():
    """Misconfigured fleets fail at build with JAX's messages: a prefill
    replica without chunks or without a registry, a chunk mismatch, a
    paged replica on the registry, a registry without a local cache, a
    duplicate replica id, an autoscaler without a factory."""
    def errors(pkg):
        p = PKGS[pkg]
        msgs = []
        dec = _rep(pkg, "dc0")
        for make in (
                lambda: p.Router([dec, _rep(pkg, "pf0", role="prefill")],
                                 prefix_registry=p.PrefixRegistry(
                                     CHUNK, 1 << 20)),
                lambda: p.Router([dec, _rep(
                    pkg, "pf1", role="prefill", prefill_chunk=CHUNK,
                    prefix_cache_mb=1.0)]),
                lambda: p.Router([dec, _rep(
                    pkg, "pf2", role="prefill", prefill_chunk=CHUNK,
                    prefix_cache_mb=1.0)],
                    prefix_registry=p.PrefixRegistry(2 * CHUNK, 1 << 20)),
                lambda: _rep(pkg, "bad", prefill_chunk=CHUNK,
                             prefix_cache_mb=1.0,
                             shared_prefix=p.PrefixRegistry(CHUNK, 1024),
                             kv_page_size=8, kv_pages=8),
                lambda: _rep(pkg, "bad",
                             shared_prefix=p.PrefixRegistry(CHUNK, 1024)),
                lambda: p.Router([dec, dec]),
                lambda: p.Router([dec], autoscaler=p.Autoscaler()),
                lambda: p.Router([dec]).add_replica(dec),
                lambda: p.PrefixCache(CHUNK, 1024,
                                      shared=p.PrefixRegistry(4, 1024))):
            with pytest.raises(ValueError) as e:
                make()
            msgs.append(str(e.value))
        return msgs

    port, theirs = errors("port"), errors("jax")
    assert port == theirs
    assert "without prefill_chunk" in port[0]
    assert "needs a prefix_registry" in port[1]
    assert "!= registry chunk" in port[2]
    assert "paged" in port[3]


def test_replica_health_document_equals_jax():
    """The placement-signal document has JAX's keys and values (the
    freshness age aside) before a tick, after one and while draining."""
    docs = {}
    for pkg in PKGS:
        rep = _rep(pkg, "r0", brownout_queue_high=4)
        seq = [rep.health()]
        rep.server.submit(PKGS[pkg].Request(id="x", prompt=(1, 2),
                                            max_new_tokens=2))
        rep.step()
        seq.append(rep.health())
        rep.drain()
        seq.append(rep.health())
        for h in seq:
            h["last_tick_age_s"] = h["last_tick_age_s"] is not None
        docs[pkg] = seq
    assert docs["port"] == docs["jax"]
    assert docs["port"][2]["brownout_stage"] == 3
    assert docs["port"][0]["kv_pages_total"] is None


# -- the prefix registry and the handoff ------------------------------------


def test_prefix_registry_roundtrip_dedupe_eviction_like_jax():
    """The same publishes and lookups into both registries: the same
    answers and summaries; handed-out copies never alias the stored
    master; off-grid publishes and a chunk mismatch are refused; a
    one-snapshot budget evicts the LRU entry."""
    caches = [(np.ones((1, 4, 2, 2), np.float32),
               np.ones((1, 4, 2, 2), np.float32))]
    logits = np.zeros((1, 8), np.float32)
    got = {}
    for pkg in PKGS:
        reg = PKGS[pkg].PrefixRegistry(4, 10_000)
        seq = [reg.publish(np.arange(4), caches, logits),
               reg.publish(np.arange(4), caches, logits)]
        start, back, _ = reg.lookup(np.arange(8))
        back[0][0][:] = 7.0
        _, again, _ = reg.lookup(np.arange(8))
        seq += [start, float(again[0][0][0, 0, 0, 0]),
                reg.covered(np.arange(8)), reg.covered(np.arange(3)),
                reg.lookup(np.arange(10, 14))[0]]
        with pytest.raises(ValueError, match="not a multiple"):
            reg.publish(np.arange(3), caches, logits)
        small = PKGS[pkg].PrefixRegistry(
            4, int(sum(a.nbytes for a in caches[0]) + logits.nbytes))
        seq += [small.publish(np.arange(4), caches, logits),
                small.publish(np.arange(10, 14), caches, logits),
                small.n_snapshots, small.evictions, small.covered(
                    np.arange(4))]
        got[pkg] = (seq, reg.summary(), small.summary())
    assert got["port"] == got["jax"]
    assert got["port"][0][:4] == [True, False, 4, 1.0]


def test_registry_keeps_host_copies_of_device_tensors():
    """A published tensor snapshot is stored on the host (numpy for
    f32, a CPU tensor for bf16, which numpy cannot hold) and never
    aliases the publisher's buffer."""
    reg = tserve.PrefixRegistry(2, 1 << 20)
    k = torch.ones((1, 2, 2, 2), dtype=torch.bfloat16)
    v = torch.ones((1, 2, 2, 2), dtype=torch.float32)
    assert reg.publish(np.arange(2), [(k, v)], torch.zeros((1, 4)))
    k.fill_(5.0)
    v.fill_(5.0)
    _, back, lg = reg.lookup(np.arange(2))
    (k2, v2), = back
    assert torch.is_tensor(k2) and k2.device.type == "cpu"
    assert k2.dtype == torch.bfloat16 and float(k2.max()) == 1.0
    assert isinstance(v2, np.ndarray) and float(v2.max()) == 1.0
    assert isinstance(lg, np.ndarray)
    assert reg.nbytes == k.nbytes + v.nbytes + 4 * 4


SYS = 2 * CHUNK           # the shared system prompt: two chunks


def _handoff_trace(pkg, n=4):
    rng = np.random.default_rng(3)
    system = tuple(int(x) for x in rng.integers(0, VOCAB, SYS))
    return [(0.0, PKGS[pkg].Request(
        id=f"h{i}", prompt=system + tuple(
            int(x) for x in rng.integers(0, VOCAB, 3 + i)),
        max_new_tokens=5)) for i in range(n)]


def test_prefill_decode_handoff_equals_jax_and_a_chunked_server():
    """One prefill and two decode replicas over a registry, four
    requests sharing a two-chunk system prompt: a handoff a request
    (the system prompt's chunks run once cluster-wide, on the prefill
    replica), registry hits, no placement on the prefill replica; the
    handoffs, placements, registry summary, counters and tokens equal
    JAX's, and the tokens equal a chunked single server's on the port."""
    got, chunks = {}, []
    for pkg in PKGS:
        reg = PKGS[pkg].PrefixRegistry(CHUNK, 64 << 20)
        kw = dict(prefill_chunk=CHUNK, prefix_cache_mb=8.0,
                  shared_prefix=reg)
        reps = [_rep(pkg, "pf0", role="prefill", **kw),
                _rep(pkg, "dc0", role="decode", **kw),
                _rep(pkg, "dc1", role="decode", **kw)]
        if pkg == "port":
            for rep in reps:
                step = rep.server.engine._gen.prefill_chunk_step

                def counted(caches, padded, start, end, _step=step,
                            _rid=rep.replica_id):
                    chunks.append((_rid, start))
                    return _step(caches, padded, start, end)

                rep.server.engine._gen.prefill_chunk_step = counted
        log = _Records()
        router = PKGS[pkg].Router(reps, prefix_registry=reg, logger=log)
        trace = _handoff_trace(pkg)
        out = router.run(trace)
        assert {r.status for r in out} == {"ok"}
        got[pkg] = (router.handoffs,
                    log.events("cluster_place", "id", "replica"),
                    reg.summary(), _counters(router.summary()),
                    _tokens(router, [q for _, q in trace]),
                    [r.server.engine.prefix_cache.shared_hits
                     for r in reps])
    assert got["port"] == got["jax"]
    handoffs, places, reg_summary, summary, tokens, _ = got["port"]
    assert summary["cluster_handoffs"] == len(handoffs) == 4
    # the first request is prefilled on pf0; the registry then covers
    # every later prompt's boundary, so nobody prefills it again
    assert [h["cached"] for h in handoffs] == [False, True, True, True]
    assert summary["cluster_placements"]["pf0"] == 0
    # each decode replica adopts the system prompt from the registry
    # once; its own cache answers the next prompt that shares it
    assert reg_summary["cluster_prefix_hits"] == 2
    assert got["port"][5] == [0, 1, 1]
    # the system prompt's chunks ran once, on the prefill replica; the
    # decode replicas ran no chunk of it
    sys_chunks = [c for c in chunks if c[1] < SYS]
    assert sys_chunks == [("pf0", 0), ("pf0", CHUNK)]
    single = tserve.LMServer(_params(), n_slots=2, window=4, device="cpu",
                             cache_dtype=torch.float32,
                             prefill_chunk=CHUNK,
                             registry=MetricsRegistry(), **KW)
    trace = _handoff_trace("port")
    single.run(trace)
    assert tokens == {q.id: single.poll(q.id).tokens for _, q in trace}


def test_prefill_only_leaves_the_replica_free_and_refuses_misuse():
    """`prefill_only` publishes the boundary and hands back the slot; a
    caller error (a prompt past t_max) raises through submit and leaves
    the prefill replica live, as in JAX."""
    reg = tserve.PrefixRegistry(CHUNK, 1 << 20)
    pre = _rep("port", "pf0", role="prefill", prefill_chunk=CHUNK,
               prefix_cache_mb=2.0, shared_prefix=reg)
    dec = _rep("port", "dc0", prefill_chunk=CHUNK, prefix_cache_mb=2.0,
               shared_prefix=reg)
    assert pre.prefill_only(tuple(range(CHUNK + 3))) == CHUNK
    assert pre.server.engine.free_slots() == [0, 1]
    assert reg.covered(tuple(range(CHUNK + 3))) == CHUNK
    router = tserve.Router([pre, dec], prefix_registry=reg)
    with pytest.raises(ValueError):
        router.submit(tserve.Request(id="huge", prompt=tuple(range(SEQ)),
                                     max_new_tokens=4))
    assert pre.state == "live"
    assert router.submit(tserve.Request(
        id="fine", prompt=tuple(range(CHUNK)), max_new_tokens=4))
    router.drain()
    assert router.poll("fine").status == "ok"
    assert router.handoffs[0]["cached"] is True


# -- failover ---------------------------------------------------------------


def test_kill_drill_migrates_the_journal_like_jax(tmp_path):
    """Two journaled replicas, eight requests, r0 killed after two
    steps: the migrated ids, every request's tokens and the counters
    equal JAX's; each migrated request keeps ONE trace id and its
    relative deadline across both journals and finishes on the
    survivor."""
    got = {}
    for pkg in PKGS:
        reps = [_rep(pkg, f"r{i}",
                     journal_path=str(tmp_path / f"{pkg}{i}.jsonl"))
                for i in range(2)]
        router = PKGS[pkg].Router(reps,
                                  retry=PKGS[pkg].RetryPolicy(max_retries=2))
        rng = np.random.default_rng(7)
        reqs = [PKGS[pkg].Request(
            id=f"k{i}", prompt=tuple(int(x) for x in
                                     rng.integers(0, VOCAB, 4 + i)),
            max_new_tokens=8, deadline_s=120.0) for i in range(8)]
        for q in reqs:
            assert router.submit(q)
        for _ in range(2):
            router.step()
        migrated = router.kill_replica("r0")
        router.drain()
        assert all(router.poll(q.id).status == "ok" for q in reqs)
        got[pkg] = (migrated, _tokens(router, reqs),
                    _counters(router.summary()),
                    [m["rid"] for m in router.migrations])
    assert got["port"] == got["jax"]
    migrated = got["port"][0]
    assert migrated and got["port"][2]["cluster_replicas_dead"] == 1
    submits, finishes = {}, {}
    for i in (0, 1):
        for line in (tmp_path / f"port{i}.jsonl").read_text().splitlines():
            rec = json.loads(line)
            if rec.get("event") == "journal_submit":
                submits.setdefault(rec["id"], []).append((i, rec))
            elif rec.get("event") == "journal_finish":
                finishes.setdefault(rec["id"], []).append((i, rec))
    for rid in migrated:
        assert sorted(i for i, _ in submits[rid]) == [0, 1]
        assert len({rec["trace_id"] for _, rec in submits[rid]}) == 1
        assert {rec["deadline_s"] for _, rec in submits[rid]} == {120.0}
        assert [(i, rec["status"]) for i, rec in finishes[rid]] == [
            (1, "ok")]


def test_step_failure_and_journalless_death_like_jax(tmp_path):
    """An injected engine crash on a journaled replica is a replica
    death: its journal migrates onto the survivor with JAX's tokens. A
    replica killed without a journal returns its in-flight requests as
    error Results through drain(), as in JAX."""
    got = {}
    for pkg in PKGS:
        p = PKGS[pkg]
        plan = p.ServeFaultPlan([p.ServeFault(kind="crash", tick=2)])
        crasher = _rep(pkg, "r0", fault_plan=plan,
                       journal_path=str(tmp_path / f"{pkg}c.jsonl"))
        healthy = _rep(pkg, "r1",
                       journal_path=str(tmp_path / f"{pkg}h.jsonl"))
        router = p.Router([crasher, healthy])
        reqs = _requests(pkg, 4, seed=11, budget=8)
        for q in reqs:
            assert router.submit(q)
        router.drain()
        assert crasher.state == "dead"
        crash = (_tokens(router, reqs), _counters(router.summary()))

        router = p.Router([_rep(pkg, f"r{i}") for i in range(2)])
        reqs = _requests(pkg, 4, seed=17, budget=8)
        for q in reqs:
            assert router.submit(q)
        owned = sorted(rid for rid, rep in router._owner.items()
                       if rep.replica_id == "r0")
        router.kill_replica("r0")
        by_id = {r.id: r for r in router.drain()}
        assert set(by_id) == {q.id for q in reqs}
        lost = sorted(rid for rid, r in by_id.items()
                      if r.status == "error"
                      and "without a journal" in r.error)
        got[pkg] = (crash, owned, lost)
    assert got["port"] == got["jax"]
    assert got["port"][1] == got["port"][2] and got["port"][1]
    assert got["port"][0][1]["cluster_migrations"] >= 1


def test_no_decode_capable_replica_raises_not_spins(tmp_path):
    """With the last decode replica dead and only a prefill replica
    left, drain() and run() raise the rebuild-the-fleet error."""
    reg = tserve.PrefixRegistry(CHUNK, 1 << 20)
    dec = _rep("port", "dc0", prefill_chunk=CHUNK, prefix_cache_mb=2.0,
               shared_prefix=reg, journal_path=str(tmp_path / "j.jsonl"))
    pre = _rep("port", "pf0", role="prefill", prefill_chunk=CHUNK,
               prefix_cache_mb=2.0, shared_prefix=reg)
    router = tserve.Router([dec, pre], prefix_registry=reg)
    assert router.submit(tserve.Request(id="a", prompt=(1, 2, 3),
                                        max_new_tokens=4))
    router.kill_replica("dc0")
    with pytest.raises(RuntimeError, match="rebuild the fleet"):
        router.drain()
    with pytest.raises(RuntimeError, match="rebuild the fleet"):
        router.run([(0.0, tserve.Request(id="b", prompt=(1, 2),
                                         max_new_tokens=2))])


def test_hedge_first_result_wins_like_jax():
    """Past `hedge_after_s` (a fake clock) the request is copied onto
    the other replica; its owner then dies without a journal and the
    copy answers under the original id with JAX's tokens; the copy's
    id never surfaces."""
    got = {}
    for pkg in PKGS:
        t = [0.0]
        log = _Records()
        router = PKGS[pkg].Router([_rep(pkg, f"r{i}") for i in range(2)],
                                  hedge_after_s=0.5, clock=lambda: t[0],
                                  logger=log)
        assert router.submit(PKGS[pkg].Request(id="h", prompt=(1, 2, 3),
                                               max_new_tokens=6))
        owner = router._owner["h"].replica_id
        t[0] = 1.0
        router.step()
        router.kill_replica(owner)
        router.drain()
        got[pkg] = (owner, router.hedges_sent, router.poll("h").status,
                    router.poll("h").tokens, router.poll("h#h"),
                    log.events("cluster_hedge", "id", "replica", "hop"))
    assert got["port"] == got["jax"]
    assert got["port"][1:3] == (1, "ok")


def test_tenant_affinity_and_rehoming_like_jax():
    """A tenant sticks to its home replica while the slack holds, a
    draining home loses it, a dead home is forgotten: the same homes,
    in order, as the JAX router."""
    got = {}
    for pkg in PKGS:
        router = PKGS[pkg].Router([_rep(pkg, f"r{i}") for i in range(3)],
                                  tenant_affinity_slack=4)

        def place(rid, tenant=None):
            assert router.submit(PKGS[pkg].Request(
                id=rid, prompt=(1, 2, 3), max_new_tokens=3,
                tenant=tenant))
            rep = router._owner[rid]
            router.drain()
            return rep.replica_id

        homes = [place("a0", "acme"), place("a1", "acme"),
                 place("a2", "acme"), place("u0")]
        router.drain_replica(homes[0], wait=True)
        homes.append(place("a3", "acme"))
        router.kill_replica(homes[-1])
        homes.append("acme" in router._tenant_home)
        homes.append(place("a4", "acme"))
        got[pkg] = homes
    assert got["port"] == got["jax"]
    homes = got["port"]
    assert homes[0] == homes[1] == homes[2] and homes[4] != homes[0]
    assert homes[5] is False and homes[6] not in (homes[0], homes[4])


# -- drain with live slot migration -----------------------------------------


def _drain_pair(pkg, *, sampled, migrate, tmp_path=None):
    kw = dict(temperature=1.0) if sampled else {}
    reps = [_rep(pkg, f"r{i}", **kw,
                 journal_path=(None if tmp_path is None else
                               str(tmp_path / f"{pkg}{int(migrate)}{i}"
                                              f".jsonl")))
            for i in range(2)]
    router = PKGS[pkg].Router(reps)
    reqs = [PKGS[pkg].Request(id=f"m{i}", prompt=tuple(
        range(1 + i, 6 + i)), max_new_tokens=12,
        seed=(42 + i if sampled else None)) for i in range(2)]
    for q in reqs:
        assert router.submit(q)
    router.step()
    moved = router.drain_replica("r0", migrate=True) if migrate else []
    router.drain()
    assert all(router.poll(q.id).status == "ok" for q in reqs)
    return router, moved, _tokens(router, reqs)


@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "sampled"])
def test_drain_moves_live_slots_bit_equal(sampled, tmp_path):
    """Two requests mid-decode on two replicas; r0 drains with
    migrate=True: its running slot moves onto r1 (KV, position, budget
    and, sampled, the generator's state) and every request's tokens
    equal the unmigrated run's on the port bit for bit. Greedy, the
    moves, tokens and counters also equal JAX's, and both journals
    carry the gap protocol."""
    router, moved, tokens = _drain_pair("port", sampled=sampled,
                                        migrate=True, tmp_path=tmp_path)
    _, _, still = _drain_pair("port", sampled=sampled, migrate=False)
    assert moved == ["m0"] and tokens == still
    assert router.slot_migrations == [{"rid": "m0", "from": "r0",
                                       "to": "r1"}]
    assert router.summary()["cluster_slot_migrations"] == 1
    if sampled:
        return
    jrouter, jmoved, jtokens = _drain_pair("jax", sampled=False,
                                           migrate=True,
                                           tmp_path=tmp_path)
    assert (moved, tokens, router.slot_migrations) == (
        jmoved, jtokens, jrouter.slot_migrations)
    assert _counters(router.summary()) == _counters(jrouter.summary())

    def events(path):
        return [(r["event"], r.get("id"), r.get("status"),
                 r.get("direction")) for r in map(
            json.loads, path.read_text().splitlines())]

    for i in (0, 1):
        assert events(tmp_path / f"port1{i}.jsonl") == events(
            tmp_path / f"jax1{i}.jsonl")
    assert ("journal_finish", "m0", "migrated", None) in events(
        tmp_path / "port10.jsonl")


def test_migration_falls_back_and_the_gap_loses_nothing(tmp_path):
    """No free peer slot: drain falls back to a from-the-prompt
    re-placement with JAX's tokens. A source killed between export and
    import still holds the request open in its journal, and failover
    replays it with JAX's tokens."""
    got = {}
    for pkg in PKGS:
        router = PKGS[pkg].Router([_rep(pkg, f"r{i}", n_slots=1)
                                   for i in range(2)])
        reqs = [PKGS[pkg].Request(id=f"f{i}", prompt=(1 + i, 2 + i, 3 + i),
                                  max_new_tokens=10) for i in range(2)]
        for q in reqs:
            assert router.submit(q)
        router.step()
        moved = router.drain_replica("r0", migrate=True)
        router.drain()
        fallback = (moved, router.slot_migrations,
                    _counters(router.summary()), _tokens(router, reqs))

        reps = [_rep(pkg, f"r{i}",
                     journal_path=str(tmp_path / f"{pkg}g{i}.jsonl"))
                for i in range(2)]
        router = PKGS[pkg].Router(reps)
        assert router.submit(PKGS[pkg].Request(id="gap0", prompt=(1, 2, 3, 4),
                                               max_new_tokens=10))
        router.step()
        src = reps[0].server
        src.quiesce()
        src.scheduler.begin_drain()
        entry, _ = src.scheduler.export_running("gap0")
        migrated = router.kill_replica("r0")
        router.drain()
        finished_on_src = [
            r for r in map(json.loads, (tmp_path / f"{pkg}g0.jsonl")
                           .read_text().splitlines())
            if r.get("event") == "journal_finish"]
        got[pkg] = (fallback, migrated, router.poll("gap0").status,
                    router.poll("gap0").tokens, finished_on_src)
    assert got["port"] == got["jax"]
    assert got["port"][0][0] == ["f0"] and got["port"][0][1] == []
    assert got["port"][1] == ["gap0"] and got["port"][4] == []


# -- the autoscaler ---------------------------------------------------------


def _health(qd=0, load=0, *, shedding=False, burning=False,
            pages=(None, None), state="live", role="mixed"):
    return {"state": state, "role": role, "queue_depth": qd,
            "load": load, "shedding": shedding, "slo_breached": burning,
            "kv_pages_total": pages[0], "kv_pages_used": pages[1]}


def test_autoscale_policy_decides_like_jax():
    """`decide` over a recorded stream of health documents and times:
    dwell, cooldown, bounds, the shed/burn and page-headroom signals and
    the liveness filter give JAX's (action, reason, state) at every
    tick, and the config refuses JAX's bad knobs with its messages."""
    stream = [
        ([_health(qd=10)], 0.0), ([_health(qd=10)], 0.5),
        ([_health(qd=2)], 0.8), ([_health(qd=10)], 1.0),
        ([_health(qd=10)], 2.1), ([_health(qd=10)], 2.5),
        ([_health(qd=10), _health(qd=10)], 9.0),
        ([_health(qd=0), _health(qd=0)], 12.0),
        ([_health(qd=0), _health(qd=0)], 15.0),
        ([_health(qd=0), _health(qd=0, shedding=True)], 20.0),
        ([_health(qd=0), _health(qd=0, burning=True)], 25.0),
        ([_health(qd=0, pages=(100, 95))], 30.0),
        ([_health(qd=50, state="draining"), _health(qd=50, state="dead"),
          _health(qd=50, role="prefill")], 35.0),
    ]
    cfg = dict(min_replicas=1, max_replicas=2, queue_high=4.0,
               queue_low=1.0, page_headroom=0.2, dwell_s=1.0,
               cooldown_s=2.0)
    got = {}
    for name, mod in (("port", tasc), ("jax", jasc)):
        c = mod.AutoscaleConfig(**cfg)
        state, seq = None, []
        for healths, now in stream:
            action, reason, state = mod.decide(healths, now=now,
                                               state=state, cfg=c)
            seq.append((action, reason, dict(state)))
        auto = mod.Autoscaler(mod.AutoscaleConfig(dwell_s=0.0,
                                                  cooldown_s=0.0))
        recs = [auto.evaluate([_health(qd=2)], now=0.0),
                auto.evaluate([_health(qd=10)], now=1.0)]
        errs = []
        for bad in (dict(min_replicas=3, max_replicas=2),
                    dict(queue_low=4.0, queue_high=4.0),
                    dict(page_headroom=1.0), dict(dwell_s=-1.0)):
            with pytest.raises(ValueError) as e:
                mod.AutoscaleConfig(**bad)
            errs.append(str(e.value))
        got[name] = (seq, recs, auto.state_doc(), errs)
    assert got["port"] == got["jax"]
    actions = [s[0] for s in got["port"][0]]
    assert "up" in actions and "down" in actions


def test_router_autoscales_up_then_down_like_jax():
    """The control loop on a fake clock: a burst scales the fleet up
    (the factory builds 'auto1'), the idle fleet scales down by draining
    a replica with live migration, and every request finishes with
    JAX's tokens; the decisions, placements and counters equal JAX's."""
    got = {}
    for pkg in PKGS:
        t = [0.0]

        def clock():
            t[0] += 0.25
            return t[0]

        built = []

        def factory(rid, _pkg=pkg):
            built.append(rid)
            return _rep(_pkg, rid)

        auto = PKGS[pkg].Autoscaler(PKGS[pkg].AutoscaleConfig(
            min_replicas=1, max_replicas=2, queue_high=2.0, queue_low=1.0,
            dwell_s=0.4, cooldown_s=1.0))
        router = PKGS[pkg].Router([_rep(pkg, "r0")], clock=clock,
                                  autoscaler=auto, replica_factory=factory)
        rng = np.random.default_rng(13)
        reqs = [PKGS[pkg].Request(
            id=f"e{i}", prompt=tuple(int(x) for x in
                                     rng.integers(0, VOCAB, 3 + i % 4)),
            max_new_tokens=6) for i in range(8)]
        for q in reqs:
            assert router.submit(q)
        router.drain()
        for _ in range(16):
            router.step()
        assert sorted(r.id for r in router.results()) == sorted(
            q.id for q in reqs)
        got[pkg] = (built, [(d["action"], d["reason"], d["live"],
                             d["queued"], d["t"])
                            for d in auto.decisions],
                    _tokens(router, reqs), _counters(router.summary()),
                    router.slot_migrations)
    assert got["port"] == got["jax"]
    built, decisions, _, summary, _ = got["port"]
    assert built == ["auto1"]
    assert [d[0] for d in decisions][:1] == ["up"]
    assert "down" in [d[0] for d in decisions]
    assert summary["cluster_replicas_live"] == 1
    assert summary["cluster_shed"] == 0


# -- rollout at fleet scope -------------------------------------------------


def test_fleet_rollout_promotes_and_rolls_back_like_jax():
    """`start_rollout` spot-checks and swaps the least-loaded replica;
    a healthy canary promotes the rest of the fleet (every replica then
    decodes the candidate's tokens), a shedding one swaps back to the
    old weights. The canaries, verdicts and tokens equal JAX's; a NaN
    candidate is refused with the fleet untouched."""
    cand = jax.tree.map(lambda a: a * 1.0, _params())
    cand["head"]["kernel"] = cand["head"]["kernel"][:, ::-1].copy()
    bad = jax.tree.map(lambda a: a * 1.0, _params())
    bad["head"]["kernel"] = np.full_like(bad["head"]["kernel"], np.nan)
    got = {}
    for pkg in PKGS:
        p = PKGS[pkg]
        reps = [_rep(pkg, f"r{i}", brownout_queue_high=8)
                for i in range(2)]
        router = p.Router(reps)
        with pytest.raises(ValueError, match="spot-check") as e:
            router.start_rollout(bad)
        canary = router.start_rollout(cand)
        probes = [p.Request(id=f"p{i}", prompt=(1, 2, 3),
                            max_new_tokens=4) for i in range(2)]
        router.run([(0.0, q) for q in probes])
        split = _tokens(router, probes)
        verdict = router.finish_rollout()
        after = [p.Request(id=f"q{i}", prompt=(1, 2, 3),
                           max_new_tokens=4) for i in range(2)]
        router.run([(0.0, q) for q in after])
        second = router.start_rollout(_params())
        router._by_id[second].server.brownout.force_stage(3,
                                                          reason="test")
        verdict2 = router.finish_rollout()
        got[pkg] = (str(e.value), canary, split, verdict,
                    _tokens(router, after), second, verdict2)
    assert got["port"] == got["jax"]
    _, _, split, verdict, after, _, verdict2 = got["port"]
    assert verdict == "promoted" and verdict2 == "rolled_back"
    assert split["p0"] != split["p1"]
    assert after["q0"] == after["q1"]


# -- the serve-cluster verb -------------------------------------------------


_VERB = ["--vocab", "11", "--t-max", "32", "--embed-dim", "32",
         "--num-heads", "2", "--mlp-dim", "64", "--num-blocks", "1",
         "--slots", "2", "--window", "4", "--requests", "8"]


def _run_verb(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(["serve-cluster", *argv]) == 0
    return out.getvalue().splitlines()


def _comparable(lines):
    """The verb's report without wall-clock figures."""
    keep = []
    for ln in lines:
        if ln.startswith(("ttft p95", "fleet metrics:")) or " took " in ln:
            continue
        if ln.startswith("cluster summary: "):
            ln = json.dumps(_counters(json.loads(ln[17:])),
                            sort_keys=True)
        keep.append(ln)
    return keep


@pytest.mark.parametrize("drill", ["kill", "autoscale"])
def test_serve_cluster_verb_prints_the_jax_lines(drill, tmp_path):
    """The verb at a tiny width, on both packages with the same seed and
    flags: the kill drill over journals with one prefill replica, the
    registry, the fleet /metrics and the watchdog; and the autoscaler
    over one replica. Random weights differ between the packages' inits,
    but no request stops at EOS, so every printed line but the wall-
    clock ones is equal."""
    from idc_models_tpu import cli as jcli

    if drill == "kill":
        flags = ["--replicas", "2", "--prefill-replicas", "1",
                 "--prefill-chunk", "4", "--prefix-cache-mb", "2",
                 "--registry-mb", "8", "--kill-replica", "1",
                 "--kill-after-steps", "2", "--metrics-port", "0",
                 "--watchdog"]
    else:
        flags = ["--replicas", "1", "--autoscale-max", "2"]
    lines = {}
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, [])):
        jdir = tmp_path / name
        lines[name] = _run_verb(main, [*extra, *_VERB, *flags,
                                       "--journal-dir", str(jdir)])
    assert _comparable(lines["port"]) == _comparable(lines["jax"])
    served = next(ln for ln in lines["port"] if ln.startswith("served:"))
    assert served.startswith("served: ok=8 ")
    if drill == "kill":
        assert any(ln.startswith("killed replica r1: ")
                   for ln in lines["port"])
        assert any(ln.startswith("fleet metrics: http://")
                   for ln in lines["port"])
        assert "watchdog: 0 anomaly(ies)" in lines["port"]
    else:
        assert any("bounds [1, 2]" in ln for ln in lines["port"])


def test_serve_cluster_sigterm_flag_drains_between_steps(monkeypatch):
    """The verb's SIGTERM design: the handler only sets a flag, which
    `Router.run` reads between router steps. Set after the first step,
    it stops the offers, drains every live replica and finishes what
    was accepted: every accepted request ok, the rest never submitted,
    and the verb prints the drain line."""
    calls = {"n": 0}

    class _Flag(cli._DrainRequested):
        def __call__(self):
            calls["n"] += 1
            self.requested = self.requested or calls["n"] > 2
            return self.requested

    monkeypatch.setattr(cli, "_DrainRequested", _Flag)
    lines = _run_verb(cli.main, ["--device", "cpu", *_VERB,
                                 "--requests", "16", "--slots", "1",
                                 "--max-queue-depth", "1"])
    assert any(ln.startswith("SIGTERM: cluster drained gracefully")
               for ln in lines)
    summary = json.loads(next(ln for ln in lines if ln.startswith(
        "cluster summary: "))[17:])
    served = next(ln for ln in lines if ln.startswith("served: "))
    assert 0 < summary["cluster_requests"] < 16
    assert served.startswith(f"served: ok={summary['cluster_requests']} ")
    assert summary["cluster_replicas_draining"] == 2


@pytest.mark.parametrize("argv,match", [
    (["--replicas", "0"], "--replicas 0 must be >= 1"),
    (["--prefill-replicas", "-1"], "must be >= 0"),
    (["--prefill-chunk", "5"], "must be >= 1 and divide --t-max"),
    (["--prefix-cache-mb", "2"], "--prefix-cache-mb needs --prefill-chunk"),
    (["--prefill-chunk", "8", "--registry-mb", "2"],
     "--registry-mb needs --prefix-cache-mb"),
    (["--prefill-chunk", "8", "--prefix-cache-mb", "2",
      "--prefill-replicas", "1"], "--prefill-replicas needs --registry-mb"),
    (["--max-retries", "-1"], "must be >= 0"),
    (["--hedge-after-ms", "0"], "must be > 0"),
    (["--kill-replica", "2"], "outside the fleet"),
    (["--drain-replica", "-1"], "outside the fleet"),
    (["--kill-replica", "0"], "--kill-replica needs --journal-dir"),
    (["--kill-after-steps", "-1"], "must be >= 0"),
    (["--autoscale-max", "1"], "it is the fleet ceiling"),
    (["--metrics-port", "70000"], "must be in"),
], ids=lambda v: v if isinstance(v, str) else None)
def test_serve_cluster_usage_errors_carry_the_jax_messages(argv, match):
    """Every bad knob exits before anything is built, with the JAX
    verb's message word for word."""
    from idc_models_tpu import cli as jcli

    msgs = []
    for main, extra in ((cli.main, ["--device", "cpu"]), (jcli.main, [])):
        with pytest.raises(SystemExit, match=match) as e:
            main(["serve-cluster", *extra, *argv])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_replicas_and_the_verb_run_on_the_card_unless_told_otherwise(
        monkeypatch):
    """The port's rule holds for the cluster: with no card, a replica
    built without a device and the verb without --device raise instead
    of carrying on on the CPU; --host-devices runs the fleet on the CPU
    in this process."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.build_replica(_params(), replica_id="r0", n_slots=2,
                             window=4, **KW)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["serve-cluster", *_VERB])
    lines = _run_verb(cli.main, ["--host-devices", "2", *_VERB,
                                 "--requests", "4"])
    assert any(ln.startswith("served: ok=4 ") for ln in lines)


def test_paged_replicas_route_on_page_headroom_like_jax():
    """A paged fleet: placement passes each replica's page gate
    (`can_admit_pages`), the health document carries the pool, and the
    placements, tokens and counters equal JAX's."""
    got = {}
    for pkg in PKGS:
        log = _Records()
        reps = [_rep(pkg, f"r{i}", prefill_chunk=8, kv_page_size=8,
                     kv_pages=8) for i in range(2)]
        router = PKGS[pkg].Router(reps, logger=log)
        h = reps[0].health()
        reqs = _requests(pkg, 4, seed=13, budget=6)
        out = router.run([(0.0, q) for q in reqs])
        assert {r.status for r in out} == {"ok"}
        got[pkg] = ((h["kv_pages_total"], h["kv_pages_used"]),
                    log.events("cluster_place", "id", "replica"),
                    _tokens(router, reqs), _counters(router.summary()))
    assert got["port"] == got["jax"]
    assert got["port"][0] == (8, 0)
