"""The port's buffered async server (idc_models_tpu_torch/federated/
async_fedavg.py) against the JAX package's, on the CPU: the dispatch and
arrival schedule bit for bit (participants in completion order, updates,
staleness, crashes), the trained server within the fed rounds'
tolerance, and the server's own contracts (replay, buffer carry-over,
crash refill, retries that discard in-flight work, the wall-clock
drill).

Small size: populations of 64, cohorts of 8, shards of 16 at 10x10,
batch 16. Servers held against JAX train a dropout-free model; the
port-only contracts train the small CNN with dropout."""

from __future__ import annotations

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idc_models_tpu import faults as jfaults
from idc_models_tpu.federated import async_fedavg as jasync
from idc_models_tpu.federated import fedavg as jfed
from idc_models_tpu.federated import population as jpop
from idc_models_tpu.federated import robust as jrobust
from idc_models_tpu.models import core as jcore
from idc_models_tpu.observe import JsonlLogger as JJsonlLogger
from idc_models_tpu.train import rmsprop as jrmsprop
from idc_models_tpu.train.losses import binary_cross_entropy as jbce
from idc_models_tpu_torch import convert
from idc_models_tpu_torch import faults as tfaults
from idc_models_tpu_torch.federated import (
    DriverConfig, ServerState, run_rounds,
)
from idc_models_tpu_torch.federated import async_fedavg as tasync
from idc_models_tpu_torch.federated import population as tpop
from idc_models_tpu_torch.federated import robust as trobust
from idc_models_tpu_torch.models import core as tcore
from idc_models_tpu_torch.models.small_cnn import small_cnn
from idc_models_tpu_torch.observe import JsonlLogger
from idc_models_tpu_torch.train.losses import binary_cross_entropy as tbce

RTOL, ATOL = 1e-5, 2e-6
C = 8


def _pop(pkg, size=64, **kw):
    return pkg.ClientPopulation(size, examples_per_client=16, image_size=10,
                                seed=3, **kw)


def _jax_seq():
    return jcore.sequential(
        [jcore.conv2d(3, 4, 3, name="c1"), jcore.relu(),
         jcore.max_pool(2, name="pool"), jcore.flatten(),
         jcore.dense(100, 1, name="head")], name="seq")


def _torch_seq():
    return tcore.Sequential(
        [tcore.Conv2d(3, 4, 3, name="c1"), tcore.ReLU(),
         tcore.MaxPool(2, name="pool"), tcore.Flatten(),
         tcore.Dense(100, 1, name="head")], name="seq")


def _flat(tree) -> dict[str, np.ndarray]:
    return {k.replace("/", "."): np.asarray(v)
            for k, v in convert.flatten(tree).items()}


def _async(pop, model=None, **kw):
    kw.setdefault("buffer_size", 4)
    kw.setdefault("batch_size", 16)
    kw.setdefault("seed", 11)
    return tasync.make_async_round(
        model if model is not None else small_cnn(10, 3, 1), 1e-3, tbce,
        pop, tpop.CohortSampler(pop, C, seed=5), device="cpu", **kw)


def _cnn_server(seed=0):
    return ServerState.of(tcore.init_params(small_cnn(10, 3, 1), seed))


def _run(rounds=3, pop_kw=None, **kw):
    rf = _async(_pop(tpop, **(pop_kw or {})), **kw)
    srv = _cnn_server()
    history = []
    for r in range(rounds):
        srv, m = rf(srv, None, None, None, None, round_idx=r)
        history.append((m, rf.last_participants.copy()))
    return srv, history, rf


def _assert_same(a: ServerState, b: ServerState):
    for tree_a, tree_b in ((a.params, b.params), (a.state, b.state)):
        for k in tree_a:
            assert torch.equal(tree_a[k], tree_b[k]), k


# -- against JAX -------------------------------------------------------

SCHEDULES = [
    ("plain", {}, {}),
    ("crash_and_stragglers",
     {"faults": "crash:*:40%,straggler:*:2@c5,c9,c17,c33"},
     {"base_latency_s": (0.001, 0.01), "delay_unit_s": 0.02}),
    ("carry_over", {"buffer_size": 5, "staleness_decay": 0.5}, {}),
    ("weighted_norm_clip", {"aggregator": "norm_clip"},
     {"weighted": True, "base_latency_s": (0.0, 0.005)}),
]


@pytest.mark.parametrize("case,kw,extra", SCHEDULES,
                         ids=[c for c, _, _ in SCHEDULES])
def test_async_rounds_match_jax(case, kw, extra, tmp_path):
    """Two async rounds of both packages from the same weights: the same
    clients complete in the same order, with the same updates, buffer
    fill, staleness (mean, max and histogram) and crashes, bit for bit;
    the server and the loss agree within the rounds' tolerance."""
    weight_range = (8.0, 24.0) if extra.get("weighted") else (1.0, 1.0)
    jp, tp = (_pop(m, weight_range=weight_range) for m in (jpop, tpop))
    spec = kw.get("faults")
    plans = ((jfaults.parse_population_fault_spec(
        spec, 64, seed=2, delay_unit_s=extra.get("delay_unit_s", 0.0)),
        tfaults.parse_population_fault_spec(
            spec, 64, seed=2, delay_unit_s=extra.get("delay_unit_s", 0.0)))
        if spec else (None, None))
    agg = kw.get("aggregator")
    common = dict(buffer_size=kw.get("buffer_size", 4),
                  staleness_decay=kw.get("staleness_decay", 0.9),
                  batch_size=16, seed=11,
                  base_latency_s=extra.get("base_latency_s", (0.0, 0.0)))
    jmodel, tmodel = _jax_seq(), _torch_seq()
    v = jmodel.init(jax.random.key(0))
    convert.load_jax(tmodel, v.params, v.state)
    logs = {"jax": tmp_path / "jax.jsonl", "port": tmp_path / "port.jsonl"}
    with JJsonlLogger(logs["jax"]) as jlog, JsonlLogger(logs["port"]) as tlog:
        jround = jasync.make_async_round(
            jmodel, jrmsprop(1e-3), jbce, jp,
            jpop.CohortSampler(jp, C, seed=5,
                               weighted=bool(extra.get("weighted"))),
            aggregator=(jrobust.get_aggregator(agg, max_norm=0.01)
                        if agg else None),
            faults=plans[0], logger=jlog, **common)
        tround = tasync.make_async_round(
            tmodel, 1e-3, tbce, tp,
            tpop.CohortSampler(tp, C, seed=5,
                               weighted=bool(extra.get("weighted"))),
            aggregator=(trobust.get_aggregator(agg, max_norm=0.01)
                        if agg else None),
            faults=plans[1], logger=tlog, device="cpu", **common)
        js = jfed.ServerState(jnp.zeros((), jnp.int32), v.params, v.state)
        ts = ServerState.of(tmodel)
        crashed = []
        for r in range(2):
            js, jm = jround(js, None, None, None, None, round_idx=r)
            ts, tm = tround(ts, None, None, None, None, round_idx=r)
            crashed.append(tm["crashed"])
            np.testing.assert_array_equal(tround.last_participants,
                                          jround.last_participants)
            assert set(tm) == set(jm)
            for k in set(jm) - {"loss", "accuracy"}:
                assert tm[k] == jm[k], (k, tm[k], jm[k])
            np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=RTOL)
            np.testing.assert_allclose(tm["accuracy"], jm["accuracy"],
                                       rtol=1e-6)
            assert ts.round == int(js.round) == r + 1
            for k, want in _flat(jax.device_get(js.params)).items():
                np.testing.assert_allclose(ts.params[k].numpy(), want,
                                           rtol=RTOL, atol=ATOL,
                                           err_msg=f"round {r} {k}")
    recs = {k: [json.loads(line) for line in p.read_text().splitlines()]
            for k, p in logs.items()}
    for a, b in zip(recs["port"], recs["jax"], strict=True):
        assert set(a) == set(b)
        assert {k: a[k] for k in a if k != "ts"} == {
            k: b[k] for k in b if k != "ts"}
    if case == "crash_and_stragglers":
        assert sum(crashed) > 0
        assert max(r["staleness_max"] for r in recs["port"]) >= 2


# -- the server's own contracts ----------------------------------------


def test_async_full_run_replays_bitwise():
    s1, h1, _ = _run()
    s2, h2, _ = _run()
    _assert_same(s1, s2)
    assert [m for m, _ in h1] == [m for m, _ in h2]
    for (_, p1), (_, p2) in zip(h1, h2):
        np.testing.assert_array_equal(p1, p2)


def test_async_buffer_and_staleness_semantics():
    """Cohort 8, buffer 4: two updates a round, nothing left over, and
    pipelined in-flight work arrives stale; the discount changes the
    trajectory. A buffer that does not divide the cohort carries its
    fill across rounds instead of forcing a flush."""
    s1, h1, _ = _run(staleness_decay=1.0)
    assert all(m["updates"] == 2 and m["buffer_fill"] == 0 for m, _ in h1)
    assert h1[-1][0]["staleness_max"] >= 1
    s2, _, _ = _run(staleness_decay=0.5)
    assert any(not torch.equal(s1.params[k], s2.params[k])
               for k in s1.params)
    rf = _async(_pop(tpop), buffer_size=5)
    srv, m0 = rf(_cnn_server(), None, None, None, None, round_idx=0)
    assert m0["updates"] == 1 and m0["buffer_fill"] == 3
    _, m1 = rf(srv, None, None, None, None, round_idx=1)
    assert m1["updates"] == 2 and m1["buffer_fill"] == 1


def test_async_crash_clients_are_refilled():
    plan = tfaults.PopulationFaultPlan(
        64, [tfaults.PopulationFault("crash", fraction=0.25)], seed=2)
    _, h, _ = _run(faults=plan)
    assert all(m["participants"] == C for m, _ in h)   # slots refilled
    assert sum(m["crashed"] for m, _ in h) > 0         # a per-round count
    assert max(m["crashed"] for m, _ in h) < 3 * C
    whole = tfaults.PopulationFaultPlan(
        64, [tfaults.PopulationFault("crash", fraction=1.0)])
    with pytest.raises(RuntimeError, match="crashes \\(nearly\\) the whole"):
        _run(rounds=1, faults=whole)


def test_async_retry_discards_the_failed_attempts_inflight_work():
    """A retried round must not apply updates trained from the discarded
    attempt's server: the pool is reset when the round index stops
    advancing (tests/test_population.py's contract, through the port's
    driver)."""
    rf = _async(_pop(tpop), buffer_size=5)      # 5 !| 8: a partial buffer
    calls = []

    def flaky(server, images, labels, weights, key, *, round_idx=None):
        s, m = rf(server, images, labels, weights, key, round_idx=round_idx)
        calls.append(round_idx)
        if round_idx == 1 and calls.count(1) == 1:
            s = s.replace(params={k: v * float("nan")
                                  for k, v in s.params.items()})
        return s, m

    res = run_rounds(flaky, _cnn_server(), None, None,
                     np.ones((C,), np.float32),
                     config=DriverConfig(rounds=3), seed=1)
    assert (1, "diverged") in [(e["round"], e["status"])
                               for e in res.events]
    assert res.server.round == 3
    assert all(torch.isfinite(v).all() for v in res.server.params.values())
    # round 0 leaves fill 3; the failed round-1 attempt consumes it; the
    # retry runs the reseeded subset (6 of 8) from an EMPTY buffer: 6
    # completions, 1 update, fill 1 (fill 2 would be the discarded
    # attempt's leftover carried over)
    assert res.history[0]["updates"] == 1
    assert res.history[0]["buffer_fill"] == 3
    assert res.history[1]["participants"] == 6
    assert res.history[1]["updates"] == 1
    assert res.history[1]["buffer_fill"] == 1


def test_async_absorbs_straggler_wall_clock():
    """With an injected straggler delay the sync round's wall is the
    barrier (max delay) while the async server processes the fast
    arrivals: real clocks, driven by the injected sleeps."""
    pop = _pop(tpop)
    sampler = tpop.CohortSampler(pop, C, seed=5)
    plan = tfaults.PopulationFaultPlan(
        pop.size, [tfaults.PopulationFault(
            "straggler", clients=(int(sampler.cohort(0)[0]),),
            staleness=2)], delay_unit_s=0.3)
    sync = tpop.make_population_round(
        small_cnn(10, 3, 1), 1e-3, tbce, pop, sampler, wave_size=C,
        batch_size=16, faults=plan, barrier_sleep=True, device="cpu")
    t0 = time.monotonic()
    sync(_cnn_server(), None, None, None, (0,), round_idx=0)
    sync_wall = time.monotonic() - t0
    assert sync_wall >= 0.6, sync_wall            # 2 lag units slept
    rf = _async(pop, faults=plan, realtime=True,
                base_latency_s=(0.001, 0.005))
    srv, _ = rf(_cnn_server(), None, None, None, None, round_idx=0)
    t0 = time.monotonic()
    _, m = rf(srv, None, None, None, None, round_idx=1)
    async_wall = time.monotonic() - t0
    assert m["participants"] == C
    assert async_wall < sync_wall, (async_wall, sync_wall)


def test_async_through_driver_logs_records(tmp_path):
    """Through the driver: healthy rounds, one round_health record each,
    and one async fed_cohort record a round with the frozen key set of
    tests/test_observability.py (the histogram sums to the
    participants)."""
    log = tmp_path / "run.jsonl"
    with JsonlLogger(log) as logger:
        rf = _async(_pop(tpop), logger=logger)
        res = run_rounds(rf, _cnn_server(), None, None,
                         np.ones((C,), np.float32),
                         config=DriverConfig(rounds=2), seed=1,
                         logger=logger)
    assert res.server.round == 2
    assert all(e["status"] == "ok" for e in res.events)
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    assert sum(r["event"] == "round_health" for r in recs) == 2
    cohorts = [r for r in recs if r["event"] == "fed_cohort"]
    assert [r["round"] for r in cohorts] == [0, 1]
    assert set(cohorts[0]) == {"ts", "event", "round", "mode", "population",
                               "cohort", "participants", "buffer",
                               "updates", "staleness_mean", "staleness_max",
                               "staleness_hist"}
    assert cohorts[0]["mode"] == "async"
    assert len(cohorts[0]["staleness_hist"]) == tasync.STALENESS_BUCKETS
    assert sum(cohorts[0]["staleness_hist"]) == cohorts[0]["participants"]
    assert rf.last_participants.shape == (C,)


BUILD = [
    ("trimmed", {"aggregator": ("trimmed_mean", {"trim": 1})}),
    ("median", {"aggregator": ("median", {})}),
    ("buffer", {"buffer_size": 0}),
    ("decay", {"staleness_decay": 1.5}),
    ("never_fill", {"buffer_size": C + 1}),
    ("latency", {"base_latency_s": (0.2, 0.1)}),
    ("plan", {"plan_population": 65}),
]


@pytest.mark.parametrize("case,kw", BUILD, ids=[c for c, _ in BUILD])
def test_async_build_refusals_match_jax(case, kw):
    """Each refused build raises the JAX package's text, and norm_clip
    composes."""

    def build(pkg, robust, faults, model, opt, loss):
        kw2 = {k: v for k, v in kw.items()
               if k not in ("aggregator", "plan_population")}
        kw2.setdefault("buffer_size", 4)
        if "aggregator" in kw:
            name, akw = kw["aggregator"]
            kw2["aggregator"] = robust.get_aggregator(name, **akw)
        if "plan_population" in kw:
            kw2["faults"] = faults.PopulationFaultPlan(kw["plan_population"])
        pop = _pop(pkg[0])
        extra = {"device": "cpu"} if pkg[1] is tasync else {}
        return pkg[1].make_async_round(
            model, opt, loss, pop, pkg[0].CohortSampler(pop, C, seed=5),
            **kw2, **extra)

    with pytest.raises(ValueError) as want:
        build((jpop, jasync), jrobust, jfaults, _jax_seq(), jrmsprop(1e-3),
              jbce)
    with pytest.raises(ValueError) as got:
        build((tpop, tasync), trobust, tfaults, _torch_seq(), 1e-3, tbce)
    assert str(got.value) == str(want.value)
    _async(_pop(tpop), aggregator=trobust.NormClip(1.0))


COMPAT = [
    ("secure", True, None),
    ("trimmed", False, ("trimmed_mean", {"trim": 1})),
    ("median", False, ("median", {})),
    ("norm_clip", False, ("norm_clip", {"max_norm": 1.0})),
]


@pytest.mark.parametrize("case,secure,agg", COMPAT,
                         ids=[c for c, _, _ in COMPAT])
def test_ensure_async_compatible_matches_jax(case, secure, agg):
    """The composition check refuses secure mode, trimmed mean and median
    with the JAX package's text, and lets norm_clip through."""

    def check(pkg, robust):
        a = robust.get_aggregator(agg[0], **agg[1]) if agg else None
        pkg.ensure_async_compatible(secure=secure, aggregator=a)

    if case == "norm_clip":
        check(jasync, jrobust)
        check(tasync, trobust)
        return
    with pytest.raises(ValueError) as want:
        check(jasync, jrobust)
    with pytest.raises(ValueError) as got:
        check(tasync, trobust)
    assert str(got.value) == str(want.value)
