"""The port's population layer (idc_models_tpu_torch/federated/
population.py) against the JAX package's, on the CPU: virtual clients and
cohorts bit for bit, the streamed round within the fed rounds' tolerance,
and the streamed round's own contracts bit for bit (one wave equals the
one-shot round, a crash equals a zeroed mask, replays).

Small size: populations of 8-64, cohorts of 8, shards of 16 at 10x10,
batch 16 (shard == batch, so the per-epoch permutation cannot matter).
Rounds held against JAX train a dropout-free model (the two packages'
client streams differ); the port-only contracts train the small CNN with
its dropout, whose masks come from each client's generator, keyed by its
cohort position. Tolerance against JAX: rtol 1e-5, atol 2e-6, as
tests/test_torch_fedavg.py holds its rounds."""

from __future__ import annotations

import ast
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idc_models_tpu import faults as jfaults
from idc_models_tpu import mesh as meshlib
from idc_models_tpu.federated import fedavg as jfed
from idc_models_tpu.federated import population as jpop
from idc_models_tpu.federated import robust as jrobust
from idc_models_tpu.models import core as jcore
from idc_models_tpu.train import rmsprop as jrmsprop
from idc_models_tpu.train.losses import binary_cross_entropy as jbce
from idc_models_tpu_torch import convert
from idc_models_tpu_torch import faults as tfaults
from idc_models_tpu_torch.federated import (
    DriverConfig, ServerState, make_fedavg_round, run_rounds,
)
from idc_models_tpu_torch.federated import population as tpop
from idc_models_tpu_torch.federated import robust as trobust
from idc_models_tpu_torch.models import core as tcore
from idc_models_tpu_torch.models.small_cnn import small_cnn
from idc_models_tpu_torch.observe import JsonlLogger
from idc_models_tpu_torch.train.checkpoint import restore_checkpoint
from idc_models_tpu_torch.train.losses import binary_cross_entropy as tbce

RTOL, ATOL = 1e-5, 2e-6
C = 8          # cohort size shared by most tests
REPO = Path(__file__).resolve().parent.parent


def _pops(size=64, seed=3, **kw):
    """The same virtual population in both packages."""
    kw.setdefault("examples_per_client", 16)
    kw.setdefault("image_size", 10)
    return (jpop.ClientPopulation(size, seed=seed, **kw),
            tpop.ClientPopulation(size, seed=seed, **kw))


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


def _cnn_server(seed=0):
    model = tcore.init_params(small_cnn(10, 3, 1), seed)
    return model, ServerState.of(model)


def _stream(pop, sampler, wave, model=None, **kw):
    kw.setdefault("batch_size", 16)
    return tpop.make_population_round(
        model if model is not None else small_cnn(10, 3, 1), 1e-3, tbce,
        pop, sampler, wave_size=wave, device="cpu", **kw)


def _assert_same(a: ServerState, b: ServerState):
    for tree_a, tree_b in ((a.params, b.params), (a.state, b.state)):
        assert tree_a.keys() == tree_b.keys()
        for k in tree_a:
            assert torch.equal(tree_a[k], tree_b[k]), k


# -- virtual clients and cohorts, bit for bit against JAX ---------------


@pytest.mark.parametrize("weight_range", [(1.0, 1.0), (8.0, 24.0)])
def test_population_shards_and_weights_match_jax(weight_range):
    jp, tp = _pops(32, weight_range=weight_range)
    for cid in (0, 5, 6, 31):
        (ji, jl), (ti, tl) = jp.shard(cid), tp.shard(cid)
        assert ti.tobytes() == ji.tobytes() and ti.dtype == ji.dtype
        assert tl.tobytes() == jl.tobytes() and tl.dtype == jl.dtype
        assert tp.weight(cid) == jp.weight(cid)
    assert tp.all_weights().tobytes() == jp.all_weights().tobytes()
    assert tp.weight_max == jp.weight_max
    for a, b in zip(tp.materialize([3, 9, 30]), jp.materialize([3, 9, 30])):
        assert a.tobytes() == b.tobytes() and a.dtype == b.dtype
    assert repr(tp) == repr(jp)
    assert tp.same_config(_pops(32, weight_range=weight_range)[1])
    assert not tp.same_config(_pops(32, seed=9,
                                    weight_range=weight_range)[1])
    for bad in (lambda m: m.ClientPopulation(0),
                lambda m: m.ClientPopulation(4, examples_per_client=0),
                lambda m: m.ClientPopulation(4, weight_range=(2.0, 1.0)),
                lambda m: m.ClientPopulation(32).shard(32)):
        with pytest.raises(ValueError) as want:
            bad(jpop)
        with pytest.raises(ValueError) as got:
            bad(tpop)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("weighted", [False, True])
def test_cohort_sampler_matches_jax(weighted):
    """Cohorts over several rounds and the async dispatch stream equal
    the JAX sampler's bit for bit, and a fresh build draws them again."""
    jp, tp = _pops(1000, weight_range=(1.0, 16.0) if weighted
                   else (1.0, 1.0))
    js = jpop.CohortSampler(jp, 64, seed=7, weighted=weighted)
    ts = tpop.CohortSampler(tp, 64, seed=7, weighted=weighted)
    again = tpop.CohortSampler(_pops(1000, weight_range=tp.weight_range)[1],
                               64, seed=7, weighted=weighted)
    for r in range(6):
        ids = ts.cohort(r)
        assert ids.dtype == np.int64 and len(np.unique(ids)) == 64
        assert ids.tobytes() == js.cohort(r).tobytes()
        assert ids.tobytes() == again.cohort(r).tobytes()
    assert ts.cohort(0).tobytes() != ts.cohort(1).tobytes()
    assert [ts.client_at(i) for i in range(32)] == [
        js.client_at(i) for i in range(32)]
    assert repr(ts) == repr(js)
    with pytest.raises(ValueError) as want:
        jpop.CohortSampler(jp, 1001)
    with pytest.raises(ValueError) as got:
        tpop.CohortSampler(tp, 1001)
    assert str(got.value) == str(want.value)


def test_weighted_sampler_biases_toward_heavy_clients():
    _, pop = _pops(32, weight_range=(1.0, 16.0))
    s = tpop.CohortSampler(pop, 8, seed=5, weighted=True)
    counts = np.zeros(32)
    for r in range(150):
        counts[s.cohort(r)] += 1
    w = pop.all_weights()
    heavy = counts[w >= np.percentile(w, 75)].mean()
    light = counts[w <= np.percentile(w, 25)].mean()
    assert heavy > 1.5 * light, (heavy, light)


# -- the streamed round against JAX, with the rounds' tolerance ---------


ROUNDS = [("mean", 1), ("mean", 2), ("norm_clip", 1), ("norm_clip", 2)]


@pytest.mark.parametrize("aggregator,waves", ROUNDS,
                         ids=[f"{a}-{w}wave" for a, w in ROUNDS])
def test_population_round_matches_jax(aggregator, waves):
    """Two streamed rounds of both packages from the same weights, on
    the same sampled cohorts with varied client weights: the aggregates
    and every metric agree."""
    jp, tp = _pops(64, weight_range=(8.0, 24.0))
    jmodel, tmodel = _jax_seq(), _torch_seq()
    v = jmodel.init(jax.random.key(0))
    convert.load_jax(tmodel, v.params, v.state)
    agg_kw = {"max_norm": 0.01} if aggregator == "norm_clip" else {}
    jround = jpop.make_population_round(
        jmodel, jrmsprop(1e-3), jbce, meshlib.client_mesh(1), jp,
        jpop.CohortSampler(jp, C, seed=5), wave_size=C // waves,
        batch_size=16,
        aggregator=jrobust.get_aggregator(aggregator, **agg_kw))
    tround = tpop.make_population_round(
        tmodel, 1e-3, tbce, tp, tpop.CohortSampler(tp, C, seed=5),
        wave_size=C // waves, batch_size=16,
        aggregator=trobust.get_aggregator(aggregator, **agg_kw),
        device="cpu")
    js = jfed.ServerState(jnp.zeros((), jnp.int32), v.params, v.state)
    ts = ServerState.of(tmodel)
    for r in range(2):
        js, jm = jround(js, None, None, None, jax.random.key(r + 1),
                        round_idx=r)
        ts, tm = tround(ts, None, None, None, (1, r, 0), round_idx=r)
        jm = {k: float(x) for k, x in jax.device_get(jm).items()}
        assert set(tm) == set(jm), (set(tm), set(jm))
        for k, want in _flat(jax.device_get(js.params)).items():
            np.testing.assert_allclose(ts.params[k].numpy(), want,
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"round {r} {k}")
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=RTOL)
        for k in set(jm) - {"loss"}:
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-6, err_msg=k)
        assert tm["waves"] == waves and tm["participants"] == C
    if aggregator == "norm_clip":
        assert tm["clients_clipped"] >= 1.0


# -- the streamed round's own contracts, bit for bit on the CPU ----------


def test_one_wave_equals_fedavg_round_bitwise():
    """A wave covering the cohort runs the one-shot round's code: the
    server and the metrics equal make_fedavg_round's on the materialized
    cohort, bit for bit (dropout masks included: each client's generator
    is keyed by its cohort position in both)."""
    _, pop = _pops(weight_range=(8.0, 24.0))
    sampler = tpop.CohortSampler(pop, C, seed=5)
    imgs, labels, w = pop.materialize(sampler.cohort(0))
    model, server = _cnn_server()
    oneshot = make_fedavg_round(model, 1e-3, tbce, batch_size=16,
                                device="cpu")
    s1, m1 = oneshot(server, imgs, labels, w, (7, 0, 0))
    s2, m2 = _stream(pop, sampler, C)(server, None, None, None, (7, 0, 0),
                                      round_idx=0)
    _assert_same(s1, s2)
    assert m2 == {**m1, "cohort": C, "participants": C, "waves": 1}


def test_norm_clip_streamed_equals_one_shot_bitwise():
    _, pop = _pops()
    sampler = tpop.CohortSampler(pop, C, seed=5)
    imgs, labels, w = pop.materialize(sampler.cohort(0))
    model, server = _cnn_server()
    clip = trobust.NormClip(0.05)
    oneshot = make_fedavg_round(model, 1e-3, tbce, batch_size=16,
                                aggregator=clip, device="cpu")
    s1, m1 = oneshot(server, imgs, labels, w, (9, 0, 0))
    s2, m2 = _stream(pop, sampler, C, aggregator=clip)(
        server, None, None, None, (9, 0, 0), round_idx=0)
    _assert_same(s1, s2)
    assert m1["clients_clipped"] == m2["clients_clipped"] >= 1.0
    assert m1["loss"] == m2["loss"]


def test_crash_equals_zeroed_mask_bitwise():
    """A population-plan crash on a cohort member equals zeroing its
    participation mask, bit for bit (the JAX reference misses this
    contract by XLA's summation order: ROADMAP Queue C)."""
    _, pop = _pops()
    sampler = tpop.CohortSampler(pop, C, seed=5)
    ids = sampler.cohort(0)
    plan = tfaults.PopulationFaultPlan(pop.size, [
        tfaults.PopulationFault("crash", clients=(int(ids[3]),))])
    _, server = _cnn_server()
    s_f, m_f = _stream(pop, sampler, C, faults=plan)(
        server, None, None, None, (5, 0, 0), round_idx=0)
    mask = np.ones((C,), np.float32)
    mask[3] = 0.0
    s_m, m_m = _stream(pop, sampler, C)(server, None, None, mask,
                                        (5, 0, 0), round_idx=0)
    _assert_same(s_f, s_m)
    assert m_f["clients_dropped"] == 0.0      # a crash is not divergence
    assert m_f["loss"] == m_m["loss"]
    assert m_f["participants"] == C and m_m["participants"] == C - 1


def test_multiwave_is_close_and_replays_bitwise():
    """Four waves only reorder the additions: close to the one-wave
    round, and bit for bit the same on a fresh build (the round is a
    pure function of (seed, round))."""
    _, pop = _pops()
    _, server = _cnn_server()
    one, _ = _stream(pop, tpop.CohortSampler(pop, C, seed=5), C)(
        server, None, None, None, (7, 0, 0), round_idx=0)
    runs = [_stream(pop, tpop.CohortSampler(pop, C, seed=5), C // 4)(
        server, None, None, None, (7, 0, 0), round_idx=0)
        for _ in range(2)]
    (four, m4), (again, _) = runs
    assert m4["waves"] == 4
    _assert_same(four, again)
    for k, v in one.params.items():
        np.testing.assert_allclose(four.params[k].numpy(), v.numpy(),
                                   rtol=2e-5, atol=2e-6)


def test_trimmed_mean_runs_per_wave():
    """Under two x1000 sign-flippers in the cohort, the per-wave trimmed
    round stays near the honest one while the streamed mean is steered
    far away; a wave too small to keep a value is refused at build."""
    _, pop = _pops()
    sampler = tpop.CohortSampler(pop, C, seed=5)
    ids = sampler.cohort(0)
    plan = tfaults.PopulationFaultPlan(pop.size, [
        tfaults.PopulationFault("sign_flip", clients=tuple(ids[:2]),
                                scale=1000.0)])
    _, server = _cnn_server()

    def run(agg, faults, wave=C):
        s, m = _stream(pop, sampler, wave, aggregator=agg, faults=faults)(
            server, None, None, None, (3, 0, 0), round_idx=0)
        return s.params, m

    honest, _ = run(None, None)
    mean, _ = run(None, plan)
    trim, mt = run(trobust.TrimmedMean(trim=2), plan)
    d_mean = max(float((mean[k] - honest[k]).abs().max()) for k in honest)
    d_trim = max(float((trim[k] - honest[k]).abs().max()) for k in honest)
    assert all(torch.isfinite(v).all() for v in trim.values())
    assert d_mean > 10 * d_trim, (d_mean, d_trim)
    assert mt["trim_degenerate"] == 0.0 and mt["clients_trimmed"] >= 2.0
    # two waves of 4 under trim 1: each wave trims its own extremes
    two, m2 = run(trobust.TrimmedMean(trim=1), plan, wave=C // 2)
    assert m2["waves"] == 2 and m2["degenerate_waves"] == 0.0
    assert all(torch.isfinite(v).all() for v in two.values())


BUILD_ERRORS = [
    ("median", {"wave": 4, "aggregator": "median"}),
    ("trim", {"wave": 4, "aggregator": ("trimmed_mean", 2)}),
    ("divide", {"wave": 3}),
    ("population", {"wave": 4, "other_population": True}),
    ("faults", {"wave": 4, "plan_population": 65}),
]


@pytest.mark.parametrize("case,kw", BUILD_ERRORS,
                         ids=[c for c, _ in BUILD_ERRORS])
def test_build_teaching_errors_match_jax(case, kw):
    """The streamed round's build refusals carry the JAX package's text."""
    jp, tp = _pops()

    def build(pkg, pop, sampler_pop):
        agg = kw.get("aggregator")
        if isinstance(agg, tuple):
            agg = pkg["robust"].get_aggregator(agg[0], trim=agg[1])
        elif agg is not None:
            agg = pkg["robust"].get_aggregator(agg)
        plan = (pkg["faults"].PopulationFaultPlan(kw["plan_population"])
                if "plan_population" in kw else None)
        return pkg["make"](pop, pkg["pop"].CohortSampler(sampler_pop, C,
                                                         seed=5),
                           kw["wave"], agg, plan)

    jax_pkg = {"robust": jrobust, "faults": jfaults, "pop": jpop,
               "make": lambda p, s, w, a, f: jpop.make_population_round(
                   _jax_seq(), jrmsprop(1e-3), jbce, meshlib.client_mesh(1),
                   p, s, wave_size=w, aggregator=a, faults=f)}
    port_pkg = {"robust": trobust, "faults": tfaults, "pop": tpop,
                "make": lambda p, s, w, a, f: tpop.make_population_round(
                    _torch_seq(), 1e-3, tbce, p, s, wave_size=w,
                    aggregator=a, faults=f, device="cpu")}
    other = kw.get("other_population", False)
    with pytest.raises(ValueError) as want:
        build(jax_pkg, jp, _pops(seed=4)[0] if other else jp)
    with pytest.raises(ValueError) as got:
        build(port_pkg, tp, _pops(seed=4)[1] if other else tp)
    assert str(got.value) == str(want.value)


def test_participation_mask_shape_is_checked():
    _, pop = _pops()
    rnd = _stream(pop, tpop.CohortSampler(pop, C, seed=5), 4)
    with pytest.raises(ValueError, match="participation mask"):
        rnd(_cnn_server()[1], None, None, np.ones(5, np.float32), (0,),
            round_idx=0)


def test_straggler_replays_the_stale_server():
    """Every client a lag-2 straggler: each reports the server of round
    r - 2, or the oldest one kept (round 0's) on rounds 0 and 1, so three
    rounds leave the round-0 server in place, up to the rounding of a
    weighted mean of equal values."""
    _, pop = _pops(8)
    sampler = tpop.CohortSampler(pop, 8, seed=5)      # cohort == population
    plan = tfaults.PopulationFaultPlan(8, [
        tfaults.PopulationFault("straggler", fraction=1.0, staleness=2)])
    rnd = _stream(pop, sampler, 4, faults=plan)
    _, s0 = _cnn_server()
    s = s0
    for r in range(3):
        s, m = rnd(s, None, None, None, (1, r, 0), round_idx=r)
        assert m["clients_dropped"] == 0.0
        for k, v in s0.params.items():
            torch.testing.assert_close(s.params[k], v, rtol=1e-6,
                                       atol=1e-7)


def test_checkpoint_resume_through_the_driver(tmp_path):
    """The sampler is a pure function of (seed, round): a run cut at
    round 2 and resumed from its checkpoint with fresh rounds ends on
    the uninterrupted run's server, bit for bit."""
    _, pop = _pops()

    def make_round():
        p = tpop.ClientPopulation(64, examples_per_client=16, image_size=10,
                                  seed=3)
        return _stream(p, tpop.CohortSampler(p, C, seed=5), 4)

    w = np.ones((C,), np.float32)
    _, start = _cnn_server()
    full = run_rounds(make_round(), start, None, None, w,
                      config=DriverConfig(rounds=4), seed=1)
    path = tmp_path / "server"
    run_rounds(make_round(), start, None, None, w,
               config=DriverConfig(rounds=2, checkpoint_path=path,
                                   checkpoint_every=2), seed=1)
    restored = ServerState.from_tree(restore_checkpoint(
        path, _cnn_server(9)[1].tree()))
    assert restored.round == 2
    resumed = run_rounds(make_round(), restored, None, None, w,
                         config=DriverConfig(rounds=4), seed=1)
    assert [h["round"] for h in resumed.history] == [2, 3]
    _assert_same(full.server, resumed.server)


def test_fed_cohort_records_and_retries_log_once(tmp_path):
    """One sync fed_cohort record a round, with the frozen key set of
    tests/test_observability.py; a re-run of a round (a driver retry)
    and a round at or below log_from_round do not log."""
    _, pop = _pops()
    log = tmp_path / "run.jsonl"
    with JsonlLogger(log) as logger:
        rnd = _stream(pop, tpop.CohortSampler(pop, C, seed=5), 4,
                      logger=logger, log_from_round=0)
        srv = _cnn_server()[1]
        for r in (0, 1, 1, 2):
            rnd(srv, None, None, None, (0, r, 0), round_idx=r)
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["round"] for r in recs] == [1, 2]
    assert set(recs[0]) == {"ts", "event", "round", "mode", "population",
                            "cohort", "participants", "waves", "wave_size"}
    assert (recs[0]["event"], recs[0]["mode"], recs[0]["waves"],
            recs[0]["wave_size"], recs[0]["population"]) == (
        "fed_cohort", "sync", 2, 4, 64)


# -- no O(population) allocation (tests/test_static_robustness.py's scan,
# copied: that file scans the JAX package) -------------------------------

_POP_ALLOC_CALLS = {"zeros", "ones", "full", "empty", "arange"}
_POP_COUNT_NAMES = {"n_population", "population_size"}
_POP_OWNER_NAMES = {"self", "population", "pop"}
POPULATION_ALLOC_ALLOWLIST = {
    ("idc_models_tpu_torch/federated/population.py", "all_weights"):
        "the one deliberately O(population) helper, for tests",
}


def _mentions_population_count(node) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id in _POP_COUNT_NAMES:
            return True
        if isinstance(sub, ast.Attribute) and sub.attr == "size":
            v = sub.value
            if isinstance(v, ast.Name) and v.id in _POP_OWNER_NAMES:
                return True
            if isinstance(v, ast.Attribute) and v.attr == "population":
                return True
    return False


def _scan_population_allocs(path: Path):
    rel = path.relative_to(REPO).as_posix()
    violations, live = [], set()

    def walk(node, stack):
        for child in ast.iter_child_nodes(node):
            what = None
            if (isinstance(child, ast.Call)
                    and isinstance(child.func, ast.Attribute)
                    and child.func.attr in _POP_ALLOC_CALLS
                    and any(_mentions_population_count(a)
                            for a in list(child.args)
                            + [kw.value for kw in child.keywords])):
                what = child.func.attr
            if (isinstance(child, (ast.ListComp, ast.SetComp, ast.DictComp))
                    and any(_mentions_population_count(g.iter)
                            for g in child.generators)):
                what = "comprehension"
            if what is not None:
                key = (rel, ".".join(
                    n.name for n in stack
                    if isinstance(n, (ast.FunctionDef,
                                      ast.AsyncFunctionDef))) or "<module>")
                live.add(key)
                if key not in POPULATION_ALLOC_ALLOWLIST:
                    violations.append((rel, child.lineno, what, key[1]))
            walk(child, stack + [child])

    walk(ast.parse(path.read_text(), filename=str(path)), [])
    return violations, live


def test_no_population_sized_allocations_in_the_port():
    violations, live = [], set()
    for name in ("population.py", "async_fedavg.py"):
        v, lv = _scan_population_allocs(
            REPO / "idc_models_tpu_torch" / "federated" / name)
        violations += v
        live |= lv
    assert not violations, (
        f"population-count-shaped allocation in the population layer: "
        f"{violations}")
    assert live == set(POPULATION_ALLOC_ALLOWLIST), live
