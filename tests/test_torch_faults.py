"""The port's fault plans (idc_models_tpu_torch/faults.py) against the JAX
package's faults.py, on the CPU: the same grammar, codes, scales,
staleness and error text, and apply_faults on the same stacked trees."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idc_models_tpu import faults as jfaults
from idc_models_tpu_torch import faults as tfaults

SPECS = [
    "crash:3",
    "sign_flip:0-2:x1000,crash:5",
    "scale:1+4:100",
    "straggler:3:2",
    "straggler:0-1",
    "nan:2,inf:6,scale:7:0.5",
    "sign_flip:4, crash:4",            # the last fault for a client wins
    " crash:0 ,, nan:1 ",
]


@pytest.mark.parametrize("spec", SPECS)
def test_parsed_plans_match_jax(spec):
    jp, tp = jfaults.parse_fault_spec(spec, 8), tfaults.parse_fault_spec(
        spec, 8)
    assert [dataclass_tuple(f) for f in tp.faults] == [
        dataclass_tuple(f) for f in jp.faults]
    assert tp.max_staleness == jp.max_staleness
    for r in range(6):
        (tc, ts), (jc, js) = tp.codes(r), jp.codes(r)
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(ts, js)
        assert tc.dtype == jc.dtype and ts.dtype == js.dtype
        assert tp.staleness(r) == jp.staleness(r)
    assert repr(tp) == repr(jp)


def dataclass_tuple(f):
    return (f.kind, f.client, f.rounds, f.scale, f.staleness)


def test_codes_kind_of_and_byzantine_match_jax():
    assert (tfaults.OK, tfaults.CRASH, tfaults.STRAGGLER, tfaults.NAN,
            tfaults.INF, tfaults.SCALE, tfaults.SIGN_FLIP) == (
        jfaults.OK, jfaults.CRASH, jfaults.STRAGGLER, jfaults.NAN,
        jfaults.INF, jfaults.SCALE, jfaults.SIGN_FLIP)
    assert tfaults.KINDS == jfaults.KINDS
    for code in range(-1, 8):
        assert tfaults.kind_of(code) == jfaults.kind_of(code)
    for seed in range(3):
        tp = tfaults.FaultPlan.byzantine(10, 3, kind="scale", scale=4.0,
                                         seed=seed, rounds=(1, 3))
        jp = jfaults.FaultPlan.byzantine(10, 3, kind="scale", scale=4.0,
                                         seed=seed, rounds=(1, 3))
        assert repr(tp) == repr(jp)
        for r in range(5):
            np.testing.assert_array_equal(tp.codes(r)[0], jp.codes(r)[0])


BAD_SPECS = ["meteor:1", "crash", "crash:1:2", "scale:1:big", "crash:a-b",
             "straggler:1:x", "crash:1:2:3", "crash:9", "scale:1:inf",
             "straggler:1:0", "straggler:0:1,straggler:1:2", "crash:-1"]


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_specs_give_the_jax_messages(spec):
    with pytest.raises(ValueError) as want:
        jfaults.parse_fault_spec(spec, 8)
    with pytest.raises(ValueError) as got:
        tfaults.parse_fault_spec(spec, 8)
    assert str(got.value) == str(want.value)


def test_format_spec_error_and_parse_id_field_match_jax():
    assert tfaults.GRAMMAR == jfaults.GRAMMAR
    assert (tfaults.format_spec_error("g", "d", kinds=("a",), grammar="x")
            == jfaults.format_spec_error("g", "d", kinds=("a",),
                                         grammar="x"))
    for field in ("3", "1-4", "0+2+5"):
        assert (tfaults.parse_id_field(field, what="ticks", group="g")
                == jfaults.parse_id_field(field, what="ticks", group="g"))


def test_apply_faults_matches_jax():
    """Every fault code on one stacked tree (float params and state, an
    int leaf that passes through), against the JAX function."""
    rng = np.random.default_rng(0)
    k = 7
    codes = np.arange(k, dtype=np.int32)          # OK, CRASH, ..., SIGN_FLIP
    scales = rng.uniform(0.5, 3.0, k).astype(np.float32)
    weight = rng.uniform(1, 5, k).astype(np.float32)
    server_p = {"w": rng.normal(size=(3, 4)).astype(np.float32),
                "n": np.arange(4, dtype=np.int32)}
    server_s = {"m": rng.normal(size=(4,)).astype(np.float32)}
    stale_p = {"w": rng.normal(size=(3, 4)).astype(np.float32),
               "n": np.arange(4, dtype=np.int32) + 1}
    stale_s = {"m": rng.normal(size=(4,)).astype(np.float32)}
    new_p = {"w": rng.normal(size=(k, 3, 4)).astype(np.float32),
             "n": np.tile(np.arange(4, dtype=np.int32) * 2, (k, 1))}
    new_s = {"m": rng.normal(size=(k, 4)).astype(np.float32)}
    jw = jax.device_get(jfaults.apply_faults(
        jnp.asarray(codes), jnp.asarray(scales), new_p, new_s,
        jnp.asarray(weight), server_p, server_s, stale_p, stale_s))

    def t(tree):
        return {n: torch.from_numpy(v) for n, v in tree.items()}

    got = tfaults.apply_faults(
        torch.from_numpy(codes), torch.from_numpy(scales), t(new_p),
        t(new_s), torch.from_numpy(weight), t(server_p), t(server_s),
        t(stale_p), t(stale_s))
    for g, w in zip(got[:2], jw[:2]):
        for n in w:
            np.testing.assert_allclose(g[n].numpy(), np.asarray(w[n]),
                                       rtol=1e-6, err_msg=n)
            assert g[n].numpy().dtype == np.asarray(w[n]).dtype
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(jw[2]))
    assert got[2][tfaults.CRASH] == 0.0
    assert torch.equal(got[0]["n"], torch.from_numpy(new_p["n"]))


# -- population plans (federated/population.py scale) --------------------

POP_SPECS = [
    ("straggler:3-6:2@c97,c4012", 10000, {"delay_unit_s": 0.25}),
    ("crash:2:10%", 1000, {"seed": 4}),
    ("crash:*:10%,straggler:*:20%", 1000, {"seed": 4,
                                           "delay_unit_s": 0.1}),
    ("sign_flip:*:x1000@c5", 100, {}),
    ("scale:0+2:50@c3,c7, nan:1@c7", 100, {}),
    ("inf:0-4:5%,straggler:2:3@c11", 100, {"seed": 9, "delay_unit_s": 1}),
]


def _pop_fault_tuple(f):
    return (f.kind, f.rounds, f.clients, f.fraction, f.scale, f.staleness)


@pytest.mark.parametrize("spec,population,kw", POP_SPECS,
                         ids=[s for s, _, _ in POP_SPECS])
def test_population_plans_match_jax(spec, population, kw):
    """Codes, scales, staleness and delays over cohorts of virtual ids,
    round by round, equal the JAX plan's bit for bit (fractions are
    seeded numpy draws in both)."""
    jp = jfaults.parse_population_fault_spec(spec, population, **kw)
    tp = tfaults.parse_population_fault_spec(spec, population, **kw)
    assert [_pop_fault_tuple(f) for f in tp.faults] == [
        _pop_fault_tuple(f) for f in jp.faults]
    assert repr(tp) == repr(jp)
    assert tp.max_staleness == jp.max_staleness
    rng = np.random.default_rng(0)
    cohorts = [np.sort(rng.choice(population, 64, replace=False))
               for _ in range(3)] + [np.array([3, 5, 7, 11, 97, 4012])
                                     % population]
    for r in range(8):
        assert tp.staleness(r) == jp.staleness(r)
        for ids in cohorts:
            (tc, ts), (jc, js) = tp.codes_for(r, ids), jp.codes_for(r, ids)
            np.testing.assert_array_equal(tc, jc)
            np.testing.assert_array_equal(ts, js)
            assert tc.dtype == jc.dtype and ts.dtype == js.dtype
            td, jd = tp.delay_s(r, ids), jp.delay_s(r, ids)
            np.testing.assert_array_equal(td, jd)
            assert td.dtype == jd.dtype


POP_BAD = ["meteor:2:5%", "crash:2:0.5", "crash:2", "crash:one:5%",
           "crash:2:200%", "straggler:1:2@d4", "sign_flip:1:x3",
           "crash:2:5%@c1", "crash:1@c150", "scale:1:xx@c1",
           "straggler:1:two@c1", "crash:1:2:3@c1", "crash:1:abc%"]


@pytest.mark.parametrize("spec", POP_BAD)
def test_population_parse_errors_match_jax(spec):
    """Every bad population spec raises the JAX package's text."""
    with pytest.raises(ValueError) as want:
        jfaults.parse_population_fault_spec(spec, 100)
    with pytest.raises(ValueError) as got:
        tfaults.parse_population_fault_spec(spec, 100)
    assert str(got.value) == str(want.value)


def test_population_fault_construction_errors_match_jax():
    cases = [
        lambda f: f.PopulationFaultPlan(10, [
            f.PopulationFault("straggler", clients=(1,), staleness=1),
            f.PopulationFault("straggler", clients=(2,), staleness=3)]),
        lambda f: f.PopulationFault("crash"),
        lambda f: f.PopulationFault("crash", clients=(1,), fraction=0.5),
        lambda f: f.PopulationFault("crash", clients=()),
        lambda f: f.PopulationFault("crash", fraction=1.5),
        lambda f: f.PopulationFault("scale", clients=(1,),
                                    scale=float("inf")),
        lambda f: f.PopulationFaultPlan(0),
        lambda f: f.PopulationFaultPlan(5, delay_unit_s=-1.0),
    ]
    for make in cases:
        with pytest.raises(ValueError) as want:
            make(jfaults)
        with pytest.raises(ValueError) as got:
            make(tfaults)
        assert str(got.value) == str(want.value)


def test_flaky_reads_and_retries_match_jax():
    """The transient-read hooks fail on the JAX package's call indices
    for the same seed; with_retries absorbs transient failures and
    re-raises persistent ones."""

    def schedule(lib, seed, rate):
        f = lib.flaky(lambda i: i * 2, failure_rate=rate, seed=seed)
        out = []
        for i in range(40):
            try:
                out.append(f(i))
            except lib.TransientReadError:
                out.append(None)
        return out

    for seed, rate in ((3, 0.5), (1, 0.3), (0, 0.0)):
        assert schedule(tfaults, seed, rate) == schedule(jfaults, seed, rate)
    assert None in schedule(tfaults, 3, 0.5)
    robust = tfaults.with_retries(
        tfaults.flaky(lambda i: i * 2, failure_rate=0.3, seed=1),
        attempts=30)
    assert [robust(i) for i in range(10)] == [i * 2 for i in range(10)]
    always = tfaults.flaky(lambda i: i, failure_rate=1.0, seed=0)
    with pytest.raises(tfaults.TransientReadError,
                       match="injected transient read failure"):
        tfaults.with_retries(always, attempts=3)(0)
    for bad in (lambda f: f.flaky(len, failure_rate=1.5),
                lambda f: f.with_retries(len, attempts=0)):
        with pytest.raises(ValueError) as want:
            bad(jfaults)
        with pytest.raises(ValueError) as got:
            bad(tfaults)
        assert str(got.value) == str(want.value)
