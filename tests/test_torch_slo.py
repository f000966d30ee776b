"""The port's SLO engine (idc_models_tpu_torch/observe/slo.py) against
the JAX package's: the same declarations, the same observation stream
under a fake clock, the same alerts, burn-rate gauges and jsonl events;
and the port's federated driver feeding it (tests/test_slo.py)."""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idc_models_tpu import faults as jfaults
from idc_models_tpu import observe as jobs
from idc_models_tpu.federated import driver as jdriver
from idc_models_tpu.federated.fedavg import ServerState as JServer
from idc_models_tpu_torch import faults as tfaults
from idc_models_tpu_torch import observe as tobs
from idc_models_tpu_torch.federated import driver as tdriver
from idc_models_tpu_torch.federated.fedavg import ServerState as TServer

PKGS = {"jax": jobs, "torch": tobs}


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _engine(pkg, slos, clock, **kw):
    kw.setdefault("short_window_s", 10.0)
    kw.setdefault("long_window_s", 50.0)
    kw.setdefault("min_samples", 5)
    return pkg.SLOEngine(slos, clock=clock,
                         registry=kw.pop("registry", pkg.MetricsRegistry()),
                         **kw)


def _strip(alerts):
    return [{k: v for k, v in a.items() if k != "ts"} for a in alerts]


def _both(scenario):
    """Run `scenario(pkg)` on each package; the results must be equal."""
    out = {name: scenario(pkg) for name, pkg in PKGS.items()}
    assert out["torch"] == out["jax"]
    return out["torch"]


def test_slo_declarations_validate_alike():
    def scenario(pkg):
        SLO = pkg.SLO
        s = SLO.latency("ttft", threshold_s=0.2, percentile=95.0)
        errors = []
        for bad in (lambda: SLO.latency("x", threshold_s=0.0),
                    lambda: SLO.latency("x", threshold_s=0.1,
                                        percentile=100.0),
                    lambda: SLO.rate("x", budget=1.5),
                    lambda: SLO(name="x", kind="weird", budget=0.5),
                    lambda: _engine(pkg, [], FakeClock()),
                    lambda: _engine(pkg, [SLO.rate("a", budget=0.1),
                                          SLO.rate("a", budget=0.2)],
                                    FakeClock()),
                    lambda: pkg.SLOEngine([SLO.rate("a", budget=0.1)],
                                          short_window_s=60,
                                          long_window_s=30)):
            with pytest.raises(ValueError) as e:
                bad()
            errors.append(str(e.value))
        return round(s.budget, 12), SLO.rate("err", budget=0.01).budget, errors

    budget, rate, _ = _both(scenario)
    assert budget == pytest.approx(0.05) and rate == 0.01


def test_kind_mismatch_and_unknown_names_are_loud_alike():
    def scenario(pkg):
        eng = _engine(pkg, [pkg.SLO.latency("ttft", threshold_s=0.1)],
                      FakeClock())
        msgs = []
        for bad in (lambda: eng.record("ttft", ok=True),
                    lambda: eng.observe("nope", 0.1),
                    lambda: eng.breached("nope")):
            with pytest.raises(ValueError) as e:
                bad()
            msgs.append(str(e.value))
        return eng.has("ttft"), eng.has("nope"), msgs

    assert _both(scenario)[:2] == (True, False)


def test_burn_rate_is_bad_fraction_over_budget_alike():
    def scenario(pkg):
        clock, reg = FakeClock(), pkg.MetricsRegistry()
        eng = _engine(pkg, [pkg.SLO.latency("ttft", threshold_s=0.1,
                                            percentile=90.0)],
                      clock, registry=reg)
        for i in range(20):
            clock.t += 0.1
            eng.observe("ttft", 0.5 if i % 5 == 0 else 0.01)
        eng.evaluate()
        g = reg.gauge("slo_burn_rate", labels=("slo", "window"))
        return (g.value(slo="ttft", window="short"),
                g.value(slo="ttft", window="long"), reg.prometheus_text())

    short, long, _ = _both(scenario)
    assert short == pytest.approx(2.0) and long == pytest.approx(2.0)


def test_samples_age_out_of_the_windows_alike():
    def scenario(pkg):
        clock, reg = FakeClock(), pkg.MetricsRegistry()
        eng = _engine(pkg, [pkg.SLO.rate("err", budget=0.5)], clock,
                      registry=reg)
        g = reg.gauge("slo_burn_rate", labels=("slo", "window"))
        seen = []
        for _ in range(10):
            clock.t += 0.1
            eng.record("err", ok=False)
        for jump in (0.0, 20.0, 100.0):
            clock.t += jump
            eng.evaluate()
            seen.append((g.value(slo="err", window="short"),
                         g.value(slo="err", window="long")))
        return seen

    seen = _both(scenario)
    assert seen[0] == (pytest.approx(2.0), pytest.approx(2.0))
    assert seen[1][0] == 0.0 and seen[2] == (0.0, 0.0)


def test_alert_needs_both_windows_and_min_samples_alike():
    def scenario(pkg):
        clock = FakeClock()
        eng = _engine(pkg, [pkg.SLO.rate("err", budget=0.05)], clock,
                      min_samples=8)
        out = []
        for n in (4, 6, 0):
            for _ in range(n):
                clock.t += 0.5
                eng.record("err", ok=False)
            out.append((_strip(eng.evaluate()), eng.breached("err")))
        return out, _strip(eng.alerts)

    steps, alerts = _both(scenario)
    assert steps[0] == ([], False) and steps[2] == ([], True)
    assert [a["slo"] for a in steps[1][0]] == ["err"]
    assert len(alerts) == 1


def test_alert_resolves_and_can_refire_alike(tmp_path):
    def scenario(pkg):
        clock, reg = FakeClock(), pkg.MetricsRegistry()
        log = tmp_path / f"{pkg.__name__}.jsonl"
        with pkg.JsonlLogger(log) as logger:
            eng = _engine(pkg, [pkg.SLO.rate("err", budget=0.05)], clock,
                          logger=logger, registry=reg)
            states = []
            for n, ok in ((10, False), (400, True), (60, False)):
                for _ in range(n):
                    clock.t += 0.1
                    eng.record("err", ok=ok)
                eng.evaluate()
                states.append(eng.breached("err"))
        recs = [json.loads(line) for line in open(log)]
        return (states, [{k: v for k, v in r.items() if k != "ts"}
                         for r in recs],
                reg.counter("slo_alerts_total",
                            labels=("slo",)).value(slo="err"),
                eng.state_doc())

    states, recs, alerts, _ = _both(scenario)
    assert states == [True, False, True] and alerts == 2
    events = [r["event"] for r in recs]
    assert events.count("slo_alert") == 2
    assert events.count("slo_resolved") == 1


def _torch_round_fn(diverge_every):
    calls = {"n": 0}

    def round_fn(server, images, labels, weights, key):
        calls["n"] += 1
        bad = diverge_every and calls["n"] % diverge_every == 1
        return (server.replace(round=server.round + 1),
                {"loss": torch.tensor(float("nan") if bad else 0.5),
                 "accuracy": torch.tensor(0.9),
                 "clients_dropped": torch.tensor(0)})

    return round_fn


def _jax_round_fn(diverge_every):
    calls = {"n": 0}

    def round_fn(server, images, labels, weights, rng):
        calls["n"] += 1
        bad = diverge_every and calls["n"] % diverge_every == 1
        return (JServer(round=server.round + 1, params=server.params,
                        model_state=server.model_state),
                {"loss": jnp.float32(float("nan") if bad else 0.5),
                 "accuracy": jnp.float32(0.9),
                 "clients_dropped": jnp.int32(0)})

    return round_fn


def _fed_run(side, diverge_every, slo, *, plan_spec=None, rounds=4,
             tracer=None):
    """The same four-client driver run through each package's driver:
    a round function that diverges on every `diverge_every`-th call."""
    if side == "torch":
        pkg, driver = tobs, tdriver
        plan = (tfaults.parse_fault_spec(plan_spec, 4) if plan_spec
                else None)
        server = TServer(0, {"w": torch.ones(2)}, {})
        fn = _torch_round_fn(diverge_every)
    else:
        pkg, driver = jobs, jdriver
        plan = (jfaults.parse_fault_spec(plan_spec, 4) if plan_spec
                else None)
        server = JServer(round=jnp.zeros((), jnp.int32),
                         params={"w": jnp.ones((2,))}, model_state={})
        fn = _jax_round_fn(diverge_every)
    prev = pkg.trace.set_tracer(tracer)
    try:
        return driver.run_rounds(
            fn, server, None, None, np.ones(4, np.float32),
            config=driver.DriverConfig(rounds=rounds, max_attempts=3),
            slo=slo, fault_plan=plan)
    finally:
        pkg.trace.set_tracer(prev)


@pytest.mark.parametrize("diverge_every", [2, 0],
                         ids=["faulted", "clean"])
def test_fed_driver_slo_alerts_under_fault_plan_and_not_clean(
        diverge_every):
    """The port's driver feeds the round-failure-rate SLO as the JAX
    driver does: a run whose first attempt of each round diverges
    alerts, the clean run stays silent, with identical alerts and
    round_health statuses."""
    out = {}
    for side, pkg in PKGS.items():
        eng = _engine(pkg, [pkg.SLO.rate("round_failure_rate",
                                         budget=0.05)],
                      FakeClock(), min_samples=3)
        res = _fed_run(side, diverge_every, eng,
                       plan_spec="nan:0-2" if diverge_every else None)
        out[side] = (_strip(eng.alerts),
                     [(e["round"], e["attempt"], e["status"])
                      for e in res.events])
    assert out["torch"] == out["jax"]
    want = ["round_failure_rate"] if diverge_every else []
    assert [a["slo"] for a in out["torch"][0]] == want


def test_fed_client_spans_carry_fault_outcomes_alike():
    """Each attempt's fed.round span holds one fed.client marker per
    participant with the plan's fault outcome, in both drivers."""
    spec = "sign_flip:0-1:x1000,crash:2"
    out = {}
    for side, pkg in PKGS.items():
        tr = pkg.trace.Tracer()
        _fed_run(side, 0, None, plan_spec=spec, rounds=2, tracer=tr)
        recs = tr.records()
        by_id = {r["id"]: r for r in recs}
        out[side] = sorted(
            (by_id[r["parent"]]["name"], r["name"],
             tuple(sorted(r["attrs"].items())))
            for r in recs if r["name"] == "fed.client")
        assert sum(r["name"] == "fed.round" for r in recs) == 2
    assert out["torch"] == out["jax"]
    outcome = {dict(a)["client"]: dict(a)["fault"]
               for _, _, a in out["torch"] if dict(a)["round"] == 0}
    assert outcome == {0: "sign_flip", 1: "sign_flip", 2: "crash",
                       3: "ok"}
