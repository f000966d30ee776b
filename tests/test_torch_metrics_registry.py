"""The port's metrics registry (idc_models_tpu_torch/observe/
metrics_registry.py) against the JAX package's: the same instrument
calls give identical Prometheus exposition text and an identical
``metrics_snapshot`` record (tests/test_observability.py)."""

from __future__ import annotations

import json

import pytest

from idc_models_tpu import observe as jobs
from idc_models_tpu_torch import observe as tobs

PKGS = {"jax": jobs, "torch": tobs}


def _fill(reg):
    c = reg.counter("reqs_total", "requests", labels=("status",))
    c.inc(status="ok")
    c.inc(2, status="ok")
    c.inc(status="err")
    reg.counter("jobs_total", "jobs run", labels=("kind",)).inc(
        3, kind="a b")
    g = reg.gauge("depth", "queue depth")
    g.set(4)
    g.dec()
    reg.gauge("hot").set(float("inf"))
    reg.gauge("broken").set(float("nan"))
    h = reg.histogram("lat_seconds", "latency", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    return reg


@pytest.mark.parametrize("what", ["prometheus", "snapshot", "errors"])
def test_same_instrument_calls_give_the_same_output(what, tmp_path):
    out = {}
    for name, pkg in PKGS.items():
        reg = _fill(pkg.MetricsRegistry())
        if what == "prometheus":
            out[name] = reg.prometheus_text()
        elif what == "snapshot":
            log = tmp_path / f"{name}.jsonl"
            with pkg.JsonlLogger(log) as logger:
                reg.log_snapshot(logger)
            rec = json.loads(log.read_text())
            assert rec.pop("ts") > 0
            out[name] = json.dumps(rec, sort_keys=True)
        else:
            msgs = []
            for bad in (
                    lambda: reg.counter("reqs_total",
                                        labels=("status",)).inc(
                        -1, status="ok"),
                    lambda: reg.counter("reqs_total",
                                        labels=("status",)).inc(
                        status="ok", extra="x"),
                    lambda: reg.gauge("reqs_total"),
                    lambda: reg.counter("reqs_total", labels=("other",)),
                    lambda: reg.histogram("lat_seconds",
                                          buckets=(10.0, 20.0))):
                with pytest.raises(ValueError) as e:
                    bad()
                msgs.append(str(e.value))
            out[name] = msgs
    assert out["torch"] == out["jax"]
    if what == "prometheus":
        lines = out["torch"].splitlines()
        assert 'jobs_total{kind="a b"} 3' in lines
        assert 'lat_seconds_bucket{le="+Inf"} 3' in lines
        assert "hot +Inf" in lines and "broken NaN" in lines


def test_snapshot_values_and_idempotent_registration():
    reg = _fill(tobs.MetricsRegistry())
    c = reg.counter("reqs_total", labels=("status",))
    assert c.value(status="ok") == 3 and c.value(status="err") == 1
    assert reg.gauge("depth").value() == 3
    assert reg.histogram("lat_seconds", buckets=(0.1, 1.0)) is \
        reg.histogram("lat_seconds", buckets=(0.1, 1.0))
    snap = {(r["name"], tuple(sorted(r["labels"].items()))): r
            for r in reg.snapshot()}
    hrec = snap[("lat_seconds", ())]
    assert hrec["count"] == 3 and hrec["buckets"] == {
        "0.1": 1, "1.0": 2, "+Inf": 3}


def test_snapshot_file_reads_back_through_both_stats(tmp_path):
    """A snapshot the port writes is summarized alike by both packages'
    ``summarize_jsonl`` (the ``stats`` verb's reader)."""
    reg = _fill(tobs.MetricsRegistry())
    log = tmp_path / "run.jsonl"
    with tobs.JsonlLogger(log) as logger:
        logger.log(event="epoch", epoch=0, loss=1.0, accuracy=0.5)
        reg.log_snapshot(logger)
    got, want = tobs.summarize_jsonl(log), jobs.summarize_jsonl(log)
    assert got == want
    assert got["records"] == 2 and got["metrics"][0]["name"] == "broken"
