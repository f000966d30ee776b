"""The port's live metrics endpoint (idc_models_tpu_torch/observe/
exporter.py) against the JAX package's: the same instruments set to the
same values in each package's registry, scraped over HTTP on
localhost; and the `serve` verb's --metrics-port, scraped while a
realtime replay runs, on the CPU."""

from __future__ import annotations

import contextlib
import io
import json
import re
import threading
import time
import urllib.request

import pytest
import torch

from idc_models_tpu.observe import exporter as jexporter
from idc_models_tpu.observe import metrics_registry as jreg
from idc_models_tpu_torch import cli
from idc_models_tpu_torch.observe import MetricsExporter, MetricsRegistry
from idc_models_tpu_torch.observe.exporter import LAST_TICK_GAUGE


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share a few cores: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.headers["Content-Type"], r.read()


def _fill(reg, now):
    """The serving gauges and a counter, a labeled counter and a
    histogram, set alike in either package's registry."""
    reg.counter("serve_requests_submitted_total", "requests submitted"
                ).inc(7)
    reqs = reg.counter("serve_requests_total", "requests by outcome",
                       labels=("status",))
    reqs.inc(5, status="budget")
    reqs.inc(2, status="eos")
    hist = reg.histogram("serve_ttft_seconds", "submit -> first token")
    for v in (0.003, 0.04, 0.2, 1.5):
        hist.observe(v)
    reg.gauge("serve_queue_depth", "queue depth").set(3)
    reg.gauge("serve_slot_occupancy", "occupancy").set(0.75)
    reg.gauge(LAST_TICK_GAUGE, "last tick").set(now)


def test_metrics_and_healthz_match_the_jax_exporter():
    """/metrics: the same bytes and content type as the JAX exporter's
    over the same instruments, equal to the registry's text; /healthz:
    the same document (the tick age aside), null before any tick; an
    unknown path is a 404."""
    ours, theirs = MetricsRegistry(), jreg.MetricsRegistry()
    with MetricsExporter(ours, port=0) as a, \
            jexporter.MetricsExporter(theirs, port=0) as b:
        empty = json.loads(_get(a.url + "/healthz")[2])
        assert empty == json.loads(_get(b.url + "/healthz")[2])
        assert empty["status"] == "ok" and empty["last_tick_age_s"] is None
        now = time.monotonic()
        _fill(ours, now)
        _fill(theirs, now)
        got, want = _get(a.url + "/metrics"), _get(b.url + "/metrics")
        assert got == want
        assert got[2].decode() == ours.prometheus_text()
        hg = json.loads(_get(a.url + "/healthz")[2])
        hw = json.loads(_get(b.url + "/healthz")[2])
        assert 0.0 <= hg.pop("last_tick_age_s") < 60.0
        hw.pop("last_tick_age_s")
        assert hg == hw
        assert (hg["queue_depth"], hg["slot_occupancy"]) == (3.0, 0.75)
        with pytest.raises(urllib.error.HTTPError, match="404"):
            _get(a.url + "/nope")
    with pytest.raises(RuntimeError, match="not started"):
        a.port


def test_serve_verb_metrics_port_answers_while_serving():
    """`serve --metrics-port 0 --realtime` on the CPU: while the replay
    runs, one scrape of /metrics and one of /healthz answer, the latter
    with a fresh tick; the run prints served: ok=6."""
    out = io.StringIO()
    rc = []

    def run():
        with contextlib.redirect_stdout(out):
            rc.append(cli.main([
                "serve", "--device", "cpu", "--requests", "6", "--slots",
                "2", "--window", "2", "--t-max", "32", "--rate", "4",
                "--realtime", "--metrics-port", "0"]))

    worker = threading.Thread(target=run)
    worker.start()
    url, deadline = None, time.monotonic() + 60
    while url is None and time.monotonic() < deadline:
        m = re.search(r"metrics: (http://\S+)/metrics", out.getvalue())
        url = m and m.group(1)
        time.sleep(0.01)
    assert url is not None
    health = None
    while time.monotonic() < deadline and worker.is_alive():
        health = json.loads(_get(url + "/healthz")[2])
        if health["last_tick_age_s"] is not None:
            break
        time.sleep(0.02)
    status, ctype, body = _get(url + "/metrics")
    worker.join(timeout=120)
    assert not worker.is_alive() and rc == [0]
    assert status == 200 and ctype.startswith("text/plain; version=0.0.4")
    assert b"serve_requests_submitted_total" in body
    assert health is not None and health["status"] == "ok"
    assert health["last_tick_age_s"] is not None
    assert "served: ok=6 " in out.getvalue()
