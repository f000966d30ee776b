"""The port's tracer (idc_models_tpu_torch/observe/trace.py) and Timer
against the JAX package's: the same span and point sequence gives the
same records apart from times, and the same Chrome export structure
(tests/test_observability.py)."""

from __future__ import annotations

import json
import threading

import pytest

from idc_models_tpu import observe as jobs
from idc_models_tpu_torch import observe as tobs

PKGS = {"jax": jobs, "torch": tobs}
# the fields of a span record that hold times (or the process's ids)
TIMES = ("t_ms", "dur_ms", "wall")


def _nested_work(trace):
    with trace.span("outer", kind="test"):
        with trace.span("inner.a", i=0):
            pass
        with trace.span("inner.a", i=1) as s:
            with trace.span("leaf"):
                pass
            s.set(late=True)
        trace.point("marker", n=3)
    with trace.span("sibling"):
        pass
    req = trace.start_span("request", rid="r0")
    child = trace.start_span("queued", parent=req.span_id, rid="r0")
    child.close(queue_wait_ms=1.5)
    child.close(queue_wait_ms=999.0)            # a second close: no-op
    trace.point("first_token", parent=req.span_id, rid="r0")
    req.close(status="ok")


def _run(pkg, tmp_path):
    tr = pkg.Tracer()
    prev = pkg.trace.set_tracer(tr)
    try:
        _nested_work(pkg.trace)
    finally:
        pkg.trace.set_tracer(prev)
    recs = tr.records()
    chrome = json.load(open(tr.export_chrome(
        tmp_path / f"{pkg.__name__}.json")))
    jsonl = [json.loads(line) for line in open(tr.export_jsonl(
        tmp_path / f"{pkg.__name__}.jsonl"))]
    return recs, chrome, jsonl


def _untimed(recs):
    """Records with their times dropped and their ids renumbered in
    order (ids are process-unique, so two tracers never share them)."""
    ids = {r["id"]: i for i, r in enumerate(recs)}
    out = []
    for r in recs:
        r = {k: v for k, v in r.items() if k not in TIMES + ("tid",)}
        r["id"] = ids[r["id"]]
        r["parent"] = ids.get(r["parent"])
        out.append(r)
    return out


def test_same_spans_give_the_same_records(tmp_path):
    (jrecs, _, jl), (trecs, _, tl) = (_run(jobs, tmp_path),
                                      _run(tobs, tmp_path))
    assert _untimed(trecs) == _untimed(jrecs)
    assert _untimed(tl) == _untimed(jl)
    assert len(trecs) == 9
    for r in trecs:
        assert r["dur_ms"] >= 0 and r["t_ms"] >= 0 and r["wall"] > 0
        assert set(r) == set(jrecs[0])


def _chrome_shape(doc):
    """The export's structure: each event's keys, phase, name and args
    keys, with the span ids renumbered and the process name dropped."""
    ids = {}
    out = []
    for e in doc["traceEvents"]:
        args = dict(e.get("args", {}))
        for k in ("span_id", "parent_id"):
            if args.get(k) is not None:
                args[k] = ids.setdefault(args[k], len(ids))
        if e["ph"] == "M":
            args = {}
        out.append((sorted(e), e["ph"], e["name"], sorted(args.items())))
    return sorted(doc), out


def test_same_spans_give_the_same_chrome_structure(tmp_path):
    (_, jchrome, _), (_, tchrome, _) = (_run(jobs, tmp_path),
                                        _run(tobs, tmp_path))
    assert _chrome_shape(tchrome) == _chrome_shape(jchrome)
    xs = [e for e in tchrome["traceEvents"] if e["ph"] == "X"]
    by_id = {e["args"]["span_id"]: e for e in xs}
    for e in xs:
        assert isinstance(e["pid"], int) and isinstance(e["tid"], int)
        parent = e["args"]["parent_id"]
        if parent is not None:
            p = by_id[parent]
            assert p["ts"] <= e["ts"] + 1e-3
            assert e["ts"] + e["dur"] <= p["ts"] + p["dur"] + 1e-3


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_disabled_tracer_is_the_shared_noop(pkg):
    trace = PKGS[pkg].trace
    assert trace.get_tracer() is None
    h = trace.span("x", a=1)
    assert h is trace.span("y") is trace.point("z") is trace.start_span("r")
    assert h.span_id is None
    with h as s:
        s.set(b=2)
    h.close(status="ok")


def test_spans_are_per_thread():
    """Each thread parents under its own open spans, in both tracers."""
    out = {}
    for name, pkg in PKGS.items():
        tr = pkg.Tracer()
        prev = pkg.trace.set_tracer(tr)
        ready = threading.Barrier(2)

        def work(tag, trace=pkg.trace, ready=ready):
            ready.wait()
            with trace.span(f"t.{tag}"):
                with trace.span(f"t.{tag}.child"):
                    pass

        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        pkg.trace.set_tracer(prev)
        recs = tr.records()
        by_id = {r["id"]: r for r in recs}
        out[name] = sorted(
            (r["name"], by_id[r["parent"]]["name"]
             if r["parent"] is not None else None) for r in recs)
    assert out["torch"] == out["jax"] == [
        ("t.0", None), ("t.0.child", "t.0"), ("t.1", None),
        ("t.1.child", "t.1")]


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_timer_routes_through_tracer(pkg, capsys):
    """The port's Timer records a span of its name while a tracer is
    armed, and prints the line the JAX Timer prints."""
    obs = PKGS[pkg]
    tr = obs.Tracer()
    prev = obs.trace.set_tracer(tr)
    try:
        with obs.Timer("Pre-training for 10 epochs") as t:
            pass
    finally:
        obs.trace.set_tracer(prev)
    assert capsys.readouterr().out == (
        f"Pre-training for 10 epochs took {t.seconds} seconds\n")
    spans = tr.records()
    assert [s["name"] for s in spans] == ["Pre-training for 10 epochs"]
    assert spans[0]["attrs"] == {"timer": True}


def test_tracing_context_installs_and_exports(tmp_path):
    chrome = tmp_path / "t.json"
    with tobs.tracing(chrome_path=chrome) as tr:
        assert tobs.get_tracer() is tr
        with tobs.trace.span("inside"):
            pass
    assert tobs.get_tracer() is None
    names = {e["name"] for e in json.load(open(chrome))["traceEvents"]}
    assert "inside" in names
    with tobs.tracing() as tr2:
        assert tr2 is None and tobs.get_tracer() is None


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    """``profile_trace(dir)`` wraps torch.profiler, arms program
    accounting inside the block and writes ``dir/trace.json``;
    ``profile_trace(None)`` is a no-op."""
    import torch

    from idc_models_tpu_torch.observe import profile as prof

    with tobs.profile_trace(None) as p:
        assert p is None
        assert not prof.accounting_enabled()
    with tobs.profile_trace(tmp_path / "prof"):
        assert prof.accounting_enabled()
        torch.ones(4, 4) @ torch.ones(4, 4)
    assert not prof.accounting_enabled()
    doc = json.load(open(tmp_path / "prof" / "trace.json"))
    assert any("mm" in e.get("name", "") for e in doc["traceEvents"])
