"""Runtime span tracing: nested, thread-safe, exportable to Perfetto.

The reference's entire timing story is a copy-pasted `Timer` print
(SURVEY.md §5/C17); the framework's hot paths — the serve scheduler's
admit/window/collect cycle, chunked prefills, federated round attempts,
training epochs — need to answer "where did this token/round actually
spend its time" without each loop growing its own ad-hoc stopwatch.

One `Tracer` records SPANS: named intervals with a process-unique id, a
parent id (the innermost open span on the same thread), per-span
attributes, and both clocks — a monotonic offset for durations and a
wall-clock anchor so traces line up with jsonl logs. Two export
formats:

- `export_jsonl(path)` — one record per span, the same append-only
  shape every other run log in the framework uses.
- `export_chrome(path)` — Chrome trace-event JSON (`ph:"X"` complete
  events, microsecond `ts`/`dur`), loadable directly in Perfetto /
  `chrome://tracing`.

The DISABLED mode is the production default and must cost ~nothing:
`span()` with no active tracer returns a shared no-op handle — one
global read, no allocation beyond the caller's kwargs. `bench.py`
(`bench_tracer_overhead`) gates this on the serve decode hot loop.

Instrumented call sites use the module-level helper:

    from idc_models_tpu_torch.observe import trace
    with trace.span("serve.collect", tokens=n):
        ...

and a run opts in by installing a tracer (`tracing(...)` context or
`set_tracer`), e.g. the CLI's `--trace-out trace.json`.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from pathlib import Path


class _NullSpan:
    """The disabled-mode handle: every operation is a no-op. A single
    shared instance serves every call site, so tracing-off costs one
    module-global read per span."""

    __slots__ = ()

    # detached-span callers hand `handle.span_id` straight back as a
    # `parent=`; None is the "no parent" value on both sides, so the
    # disabled path needs no branches at the call sites
    span_id = None

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def close(self, **attrs) -> None:
        return None

    def set(self, **attrs) -> "_NullSpan":
        return self


_NULL_SPAN = _NullSpan()


class Span:
    """One open interval. Use as a context manager (via `Tracer.span` or
    the module-level `span()`); `set(**attrs)` attaches attributes any
    time before exit."""

    __slots__ = ("name", "span_id", "parent_id", "tid", "attrs",
                 "_tracer", "_t0", "_stack", "_detached", "dur_s")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self._tracer = tracer
        self.span_id = next(tracer._ids)
        self.parent_id = None
        self.tid = 0
        self._t0 = 0.0
        self._stack = None
        self._detached = False
        self.dur_s = 0.0

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        tr = self._tracer
        # the OPENING thread's stack is captured on the span so an
        # exotic exit (closed on a different thread) still removes the
        # span from the stack it actually sits on — popping the closing
        # thread's stack instead would leave it dangling and corrupt
        # the parenting of every later span on the opening thread
        stack = self._stack = tr._stack()
        self.parent_id = stack[-1].span_id if stack else None
        self.tid = threading.get_ident()
        stack.append(self)
        # the clock read is LAST on entry (and first on exit) so nested
        # spans exclude as much of the tracer's own bookkeeping as
        # possible from their measured interval
        self._t0 = tr._clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        tr = self._tracer
        t1 = tr._clock()
        self.dur_s = t1 - self._t0
        stack = self._stack
        if stack and stack[-1] is self:
            stack.pop()
        elif stack and self in stack:
            stack.remove(self)
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        with tr._lock:
            tr._spans.append(self)

    def close(self, **attrs) -> None:
        """Finalize a DETACHED span (see `Tracer.start_span`). Safe to
        call more than once — only the first close records — and a
        no-op on any non-detached span: one a with-block manages (it
        already records) or one created but never entered (closing it
        would record a garbage interval timed from t0=0)."""
        if not self._detached or self._stack is not None:
            return
        if attrs:
            self.attrs.update(attrs)
        self.__exit__(None, None, None)
        self._stack = ()


class Tracer:
    """Collects finished spans; thread-safe (each thread keeps its own
    open-span stack, the finished list is lock-guarded). `clock` is the
    monotonic duration clock; wall time is anchored once at
    construction so exported timestamps can be mapped to epoch time."""

    def __init__(self, *, clock=time.perf_counter):
        self._clock = clock
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._spans: list[Span] = []
        self.wall_t0 = time.time()
        self.mono_t0 = clock()

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, attrs)

    def start_span(self, name: str, parent=None, **attrs) -> Span:
        """A DETACHED span: opened now, finalized by `close()`, never on
        any thread's open-span stack. Parenting is explicit (`parent` is
        another span's id, or None for top-level) — the handle for
        logical intervals that outlive any one call frame, e.g. a serve
        request's whole submit→finish lifetime spanning many scheduler
        ticks (a stack-entered span held open that long would corrupt
        the parenting of every tick span under it)."""
        s = Span(self, name, attrs)
        s.parent_id = parent
        s.tid = threading.get_ident()
        s._detached = True
        s._t0 = self._clock()
        return s

    def point(self, name: str, parent=None, **attrs) -> Span:
        """A zero-duration marker span recorded immediately — lifecycle
        events (first token, a finish) inside a detached span chain."""
        s = self.start_span(name, parent, **attrs)
        s.close()
        return s

    def finished(self) -> list[Span]:
        """Snapshot of the finished spans (open spans are excluded —
        they have no duration yet)."""
        with self._lock:
            return list(self._spans)

    # -- export ----------------------------------------------------------

    def records(self) -> list[dict]:
        """Finished spans as plain dicts: `t_ms` is the start offset
        from the tracer's epoch (monotonic), `wall` the corresponding
        wall-clock epoch seconds."""
        out = []
        for s in self.finished():
            start = s._t0 - self.mono_t0
            out.append({
                "event": "span", "name": s.name, "id": s.span_id,
                "parent": s.parent_id, "tid": s.tid,
                "t_ms": round(start * 1e3, 4),
                "dur_ms": round(s.dur_s * 1e3, 4),
                "wall": round(self.wall_t0 + start, 6),
                "attrs": dict(s.attrs),
            })
        out.sort(key=lambda r: r["t_ms"])
        return out

    def export_jsonl(self, path) -> str:
        """One span record per line — the framework's run-log shape, so
        `stats` summarizes traces with the same code as any run jsonl."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            for rec in self.records():
                f.write(json.dumps(rec) + "\n")
        return str(path)

    def export_chrome(self, path) -> str:
        """Chrome trace-event JSON: `ph:"X"` complete events with
        microsecond `ts`/`dur` (Perfetto's expectations), one event per
        finished span, plus a process-name metadata record."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        pid = os.getpid()
        events: list[dict] = [{
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": "idc_models_tpu_torch"},
        }]
        for rec in self.records():
            events.append({
                "name": rec["name"], "ph": "X", "pid": pid,
                "tid": rec["tid"],
                "ts": round(rec["t_ms"] * 1e3, 3),
                "dur": round(rec["dur_ms"] * 1e3, 3),
                "args": {**rec["attrs"], "span_id": rec["id"],
                         "parent_id": rec["parent"]},
            })
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"},
                      f)
        return str(path)


# -- the process-wide active tracer ----------------------------------------

_ACTIVE: Tracer | None = None


def set_tracer(tracer: Tracer | None) -> Tracer | None:
    """Install `tracer` as the process-wide active tracer; returns the
    previous one (restore it when your scope ends)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, tracer
    return prev


def get_tracer() -> Tracer | None:
    return _ACTIVE


def span(name: str, **attrs):
    """A span on the active tracer — or the shared no-op handle when
    tracing is disabled. THE instrumentation entry point for every hot
    path; its disabled cost is gated by `bench_tracer_overhead`."""
    tr = _ACTIVE
    if tr is None:
        return _NULL_SPAN
    return Span(tr, name, attrs)


def start_span(name: str, parent=None, **attrs):
    """A DETACHED span on the active tracer (see `Tracer.start_span`) —
    or the shared no-op handle when tracing is disabled. The entry
    point for request-lifecycle spans that outlive any call frame; the
    no-op handle's `span_id` is None, which is also the "no parent"
    value, so chained call sites need no enabled/disabled branches."""
    tr = _ACTIVE
    if tr is None:
        return _NULL_SPAN
    return tr.start_span(name, parent, **attrs)


def point(name: str, parent=None, **attrs):
    """A zero-duration marker on the active tracer — or the shared
    no-op handle when tracing is disabled."""
    tr = _ACTIVE
    if tr is None:
        return _NULL_SPAN
    return tr.point(name, parent, **attrs)


@contextlib.contextmanager
def tracing(chrome_path=None, jsonl_path=None, tracer: Tracer | None = None):
    """Install a tracer for the enclosed block and export on exit.
    With neither export path nor an explicit tracer this is a true
    no-op (call sites can be unconditional, like `profile_trace`).
    Yields the active tracer (or None when disabled)."""
    if chrome_path is None and jsonl_path is None and tracer is None:
        yield None
        return
    tr = tracer if tracer is not None else Tracer()
    prev = set_tracer(tr)
    try:
        yield tr
    finally:
        set_tracer(prev)
        if chrome_path is not None:
            tr.export_chrome(chrome_path)
        if jsonl_path is not None:
            tr.export_jsonl(jsonl_path)
