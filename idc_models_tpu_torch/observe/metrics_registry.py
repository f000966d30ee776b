"""Process-wide metrics registry: labeled counters, gauges, histograms.

The serving, federated, and training loops each grew their own counter
piles (`serve/metrics.py` lists, `federated/driver.py` health events,
`train/loop.py` history dicts). Those stay — their jsonl schemas are a
compatibility contract — but operational state ("how many rounds
failed", "how many compiles did admission trigger", "what is the
slot occupancy RIGHT NOW") belongs in one process-wide registry with
two standard export surfaces:

- `snapshot()` / `log_snapshot(logger)` — plain-JSON records, appended
  to the same jsonl stream every loop already writes.
- `prometheus_text()` — the Prometheus text exposition format, so a
  scrape endpoint (or a file-based textfile collector) needs zero
  translation.

Instruments are created idempotently: `registry.counter("x", ...)`
returns the SAME instrument every call (and raises if the name was
registered as a different type), so call sites never coordinate
construction. Everything is lock-guarded and cheap enough for per-tick
use; per-TOKEN paths should aggregate first.

`REGISTRY` is the process default — module-level, like the compiled
program caches in `models/lm.py` — and `MetricsRegistry()` instances
can be built standalone for tests.
"""

from __future__ import annotations

import json
import math
import re
import threading
import time
from pathlib import Path

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")

# generic latency-seconds buckets (sub-ms dispatch through multi-second
# rounds); override per-histogram when the domain is known
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name):
        raise ValueError(f"invalid metric name {name!r} (want "
                         f"[a-zA-Z_:][a-zA-Z0-9_:]*)")
    return name


def _label_key(label_names: tuple, labels: dict) -> tuple:
    if set(labels) != set(label_names):
        raise ValueError(f"labels {sorted(labels)} != declared "
                         f"{sorted(label_names)}")
    return tuple(str(labels[k]) for k in label_names)


def _escape(v: str) -> str:
    return (v.replace("\\", "\\\\").replace("\"", "\\\"")
            .replace("\n", "\\n"))


class _Instrument:
    """Shared base: name, help text, declared label names, and the
    per-label-set value table (lock-guarded)."""

    kind = "untyped"

    def __init__(self, name: str, help: str, label_names: tuple):
        self.name = _check_name(name)
        self.help = help
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()
        self._values: dict[tuple, object] = {}

    def _series(self) -> list[tuple[dict, object]]:
        # histogram values are MUTABLE dicts observe() updates in place
        # — copy them (buckets list included) while still holding the
        # lock, or an export racing an observe() could emit a _count
        # that disagrees with its own _sum/_bucket increments
        with self._lock:
            items = [(key, {**val, "buckets": list(val["buckets"])}
                      if isinstance(val, dict) else val)
                     for key, val in self._values.items()]
        return [(dict(zip(self.label_names, key)), val)
                for key, val in items]


class Counter(_Instrument):
    """Monotonically increasing count. `inc(amount, **labels)`."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counters only go up, got inc({amount})")
        key = _label_key(self.label_names, labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        key = _label_key(self.label_names, labels)
        with self._lock:
            return float(self._values.get(key, 0.0))


class Gauge(_Instrument):
    """Point-in-time value. `set(v, **labels)` / `inc` / `dec`."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = _label_key(self.label_names, labels)
        with self._lock:
            self._values[key] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _label_key(self.label_names, labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, default: float | None = 0.0, **labels):
        """Current value for the label set; `default` when the gauge
        was never set — pass default=None to distinguish unset from 0
        (e.g. a health surface reporting null before the first tick)."""
        key = _label_key(self.label_names, labels)
        with self._lock:
            if key not in self._values:
                return default
            return float(self._values[key])


class Histogram(_Instrument):
    """Bucketed distribution: per-label-set bucket counts + sum + count
    (+ min/max, carried into snapshots — Prometheus text omits them by
    format design)."""

    kind = "histogram"

    def __init__(self, name: str, help: str, label_names: tuple,
                 buckets=DEFAULT_BUCKETS):
        super().__init__(name, help, label_names)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs or any(not math.isfinite(b) for b in bs):
            raise ValueError(f"need finite, non-empty buckets, got "
                             f"{buckets}")
        self.buckets = bs

    def observe(self, value: float, **labels) -> None:
        key = _label_key(self.label_names, labels)
        v = float(value)
        with self._lock:
            st = self._values.get(key)
            if st is None:
                st = self._values[key] = {
                    "buckets": [0] * len(self.buckets),
                    "count": 0, "sum": 0.0, "min": v, "max": v}
            st["count"] += 1
            st["sum"] += v
            st["min"] = min(st["min"], v)
            st["max"] = max(st["max"], v)
            for i, b in enumerate(self.buckets):
                if v <= b:
                    st["buckets"][i] += 1
                    break
            # values above the top bucket land only in +Inf (= count)

    def merge_state(self, state: dict, **labels) -> None:
        """Fold one exported series state (`_series()`'s value shape:
        raw per-bucket counts plus count/sum/min/max) into this
        histogram's series for `labels` — the fleet-merge path
        (serve/cluster/telemetry.py) relabels a whole per-replica
        histogram in one call instead of replaying every observation.
        Bucket layouts must match: a merged distribution across two
        grids has no honest bucket counts."""
        if len(state["buckets"]) != len(self.buckets):
            raise ValueError(
                f"histogram {self.name!r}: cannot merge a series with "
                f"{len(state['buckets'])} buckets into {len(self.buckets)}")
        key = _label_key(self.label_names, labels)
        with self._lock:
            st = self._values.get(key)
            if st is None:
                self._values[key] = {
                    "buckets": list(state["buckets"]),
                    "count": state["count"], "sum": state["sum"],
                    "min": state["min"], "max": state["max"]}
                return
            st["buckets"] = [a + b for a, b in
                             zip(st["buckets"], state["buckets"])]
            st["count"] += state["count"]
            st["sum"] += state["sum"]
            st["min"] = min(st["min"], state["min"])
            st["max"] = max(st["max"], state["max"])


class MetricsRegistry:
    """Name -> instrument table with idempotent registration and the
    two export surfaces (json snapshot, Prometheus text)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict[str, _Instrument] = {}

    def _get_or_make(self, cls, name, help, labels, **kw):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is not None:
                if type(inst) is not cls:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{inst.kind}, not {cls.kind}")
                if tuple(labels) != inst.label_names:
                    raise ValueError(
                        f"metric {name!r} already registered with "
                        f"labels {inst.label_names}, not {tuple(labels)}")
                # every registration knob conflicts loudly, buckets
                # included — a second caller silently getting different
                # buckets would file all its observations into +Inf
                want = kw.get("buckets")
                if (want is not None and tuple(sorted(
                        float(b) for b in want)) != inst.buckets):
                    raise ValueError(
                        f"histogram {name!r} already registered with "
                        f"buckets {inst.buckets}, not {tuple(want)}")
                return inst
            inst = cls(name, help, tuple(labels), **kw)
            self._instruments[name] = inst
            return inst

    def counter(self, name: str, help: str = "",
                labels: tuple = ()) -> Counter:
        return self._get_or_make(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: tuple = ()) -> Gauge:
        return self._get_or_make(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "", labels: tuple = (),
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_make(Histogram, name, help, labels,
                                 buckets=buckets)

    def get(self, name: str) -> _Instrument | None:
        """The registered instrument, or None — the read-only lookup
        surfaces like the /healthz endpoint use (they must not CREATE
        a metric whose owner simply has not registered yet)."""
        with self._lock:
            return self._instruments.get(name)

    def instruments(self) -> list[_Instrument]:
        with self._lock:
            return [self._instruments[k]
                    for k in sorted(self._instruments)]

    # -- export ----------------------------------------------------------

    def snapshot(self) -> list[dict]:
        """Every series as one plain-JSON record: counters/gauges carry
        `value`; histograms carry count/sum/min/max plus cumulative
        bucket counts keyed by upper bound."""
        out = []
        for inst in self.instruments():
            for labels, val in inst._series():
                rec = {"name": inst.name, "type": inst.kind,
                       "labels": labels}
                if inst.kind == "histogram":
                    cum, acc = {}, 0
                    for b, n in zip(inst.buckets, val["buckets"]):
                        acc += n
                        cum[str(b)] = acc
                    cum["+Inf"] = val["count"]
                    rec.update(count=val["count"],
                               sum=round(val["sum"], 6),
                               min=val["min"], max=val["max"],
                               buckets=cum)
                else:
                    rec["value"] = val
                out.append(rec)
        return out

    def log_snapshot(self, logger, **extra) -> None:
        """Append the snapshot to a `JsonlLogger` as ONE
        `metrics_snapshot` record — a new event type; no existing
        record schema changes."""
        logger.log(event="metrics_snapshot", metrics=self.snapshot(),
                   **extra)

    def write_snapshot(self, path) -> str:
        """Standalone jsonl snapshot file (one series per line, plus a
        timestamp header) for runs without a logger."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            f.write(json.dumps({"event": "metrics_header",
                                "ts": time.time()}) + "\n")
            for rec in self.snapshot():
                f.write(json.dumps(rec) + "\n")
        return str(path)

    def prometheus_text(self) -> str:
        """The Prometheus text exposition format (one HELP/TYPE pair
        per metric, histogram `_bucket{le=...}`/`_sum`/`_count`
        series with cumulative counts)."""
        lines: list[str] = []
        for inst in self.instruments():
            if inst.help:
                lines.append(f"# HELP {inst.name} {inst.help}")
            lines.append(f"# TYPE {inst.name} {inst.kind}")
            for labels, val in inst._series():
                base = ",".join(f'{k}="{_escape(v)}"'
                                for k, v in labels.items())
                if inst.kind != "histogram":
                    lbl = f"{{{base}}}" if base else ""
                    lines.append(f"{inst.name}{lbl} {_fmt(val)}")
                    continue
                acc = 0
                for b, n in zip(inst.buckets, val["buckets"]):
                    acc += n
                    le = ",".join(x for x in (base, f'le="{_fmt(b)}"')
                                  if x)
                    lines.append(f"{inst.name}_bucket{{{le}}} {acc}")
                le = ",".join(x for x in (base, 'le="+Inf"') if x)
                lines.append(f"{inst.name}_bucket{{{le}}} "
                             f"{val['count']}")
                lbl = f"{{{base}}}" if base else ""
                lines.append(f"{inst.name}_sum{lbl} {_fmt(val['sum'])}")
                lines.append(f"{inst.name}_count{lbl} {val['count']}")
        return "\n".join(lines) + ("\n" if lines else "")


def _fmt(v: float) -> str:
    f = float(v)
    if not math.isfinite(f):
        # Prometheus's legal sample spellings — one bad value must not
        # take the whole exposition down with an int() OverflowError
        return "NaN" if math.isnan(f) else ("+Inf" if f > 0 else "-Inf")
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


# the process-wide default registry every instrumented loop shares
REGISTRY = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return REGISTRY
