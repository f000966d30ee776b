"""Declarative SLOs with multi-window burn-rate alerting.

The metrics registry makes the metrics OBSERVABLE (Prometheus
text); this module makes them ACTIONABLE: an `SLOEngine` holds a set of declared
objectives — "TTFT p95 <= 200 ms", "error rate <= 1%" — ingests the
same per-request/per-round samples the metrics hooks already see, and
evaluates them over two sliding windows with the standard burn-rate
alerting rule (Google SRE workbook): alert only when BOTH the short
window (fast detection, noisy alone) and the long window (sustained
evidence, slow alone) are burning error budget faster than
`burn_threshold`x. A breach surfaces three ways:

- a ``slo_alert`` jsonl record through the run's `JsonlLogger` (and a
  ``slo_resolved`` record when both windows recover);
- registry gauges ``slo_burn_rate{slo,window}`` / ``slo_breached{slo}``
  and counter ``slo_alerts_total{slo}`` — live on ``/metrics`` via
  `observe.exporter.MetricsExporter`;
- `breached(name)` — the boolean admission signal the multi-tenant
  scheduler (ROADMAP item 5) consumes to shed/deprioritize a tenant.

Every objective reduces to an ERROR BUDGET — the allowed fraction of
bad samples. A latency SLO "p95 <= T" is exactly "at most 5% of samples
exceed T", so a sample is *bad* when value > threshold and the budget
is 1 - 0.95; a rate SLO's budget is declared directly. Burn rate =
(observed bad fraction) / budget: 1.0 means "spending budget exactly as
fast as allowed", 2.0 means the budget will be gone in half the SLO
period.

Wired-in sample sources (each guarded by `has(name)` so an engine only
declares what it cares about):

- `serve/metrics.py`: ``ttft`` (seconds, per first token),
  ``queue_wait`` (seconds, per admission), ``error_rate`` (bad =
  finish reason error/timeout/deadline or a rejected submit);
  `evaluate()` runs once per scheduler cycle.
- `federated/driver.py`: ``round_seconds`` (wall seconds per attempt),
  ``round_failure_rate`` (bad = attempt status != ok); `evaluate()`
  runs once per attempt.

Clocks are injectable (`clock=`, monotonic by default) so tests drive
window arithmetic deterministically.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

from idc_models_tpu_torch.observe import metrics_registry as mreg


@dataclasses.dataclass(frozen=True)
class SLO:
    """One declared objective. Build via `SLO.latency(...)` or
    `SLO.rate(...)` — the constructors keep kind/threshold/budget
    consistent. `budget` is the allowed bad-sample fraction; for a
    latency objective it is implied by the percentile (p95 -> 0.05)."""

    name: str
    kind: str                    # "latency" | "rate"
    budget: float                # allowed bad fraction, in (0, 1)
    threshold_s: float | None = None   # latency kind: the bad cutoff
    percentile: float | None = None    # latency kind: documentation only

    def __post_init__(self):
        if self.kind not in ("latency", "rate"):
            raise ValueError(f"SLO kind must be 'latency' or 'rate', "
                             f"got {self.kind!r}")
        if not 0.0 < self.budget < 1.0:
            raise ValueError(f"SLO {self.name!r}: budget must be in "
                             f"(0, 1), got {self.budget}")
        if self.kind == "latency" and (self.threshold_s is None
                                       or self.threshold_s <= 0):
            raise ValueError(f"SLO {self.name!r}: latency objectives "
                             f"need threshold_s > 0, got "
                             f"{self.threshold_s}")

    @classmethod
    def latency(cls, name: str, *, threshold_s: float,
                percentile: float = 95.0) -> "SLO":
        """"p{percentile} of samples <= threshold_s": a sample is bad
        when it exceeds the threshold; the budget is the tail the
        percentile leaves (p95 -> 5% of samples may exceed it)."""
        if not 0.0 < percentile < 100.0:
            raise ValueError(f"percentile must be in (0, 100), got "
                             f"{percentile}")
        return cls(name=name, kind="latency",
                   budget=1.0 - percentile / 100.0,
                   threshold_s=float(threshold_s),
                   percentile=float(percentile))

    @classmethod
    def rate(cls, name: str, *, budget: float) -> "SLO":
        """"at most `budget` fraction of events are bad" — e.g.
        budget=0.01 for a 99% success objective."""
        return cls(name=name, kind="rate", budget=float(budget))


class _Window:
    """One sliding window's samples with running totals. Append and
    expiry are O(1) amortized, so a burn-rate evaluation costs
    O(expired samples) — it runs once per scheduler cycle on the serve
    hot path, where rescanning every sample retained over a 300 s long
    window would grow the tick cost with sustained load."""

    __slots__ = ("window_s", "q", "n", "bad")

    def __init__(self, window_s: float):
        self.window_s = window_s
        self.q: deque = deque()
        self.n = 0
        self.bad = 0

    def append(self, sample) -> None:
        self.q.append(sample)
        self.n += 1
        self.bad += sample[1]

    def prune(self, now: float) -> None:
        cutoff = now - self.window_s
        q = self.q
        while q and q[0][0] < cutoff:
            self.bad -= q.popleft()[1]
            self.n -= 1


class SLOEngine:
    """Sliding-window burn-rate evaluator over a set of `SLO`s.

    Feed latency objectives with `observe(name, seconds)` and rate
    objectives with `record(name, ok=...)`; call `evaluate()`
    periodically (per scheduler cycle / per round attempt — it is
    O(pruned samples) cheap). `alerts` accumulates every fired alert
    record; `breached(name)` is the live admission signal.

    An alert FIRES on the transition into "both windows burning >=
    burn_threshold with at least min_samples in the short window" and
    stays active (hysteresis) until both windows drop back below the
    threshold, at which point a ``slo_resolved`` record is emitted —
    so a flapping metric cannot spam one alert per evaluate().
    """

    def __init__(self, slos, *, short_window_s: float = 60.0,
                 long_window_s: float = 300.0,
                 burn_threshold: float = 2.0, min_samples: int = 10,
                 logger=None, registry=None, clock=time.monotonic):
        slos = list(slos)
        if not slos:
            raise ValueError("need at least one SLO")
        names = [s.name for s in slos]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {sorted(names)}")
        if not 0 < short_window_s < long_window_s:
            raise ValueError(
                f"need 0 < short_window_s < long_window_s, got "
                f"{short_window_s} / {long_window_s}")
        if burn_threshold <= 0:
            raise ValueError(f"need burn_threshold > 0, got "
                             f"{burn_threshold}")
        self.slos = {s.name: s for s in slos}
        self.short_window_s = float(short_window_s)
        self.long_window_s = float(long_window_s)
        self.burn_threshold = float(burn_threshold)
        self.min_samples = int(min_samples)
        self.logger = logger
        self.clock = clock
        reg = registry if registry is not None else mreg.REGISTRY
        self._g_burn = reg.gauge(
            "slo_burn_rate", "error-budget burn rate per SLO and "
            "evaluation window (1.0 = spending budget exactly as fast "
            "as the objective allows)", labels=("slo", "window"))
        self._g_breached = reg.gauge(
            "slo_breached", "1 while the SLO's multi-window burn-rate "
            "alert is active, else 0 — the admission/shedding signal",
            labels=("slo",))
        self._c_alerts = reg.counter(
            "slo_alerts_total", "burn-rate alerts fired per SLO",
            labels=("slo",))
        # per-SLO (t, bad) samples held once per window with running
        # counters (the tuple object is shared between the two deques)
        self._windows: dict[str, tuple[_Window, _Window]] = {
            n: (_Window(self.short_window_s), _Window(self.long_window_s))
            for n in self.slos}
        self._alerting: dict[str, bool] = {n: False for n in self.slos}
        self.alerts: list[dict] = []
        for n in self.slos:
            self._g_breached.set(0, slo=n)

    # -- ingestion -------------------------------------------------------

    def has(self, name: str) -> bool:
        """Whether `name` is a declared objective — instrumentation
        call sites guard on this so one engine wiring serves any SLO
        subset."""
        return name in self.slos

    def observe(self, name: str, value_s: float) -> None:
        """One latency sample (seconds) for a latency-kind SLO."""
        slo = self._get(name, "latency")
        self._append(name, float(value_s) > slo.threshold_s)

    def record(self, name: str, *, ok: bool) -> None:
        """One event outcome for a rate-kind SLO."""
        self._get(name, "rate")
        self._append(name, not ok)

    def _append(self, name: str, is_bad: bool) -> None:
        sample = (self.clock(), is_bad)
        for win in self._windows[name]:
            win.append(sample)

    def _get(self, name: str, kind: str) -> SLO:
        slo = self.slos.get(name)
        if slo is None:
            raise ValueError(f"unknown SLO {name!r} (declared: "
                             f"{sorted(self.slos)})")
        if slo.kind != kind:
            raise ValueError(
                f"SLO {name!r} is {slo.kind}-kind; use "
                f"{'observe()' if slo.kind == 'latency' else 'record()'}")
        return slo

    # -- evaluation ------------------------------------------------------

    def _window_burn(self, name: str, now: float,
                     win: _Window) -> tuple[float, int]:
        """(burn rate, sample count) over the trailing window."""
        win.prune(now)
        if win.n == 0:
            return 0.0, 0
        return (win.bad / win.n) / self.slos[name].budget, win.n

    def evaluate(self, now: float | None = None) -> list[dict]:
        """Evaluate every SLO at `now` (default: the engine clock).
        Updates the gauges, fires/resolves alerts on state transitions,
        and returns the alert records fired by THIS call."""
        now = self.clock() if now is None else now
        fired: list[dict] = []
        for name in self.slos:
            short_win, long_win = self._windows[name]
            burn_s, n_s = self._window_burn(name, now, short_win)
            burn_l, n_l = self._window_burn(name, now, long_win)
            self._g_burn.set(round(burn_s, 4), slo=name, window="short")
            self._g_burn.set(round(burn_l, 4), slo=name, window="long")
            breaching = (n_s >= self.min_samples
                         and burn_s >= self.burn_threshold
                         and burn_l >= self.burn_threshold)
            was = self._alerting[name]
            if breaching and not was:
                self._alerting[name] = True
                self._g_breached.set(1, slo=name)
                self._c_alerts.inc(slo=name)
                slo = self.slos[name]
                alert = {
                    "slo": name, "kind": slo.kind,
                    "burn_short": round(burn_s, 4),
                    "burn_long": round(burn_l, 4),
                    "samples_short": n_s, "samples_long": n_l,
                    "budget": slo.budget,
                    "burn_threshold": self.burn_threshold,
                    "short_window_s": self.short_window_s,
                    "long_window_s": self.long_window_s,
                }
                if slo.threshold_s is not None:
                    alert["threshold_s"] = slo.threshold_s
                self.alerts.append(alert)
                fired.append(alert)
                if self.logger is not None:
                    self.logger.log(event="slo_alert", **alert)
            elif was and not breaching:
                self._alerting[name] = False
                self._g_breached.set(0, slo=name)
                if self.logger is not None:
                    self.logger.log(event="slo_resolved", slo=name,
                                    burn_short=round(burn_s, 4),
                                    burn_long=round(burn_l, 4))
        return fired

    def state_doc(self) -> dict:
        """Per-objective live state for an embedding health document
        (the fleet /healthz): breached flag, current burn
        rates, and alerts fired so far — read off the gauges this
        engine already maintains, so the document and /metrics can
        never disagree."""
        return {
            name: {
                "kind": self.slos[name].kind,
                "breached": self._alerting[name],
                "burn_short": self._g_burn.value(
                    default=0.0, slo=name, window="short"),
                "burn_long": self._g_burn.value(
                    default=0.0, slo=name, window="long"),
                "alerts": int(self._c_alerts.value(slo=name)),
            }
            for name in sorted(self.slos)}

    def breached(self, name: str | None = None) -> bool:
        """Live alert state for `name` — the signal an admission policy
        consumes (shed/deprioritize while True). With ``name=None``,
        True while ANY declared objective is breached — the brownout
        controller's default trigger (serve/brownout.py), so one
        controller can guard a server that declares several SLOs."""
        if name is None:
            return any(self._alerting.values())
        if name not in self.slos:
            raise ValueError(f"unknown SLO {name!r} (declared: "
                             f"{sorted(self.slos)})")
        return self._alerting[name]
