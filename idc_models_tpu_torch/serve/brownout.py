"""SLO-driven brownout: staged load shedding with hysteresis -- the
counterpart of ``idc_models_tpu/serve/brownout.py``.

While the signal fires (a declared SLO in breach, the admission queue at
its watermark, or the caller's page pressure) the controller escalates
one stage per evaluation once `escalate_dwell_s` has passed since the
last change, and steps back one stage only after the signal has been
clear for `clear_after_s`:

    stage 0  normal              everything on
    stage 1  pause_cache_writes  prefix-cache inserts stop (lookups
                                 still serve hits)
    stage 2  clamp_tokens        admissions clamp max_new_tokens to
                                 `clamp_tokens`
    stage 3  shed                new submits are refused with a
                                 ``shed`` status

Every transition is a `serve.brownout` trace point, a jsonl
``serve_brownout`` record and the ``serve_brownout_stage`` gauge. The
scheduler reads `shedding` at submit and `token_clamp` at admission, and
calls `evaluate()` once a cycle.

A per-tenant controller (``tenant=``, built by ``serve/tenancy.py``)
degrades one tenant's admissions only: its gauge is the tenant-labelled
``serve_tenant_brownout_stage``, its record the ``serve_tenant_brownout``
event (the untenanted ``serve_brownout`` record is unchanged), and it
holds no prefix cache, which every tenant shares.
"""

from __future__ import annotations

import time

from idc_models_tpu_torch.observe import metrics_registry as mreg
from idc_models_tpu_torch.observe import trace

STAGES = ("normal", "pause_cache_writes", "clamp_tokens", "shed")


class BrownoutController:
    """Staged degradation driven by SLO breach, queue depth and page
    pressure.

    `slo` is an `observe.slo.SLOEngine`; `slo_name` picks one declared
    objective (None: any breached one). `queue_high` escalates when the
    admission queue reaches it; `queue_low` (default `queue_high // 4`)
    is the depth the queue must fall to before the clear timer starts.
    At least one of the two signals must be configured. `clock` is
    injectable, so tests drive the dwell and hysteresis exactly."""

    def __init__(self, *, slo=None, slo_name: str | None = None,
                 queue_high: int | None = None,
                 queue_low: int | None = None, clamp_tokens: int = 8,
                 escalate_dwell_s: float = 0.25,
                 clear_after_s: float = 1.0, prefix_cache=None,
                 logger=None, registry=None, clock=time.monotonic,
                 tenant: str | None = None):
        if slo is None and queue_high is None:
            raise ValueError(
                "brownout needs at least one signal: an SLOEngine "
                "(slo=) or a queue-depth watermark (queue_high=)")
        if queue_high is not None and queue_high < 1:
            raise ValueError(f"need queue_high >= 1, got {queue_high}")
        if clamp_tokens < 1:
            raise ValueError(f"need clamp_tokens >= 1, got "
                             f"{clamp_tokens}")
        if escalate_dwell_s < 0 or clear_after_s < 0:
            raise ValueError("dwell/clear times must be >= 0")
        self.slo = slo
        self.slo_name = slo_name
        self.queue_high = queue_high
        self.queue_low = (queue_low if queue_low is not None
                          else (max(queue_high // 4, 0)
                                if queue_high is not None else None))
        if (self.queue_high is not None
                and self.queue_low >= self.queue_high):
            raise ValueError(
                f"need queue_low < queue_high, got {self.queue_low} / "
                f"{self.queue_high}")
        self.clamp_tokens = int(clamp_tokens)
        self.escalate_dwell_s = float(escalate_dwell_s)
        self.clear_after_s = float(clear_after_s)
        self.prefix_cache = prefix_cache
        self.logger = logger
        self.clock = clock
        self.tenant = tenant
        if tenant is not None and prefix_cache is not None:
            raise ValueError(
                "a per-tenant brownout cannot pause the SHARED prefix "
                "cache (that would degrade every tenant for one "
                "tenant's burn) — leave prefix_cache on the server-"
                "wide controller")
        reg = registry if registry is not None else mreg.REGISTRY
        if tenant is None:
            self._g_stage = reg.gauge(
                "serve_brownout_stage",
                "current brownout degradation stage (0 normal, 1 "
                "prefix-cache writes paused, 2 max_new_tokens clamped,"
                " 3 shedding new submits)")
            self._g_stage.set(0)
        else:
            self._g_stage = reg.gauge(
                "serve_tenant_brownout_stage",
                "current per-tenant brownout degradation stage (0 "
                "normal .. 3 shedding that tenant's submits) — one "
                "tenant's flood degrades only its own admissions",
                labels=("tenant",))
            self._g_stage.set(0, tenant=tenant)
        self.stage = 0
        self.max_stage_seen = 0
        self.transitions: list[dict] = []
        self._last_change = float("-inf")
        self._clear_since: float | None = None

    # -- the per-cycle evaluation -----------------------------------------

    def _burning(self) -> list[str]:
        """The reasons the SLO signal fires now (empty: it does not);
        queue depth and pressure come from the caller."""
        reasons = []
        if self.slo is not None and self.slo.breached(self.slo_name):
            reasons.append(f"slo:{self.slo_name or 'any'}")
        return reasons

    def evaluate(self, *, queue_depth: int = 0,
                 pressure: bool = False) -> int:
        """One evaluation, once a scheduler cycle: escalate while the
        signal fires, start or extend the clear timer while it is fully
        clear, and step one stage down per sustained `clear_after_s`.
        `pressure` is the caller's page-exhaustion signal (reason
        ``pages``): each stage lowers page demand. Returns the stage."""
        now = self.clock()
        reasons = self._burning()
        if pressure:
            reasons.append("pages")
        if (self.queue_high is not None
                and queue_depth >= self.queue_high):
            reasons.append(f"queue:{queue_depth}")
        if reasons:
            self._clear_since = None
            if (self.stage < len(STAGES) - 1
                    and now - self._last_change >= self.escalate_dwell_s):
                self._transition(self.stage + 1, now, "+".join(reasons))
            return self.stage
        # clear is stricter than not firing: the queue must also fall to
        # the low watermark, so the controller does not restore straight
        # into the load that tripped it
        clear = (self.queue_low is None
                 or queue_depth <= self.queue_low)
        if not clear or self.stage == 0:
            self._clear_since = None
            return self.stage
        if self._clear_since is None:
            self._clear_since = now
        if now - self._clear_since >= self.clear_after_s:
            self._transition(self.stage - 1, now, "recovered")
            # one stage per sustained clear period
            self._clear_since = now
        return self.stage

    def _transition(self, stage: int, now: float, reason: str) -> None:
        direction = "escalate" if stage > self.stage else "restore"
        self.stage = stage
        self.max_stage_seen = max(self.max_stage_seen, stage)
        self._last_change = now
        rec = {"stage": stage, "stage_name": STAGES[stage],
               "direction": direction, "reason": reason}
        if self.tenant is None:
            self._g_stage.set(stage)
            trace.point("serve.brownout", **rec)
            event = "serve_brownout"
        else:
            self._g_stage.set(stage, tenant=self.tenant)
            rec["tenant"] = self.tenant
            trace.point("serve.tenant_brownout", **rec)
            event = "serve_tenant_brownout"
        if self.prefix_cache is not None:
            self.prefix_cache.pause_writes(stage >= 1)
        self.transitions.append(rec)
        if self.logger is not None:
            self.logger.log(event=event, **rec)

    def force_stage(self, stage: int, *, reason: str = "drain") -> int:
        """Jump straight to `stage`, past the dwell timer (the drain
        entry point: a draining server sheds new submits while its
        in-flight work completes). Recorded like any transition."""
        if not 0 <= stage < len(STAGES):
            raise ValueError(f"stage must be in [0, {len(STAGES) - 1}], "
                             f"got {stage}")
        if stage != self.stage:
            self._transition(stage, self.clock(), reason)
            self._clear_since = None
        return self.stage

    # -- the knobs the scheduler reads ------------------------------------

    @property
    def shedding(self) -> bool:
        """True while new submits are refused with status ``shed``."""
        return self.stage >= 3

    @property
    def token_clamp(self) -> int | None:
        """The max_new_tokens bound admissions apply now (None: no
        clamp)."""
        return self.clamp_tokens if self.stage >= 2 else None
