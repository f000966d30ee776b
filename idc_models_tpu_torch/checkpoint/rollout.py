"""Zero-downtime weight rollout: stage -> canary -> promote | rollback,
the counterpart of ``idc_models_tpu/checkpoint/rollout.py``.

`RolloutController` is a state machine over one live `LMServer`:

1. **staging** -- the candidate (a parameter tree, or a sharded
   checkpoint directory restored whole) is spot-checked through the live
   engine's own prefill (`SlotEngine.spot_check_params`): non-finite or
   blown-up logits roll back here, before any request is routed onto the
   new weights.
2. **canary** -- a config-identical second server over the candidate
   (`LMServer.canary_clone`) takes a fraction of the submits. Routing is
   tenant-affine: a tenant's whole traffic hashes onto one side, so its
   prefix locality and quota accounting never straddle the split;
   untagged requests hash by id. Canary requests finish on the canary,
   so the client sees exactly one Result an id whichever way the
   rollout ends.
3. **decide** -- after `canary_requests` canary finishes, canary error
   statuses are held against `error_budget` and the canary's TTFT p95
   against `ttft_slack` times the live one's. Healthy: **promote**
   (`swap_params` on the live engine, the canary drained and closed).
   Unhealthy: **rollback** (the canary drained and closed; the live
   weights were never touched).

Every transition goes through the live server's `metrics.on_rollout`
(the ``serve_rollout`` event and the ``serve_rollout_stage_code``
gauge). `run_with_rollout` replays a trace through the controller,
opening the rollout a set fraction into the trace so that the live side
has TTFT samples to judge the canary against.
"""

from __future__ import annotations

import hashlib
from pathlib import Path


class RolloutError(RuntimeError):
    """Rollout API misuse (a wrong stage, a controller used twice); the
    message teaches the right sequence."""


class RolloutController:
    """Drives ONE candidate-weights rollout over a live `LMServer`.

    `candidate` is a parameter tree (JAX-shaped, host arrays) or a
    sharded checkpoint directory (``checkpoint/sharded.py``). A directory
    is restored whole, with ``mesh=None, rules=None``: the serving engine
    runs on one device and takes no partition rules yet (ROADMAP
    A9-dist).

    `canary_fraction` is the traffic share routed onto the candidate
    while the canary is open; `canary_requests` canary finishes are
    required before the verdict, and a trace that ends earlier rolls
    back (insufficient evidence is not health). `ttft_slack` bounds the
    canary's TTFT p95 at slack x the live p95; `error_budget` is the
    tolerated share of canary finishes with an error status (0: any
    error rolls back)."""

    def __init__(self, server, candidate, *,
                 canary_fraction: float = 0.25, canary_requests: int = 4,
                 ttft_slack: float = 2.0, error_budget: float = 0.0,
                 logger=None):
        if not 0.0 < canary_fraction <= 1.0:
            raise ValueError(
                f"canary_fraction must be in (0, 1], got "
                f"{canary_fraction!r} — a zero fraction starves the "
                f"canary of evidence forever, and promoting without "
                f"evidence is not a rollout")
        if canary_requests < 1:
            raise ValueError(f"canary_requests must be >= 1, got "
                             f"{canary_requests!r}")
        self.live = server
        self.canary = None
        self.canary_fraction = float(canary_fraction)
        self.canary_requests = int(canary_requests)
        self.ttft_slack = float(ttft_slack)
        self.error_budget = float(error_budget)
        self.stage = "idle"
        self.reason: str | None = None
        self._canary_done: list = []
        if isinstance(candidate, (str, Path)):
            from idc_models_tpu_torch.checkpoint.sharded import (
                restore_sharded,
            )

            candidate = restore_sharded(candidate, mesh=None, rules=None,
                                        logger=logger)
        self.candidate = candidate

    @property
    def canary_finishes(self) -> int:
        """Canary results banked toward the verdict so far."""
        return len(self._canary_done)

    # -- state machine ---------------------------------------------------

    def _transition(self, stage: str, *, outcome=None,
                    reason=None) -> None:
        self.stage = stage
        self.reason = reason
        self.live.metrics.on_rollout(
            stage=stage, outcome=outcome,
            canary_requests=len(self._canary_done), reason=reason)

    def start(self) -> bool:
        """Stage the candidate: spot-check it through the live engine,
        then open the canary. False: the candidate failed staging and the
        rollout is already rolled_back; the live server never stopped
        serving and no request touched the bad weights."""
        if self.stage != "idle":
            raise RolloutError(
                f"start() in stage {self.stage!r} — a controller "
                f"drives ONE rollout; build a fresh one for the next "
                f"candidate")
        self._transition("staging")
        engine = self.live.engine
        if engine.paged and engine._pending is not None:
            # the paged spot-check runs a chunk through the pool, which
            # the window in flight is writing: collect it first
            self.live.quiesce()
        check = engine.spot_check_params(self.candidate)
        if not check["ok"]:
            detail = {1: "non-finite logits",
                      2: (f"magnitude-blown logits "
                          f"(max |x| = {check['max_abs']:.3g})")}
            self._transition(
                "rolled_back", outcome="rolled_back",
                reason=f"staging spot-check failed: "
                       f"{detail[check['code']]}")
            return False
        self.canary = self.live.canary_clone(self.candidate)
        self._transition("canary")
        return True

    def routes_to_canary(self, request) -> bool:
        """The tenant-affine split: the first 8 hex digits of the sha256
        of the tenant (of the id when untagged), over 2**32, below the
        fraction. Deterministic, so a tenant's traffic never straddles
        the two prefix caches and quota ledgers."""
        if self.canary is None or self.stage != "canary":
            return False
        key = (request.tenant if request.tenant is not None
               else request.id)
        h = int(hashlib.sha256(key.encode()).hexdigest()[:8], 16)
        return h / 0x100000000 < self.canary_fraction

    def target(self, request):
        """The server `request` is routed onto: the canary for its
        fraction while the canary is open, else the live one."""
        return self.canary if self.routes_to_canary(request) else self.live

    def submit(self, request) -> bool:
        """Route one submit: the canary's fraction onto the candidate
        while the canary is open, everything else (and everything before
        staging or after the verdict) onto the live server. False on
        backpressure or a shed, as `LMServer.submit`."""
        return self.target(request).submit(request)

    def step(self) -> list:
        """One cycle of both sides, merged; decides as soon as the
        canary has `canary_requests` finishes."""
        out = self.live.step()
        if self.canary is not None and self.stage == "canary":
            done = self.canary.step()
            self._canary_done.extend(done)
            out.extend(done)
            if len(self._canary_done) >= self.canary_requests:
                self._decide()
        return out

    def poll(self, rid: str):
        r = self.live.poll(rid)
        if r is None and self.canary is not None:
            r = self.canary.poll(rid)
        return r

    def idle(self) -> bool:
        return (self.live.scheduler.idle()
                and (self.canary is None
                     or self.canary.scheduler.idle()))

    def begin_drain(self) -> None:
        """Stop admitting on both sides (`LMServer.begin_drain`): what
        each accepted still finishes there, and the verdict still comes
        from the canary's finishes (`finish`)."""
        self.live.begin_drain()
        if self.canary is not None:
            self.canary.begin_drain()

    def finish(self) -> str:
        """End-of-trace settlement: an open canary decides now, by the
        normal comparison with `canary_requests` finishes banked, else by
        rolling back (a trace that ended before the canary earned its
        evidence is not promoted). Returns the terminal stage."""
        if self.stage == "canary":
            if len(self._canary_done) >= self.canary_requests:
                self._decide()
            else:
                self._rollback(
                    f"trace ended with {len(self._canary_done)} canary "
                    f"finishes < canary_requests="
                    f"{self.canary_requests} — not enough evidence to "
                    f"promote")
        return self.stage

    def results(self) -> list:
        """Every finished Result of both sides: exactly one an id (each
        id goes to one side)."""
        merged = {r.id: r for r in self.live.results()}
        if self.canary is not None:
            for r in self.canary.results():
                merged.setdefault(r.id, r)
        return list(merged.values())

    # -- decision --------------------------------------------------------

    def _decide(self) -> None:
        bad = [r for r in self._canary_done
               if r.status not in ("ok", "timeout")]
        if len(bad) > self.error_budget * len(self._canary_done):
            first = f"{bad[0].status} {bad[0].error or ''}".strip()
            self._rollback(
                f"canary error burn: {len(bad)}/"
                f"{len(self._canary_done)} finishes errored (budget "
                f"{self.error_budget:.0%}); first: {first}")
            return
        lp95 = self.live.summary().get("serve_ttft_ms_p95")
        cp95 = self.canary.summary().get("serve_ttft_ms_p95")
        if (lp95 is not None and cp95 is not None and lp95 > 0
                and cp95 > self.ttft_slack * lp95):
            self._rollback(
                f"canary SLO burn: TTFT p95 {cp95:.1f} ms > "
                f"{self.ttft_slack:.1f}x live {lp95:.1f} ms")
            return
        self._promote()

    def _drain_canary(self) -> None:
        # every canary request finishes ON the canary: its weights passed
        # the spot-check, so its outputs are results, not casualties
        if self.canary is None:
            return
        while not self.canary.scheduler.idle():
            self._canary_done.extend(self.canary.step())
        self.canary.close()

    def _promote(self) -> None:
        self._drain_canary()
        self.live.swap_params(self.candidate)
        self._transition("promoted", outcome="promoted")

    def _rollback(self, reason: str) -> None:
        self._drain_canary()
        self._transition("rolled_back", outcome="rolled_back",
                         reason=reason)


def run_with_rollout(server, trace, candidate, *,
                     start_after: float = 0.25, realtime: bool = False,
                     on_full: str = "block", stop=None, **controller_kw):
    """Replay ``[(arrival_s, Request), ...]`` while rolling `candidate`
    out mid-trace: `LMServer.run`'s loop (``serve.api.replay``) with the
    controller in the submit path. The rollout opens once `start_after`
    of the trace has been offered, and the trace drains through promote
    or rollback either way. `stop()` drains early, as in `LMServer.run`:
    both sides finish what they accepted, then the rollout settles
    (`finish`). Returns ``(results, controller)``, with exactly one
    Result an offered trace id."""
    from idc_models_tpu_torch.serve.api import replay

    if not 0.0 <= start_after < 1.0:
        raise ValueError(f"start_after must be in [0, 1), got "
                         f"{start_after!r} — starting at/after the end "
                         f"of the trace means the canary never sees a "
                         f"request")
    ctl = RolloutController(server, candidate, **controller_kw)
    start_idx = int(len(trace) * start_after)

    def on_offer(i):
        # the rollout opens inside the offer loop: a burst (every
        # arrival at 0) offers the whole trace in one tick
        if ctl.stage == "idle" and i >= start_idx:
            ctl.start()

    out = replay(ctl, trace, clock=server.scheduler.clock,
                 realtime=realtime, on_full=on_full, on_offer=on_offer,
                 stop=stop)
    ctl.finish()
    # canary requests that finished inside the verdict's drain never came
    # back through step(): one Result a trace id
    have = {r.id for r in out}
    out.extend(r for r in ctl.results() if r.id not in have)
    return out, ctl
