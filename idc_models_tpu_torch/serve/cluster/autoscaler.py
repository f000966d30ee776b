"""Autoscaling policy over the fleet's health documents, the
counterpart of ``idc_models_tpu/serve/cluster/autoscaler.py``: pure host
logic, the same decisions from the same health stream.

The router already publishes, per replica, everything a scaling
decision legitimately reads: queue depth, load, slot/page headroom,
brownout stage, SLO burn (`Replica.health`, the in-process twin of
`/healthz`). This module turns those documents into ``"up"`` /
``"down"`` / ``"hold"`` with the two properties a production policy
needs and ad-hoc threshold code never has:

- **Purity**: `decide()` is a function of (healths, now, state,
  config) and nothing else — no wall clock, no I/O, no hidden
  counters — so every decision replays deterministically from a
  recorded health stream, and the hysteresis unit tests drive it with
  a fake clock.
- **Hysteresis + cooldown**: a scale signal must HOLD for `dwell_s`
  before it fires (one bursty tick never buys a replica), and after
  any action the policy is quiet for `cooldown_s` (a freshly added
  replica gets time to absorb load before the signal is re-read —
  without this, the up signal persists through spin-up and the fleet
  staircases to max).

Signals (live decode-capable replicas only — draining/dead/prefill
replicas neither count toward capacity nor vote):

===========================  =========================================
scale **up** when            mean queued-per-replica > ``queue_high``,
                             OR any live replica is brownout-shedding,
                             OR (paged) fleet page headroom fraction
                             < ``page_headroom``
scale **down** when          mean queued-per-replica < ``queue_low``
                             AND nobody is shedding or SLO-burning
bounded by                   ``min_replicas`` <= fleet <= ``max_replicas``
===========================  =========================================

`Autoscaler` wraps the pure function with the state threading and a
frozen-schema ``autoscale_decision`` jsonl event per ACTION (holds are
silent — drills replay the decision stream, not a heartbeat).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """The policy knobs, validated at construction so a bad config
    fails at fleet build, not on the first overload tick.

    `queue_low` must sit strictly below `queue_high`: the gap IS the
    hysteresis band — equal thresholds would oscillate a borderline
    fleet up and down every cooldown."""

    min_replicas: int = 1
    max_replicas: int = 4
    queue_high: float = 4.0
    queue_low: float = 1.0
    page_headroom: float = 0.1
    dwell_s: float = 0.5
    cooldown_s: float = 2.0

    def __post_init__(self):
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{self.min_replicas}..{self.max_replicas}")
        if not 0 <= self.queue_low < self.queue_high:
            raise ValueError(
                f"need 0 <= queue_low < queue_high (the gap is the "
                f"hysteresis band), got {self.queue_low} vs "
                f"{self.queue_high}")
        if not 0 <= self.page_headroom < 1:
            raise ValueError(f"need 0 <= page_headroom < 1, got "
                             f"{self.page_headroom}")
        if self.dwell_s < 0 or self.cooldown_s < 0:
            raise ValueError(
                f"need dwell_s >= 0 and cooldown_s >= 0, got "
                f"{self.dwell_s} / {self.cooldown_s}")


def _fresh_state() -> dict:
    return {"up_since": None, "down_since": None, "last_action_t": None}


def decide(healths, *, now: float, state: dict | None = None,
           cfg: AutoscaleConfig | None = None) -> tuple:
    """One pure decision: ``(action, reason, new_state)`` where action
    is ``"up"`` / ``"down"`` / ``"hold"``. `state` is the opaque dict a
    previous call returned (None = fresh); `healths` is the router's
    `healths()` list. The caller applies the action; this function
    only ever reads its arguments."""
    cfg = cfg if cfg is not None else AutoscaleConfig()
    st = dict(state) if state else _fresh_state()
    live = [h for h in healths
            if h["state"] == "live" and h["role"] != "prefill"]
    n = len(live)
    if n == 0:
        # nothing live to read a signal from — scaling up on zero
        # evidence is the router/operator's call (add_replica), not a
        # policy the hysteresis clock should own
        return "hold", "no live decode replica", _fresh_state()
    queued = sum(h["queue_depth"] + h["load"] for h in live)
    mean_q = queued / n
    shedding = any(h["shedding"] for h in live)
    burning = any(h["slo_breached"] for h in live)
    pages_total = sum(h["kv_pages_total"] or 0 for h in live)
    pages_used = sum(h["kv_pages_used"] or 0 for h in live)
    headroom = (1.0 - pages_used / pages_total if pages_total else None)
    up_reason = None
    if mean_q > cfg.queue_high:
        up_reason = (f"mean queued/replica {mean_q:.2f} > "
                     f"queue_high {cfg.queue_high}")
    elif shedding:
        up_reason = "a live replica is brownout-shedding"
    elif headroom is not None and headroom < cfg.page_headroom:
        up_reason = (f"fleet page headroom {headroom:.2f} < "
                     f"{cfg.page_headroom}")
    down_ok = (mean_q < cfg.queue_low and not shedding
               and not burning)
    # hysteresis dwell: a signal starts its clock on the tick it first
    # appears and fires only once it has held dwell_s; the opposite
    # signal (or quiet) resets it
    st["up_since"] = (st["up_since"] if up_reason is not None
                      and st["up_since"] is not None
                      else (now if up_reason is not None else None))
    st["down_since"] = (st["down_since"] if down_ok
                        and st["down_since"] is not None
                        else (now if down_ok else None))
    last = st["last_action_t"]
    if last is not None and now - last < cfg.cooldown_s:
        return "hold", "cooldown", st
    if (up_reason is not None and n < cfg.max_replicas
            and now - st["up_since"] >= cfg.dwell_s):
        st["last_action_t"] = now
        st["up_since"] = None
        return "up", up_reason, st
    if (down_ok and n > cfg.min_replicas
            and now - st["down_since"] >= cfg.dwell_s):
        st["last_action_t"] = now
        st["down_since"] = None
        return "down", (f"mean queued/replica {mean_q:.2f} < "
                        f"queue_low {cfg.queue_low}"), st
    if up_reason is not None and n >= cfg.max_replicas:
        return "hold", f"at max_replicas ({cfg.max_replicas})", st
    return "hold", "no signal held long enough", st


class Autoscaler:
    """The stateful wrapper the router drives once per step: threads
    `decide`'s state, and writes one frozen-schema
    ``autoscale_decision`` jsonl record per ACTION — {event, action,
    reason, live, queued, t} — so a drill replays the exact decision
    stream (holds stay silent by design)."""

    def __init__(self, cfg: AutoscaleConfig | None = None, *,
                 logger=None):
        self.cfg = cfg if cfg is not None else AutoscaleConfig()
        self.logger = logger
        self.state = _fresh_state()
        self.decisions: list[dict] = []

    def evaluate(self, healths, *, now: float) -> dict | None:
        """One tick: returns ``{"action", "reason", "live", "queued",
        "t"}`` for an up/down decision, None on hold."""
        action, reason, self.state = decide(
            healths, now=now, state=self.state, cfg=self.cfg)
        if action == "hold":
            return None
        live = [h for h in healths
                if h["state"] == "live" and h["role"] != "prefill"]
        rec = {"action": action, "reason": reason,
               "live": len(live),
               "queued": sum(h["queue_depth"] + h["load"]
                             for h in live),
               "t": round(now, 4)}
        self.decisions.append(rec)
        if self.logger is not None:
            self.logger.log(event="autoscale_decision", **rec)
        return rec

    def state_doc(self) -> dict:
        """The autoscaler block the fleet /healthz embeds:
        the policy bounds and dwell/cooldown knobs plus the LIVE
        hysteresis clocks — an operator reading the document can tell
        "quiet" from "a scale signal is dwelling right now" from
        "cooling down after an action"."""
        return {
            "min_replicas": self.cfg.min_replicas,
            "max_replicas": self.cfg.max_replicas,
            "queue_high": self.cfg.queue_high,
            "queue_low": self.cfg.queue_low,
            "dwell_s": self.cfg.dwell_s,
            "cooldown_s": self.cfg.cooldown_s,
            "up_since": self.state["up_since"],
            "down_since": self.state["down_since"],
            "last_action_t": self.state["last_action_t"],
            "decisions": len(self.decisions),
        }
