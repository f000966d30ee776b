"""Deterministic, seeded fault injection for the serving path -- the
counterpart of ``idc_models_tpu/serve/faults.py``.

The plan is indexed by the scheduler's cycle counter, and every fault is
a pure function of (plan, tick), so a faulted run replays bit for bit.

Fault kinds (`ServeFault.kind`):

- ``nan_logits``      overwrite a slot's last-token logits row with NaN
                      at a tick: the per-window slot health check must
                      catch it before a token is sampled from it;
- ``garbage_logits``  the finite flavour (+-1e32), which only the
                      magnitude bound sees;
- ``prefill_error``   the next prefill-chunk dispatch raises
                      `InjectedPrefillError` (request-scoped);
- ``stall``           the tick sleeps `seconds` first;
- ``crash``           the tick raises `InjectedEngineCrash` after
                      failing every in-flight entry: the hard death the
                      request journal (``serve/journal.py``) recovers;
- ``burst``           `n` synthetic requests (prompts a pure function of
                      (plan.seed, tick, i)) are submitted at the tick:
                      the overload wave the brownout controller sheds.

The plan is threaded through ``Scheduler(fault_plan=...)`` /
``LMServer(fault_plan=...)``; with none armed the fault path is one
``is None`` check a tick.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence

import numpy as np

from idc_models_tpu_torch.faults import format_spec_error, parse_id_field
from idc_models_tpu_torch.serve.api import Request


class InjectedEngineCrash(RuntimeError):
    """A declarative `crash` fault firing: the whole engine dies
    mid-run. In-flight entries are failed through the scheduler's
    normal engine-failure cleanup before this propagates, and a request
    journal makes the loss recoverable."""


class InjectedPrefillError(RuntimeError):
    """A declarative `prefill_error` fault firing: one prefill-chunk
    dispatch dies. Request-scoped -- with a retry policy armed the
    scheduler quarantines only the prefilling request."""


KINDS = ("nan_logits", "garbage_logits", "prefill_error", "stall",
         "crash", "burst")
GRAMMAR = ("comma-separated kind:ticks[:param] groups; ticks = a single "
           "tick, an inclusive a-b range, or a +-joined list; param = "
           "slot for nan_logits/garbage_logits, seconds for stall, "
           "request count for burst (crash/prefill_error take none)")

# the kinds whose third spec field means what
_PARAM_OF = {"nan_logits": "slot", "garbage_logits": "slot",
             "stall": "seconds", "burst": "n"}


@dataclasses.dataclass(frozen=True)
class ServeFault:
    """One declarative serving fault, fired at scheduler cycle `tick`.
    `slot` targets the logit-poisoning kinds; `seconds` is the stall
    length; `n` / `prompt_len` / `budget` shape a burst's synthetic
    requests."""

    kind: str
    tick: int
    slot: int = 0
    seconds: float = 0.05
    n: int = 8
    prompt_len: int = 4
    budget: int = 8

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown serve fault kind {self.kind!r}; "
                             f"valid kinds: {', '.join(KINDS)}")
        if self.tick < 0:
            raise ValueError(f"tick must be >= 0, got {self.tick}")
        if self.slot < 0:
            raise ValueError(f"slot must be >= 0, got {self.slot}")
        if not self.seconds > 0:
            raise ValueError(f"stall seconds must be > 0, got "
                             f"{self.seconds}")
        if self.n < 1 or self.prompt_len < 1 or self.budget < 1:
            raise ValueError(
                f"burst needs n/prompt_len/budget >= 1, got "
                f"{self.n}/{self.prompt_len}/{self.budget}")


class ServeFaultPlan:
    """A deterministic serve fault schedule: `at(tick)` and
    `bursts_at(tick)` are pure functions of the plan and the tick, and a
    burst's prompts a pure function of (seed, tick, index), so the same
    plan over the same trace fails, recovers and answers the same way."""

    def __init__(self, faults: Sequence[ServeFault] = (), *,
                 seed: int = 0):
        self.faults = tuple(faults)
        self.seed = int(seed)
        for f in self.faults:
            if not isinstance(f, ServeFault):
                raise TypeError(f"expected ServeFault, got {type(f)}")

    def at(self, tick: int) -> list[ServeFault]:
        """The non-burst faults firing at scheduler cycle `tick` (bursts
        are arrivals, which the server injects through `bursts_at`)."""
        return [f for f in self.faults
                if f.tick == tick and f.kind != "burst"]

    def bursts_at(self, tick: int) -> list[ServeFault]:
        return [f for f in self.faults
                if f.tick == tick and f.kind == "burst"]

    def burst_requests(self, fault: ServeFault, *, vocab: int,
                       t_max: int) -> list[Request]:
        """The synthetic requests one burst fault submits, seeded by
        (plan.seed, fault.tick, i); their ids carry a ``!burst`` prefix
        no caller id collides with."""
        p_len = min(fault.prompt_len, t_max - 1)
        budget = min(fault.budget, t_max - p_len)
        out = []
        for i in range(fault.n):
            rng = np.random.default_rng((self.seed, fault.tick, i))
            prompt = tuple(int(x) for x in rng.integers(0, vocab, p_len))
            out.append(Request(id=f"!burst-{fault.tick}-{i}",
                               prompt=prompt, max_new_tokens=budget))
        return out

    @property
    def max_tick(self) -> int:
        return max((f.tick for f in self.faults), default=-1)

    def __repr__(self) -> str:
        return (f"ServeFaultPlan(faults={list(self.faults)!r}, "
                f"seed={self.seed})")


def parse_serve_fault_spec(spec: str, *, seed: int = 0) -> ServeFaultPlan:
    """The CLI serve-fault grammar, tick-indexed:

        "nan_logits:3:0"         poison slot 0's logits at tick 3
        "stall:5-8:0.02"         20 ms stall on ticks 5..8
        "burst:2:16,crash:40"    16-request burst at tick 2, crash at 40

    Every parse error names the valid kinds and shows the grammar
    (`faults.format_spec_error`)."""
    faults: list[ServeFault] = []
    for group in spec.split(","):
        group = group.strip()
        if not group:
            continue
        parts = group.split(":")
        if len(parts) not in (2, 3):
            raise ValueError(format_spec_error(
                group, "want kind:ticks[:param]", kinds=KINDS,
                grammar=GRAMMAR))
        kind, ticks = parts[0].strip(), parts[1].strip()
        if kind not in KINDS:
            raise ValueError(format_spec_error(
                group, f"unknown fault kind {kind!r}", kinds=KINDS,
                grammar=GRAMMAR))
        kw = {}
        if len(parts) == 3:
            param = parts[2].strip()
            field = _PARAM_OF.get(kind)
            if field is None:
                raise ValueError(format_spec_error(
                    group, f"fault kind {kind!r} takes no parameter, "
                           f"got {param!r}", kinds=KINDS,
                    grammar=GRAMMAR))
            try:
                kw[field] = (float(param) if field == "seconds"
                             else int(param))
            except ValueError:
                raise ValueError(format_spec_error(
                    group, f"bad {field} parameter {param!r}",
                    kinds=KINDS, grammar=GRAMMAR)) from None
        tick_list = parse_id_field(ticks, what="ticks", group=group,
                                   kinds=KINDS, grammar=GRAMMAR)
        try:
            faults.extend(ServeFault(kind, int(t), **kw)
                          for t in tick_list)
        except ValueError as e:
            # out-of-range values (a negative tick or slot, zero seconds
            # or burst size) get the same message shape as syntax errors
            raise ValueError(format_spec_error(
                group, str(e), kinds=KINDS, grammar=GRAMMAR)) from None
    return ServeFaultPlan(faults, seed=seed)
