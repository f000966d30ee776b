"""Deterministic, seeded fault injection for federated training.

The counterpart of the classic part of ``idc_models_tpu/faults.py``:
declarative per-client fault plans that are pure functions of (plan,
round), so a run under a plan replays bit-identically, with the same
grammar and error text as the JAX package. Faults land on the client
UPDATE tensors after local training and before detection and
aggregation (`make_fedavg_round(faults=plan)`):

- ``crash``      the client never reports: its weight is forced to 0;
- ``straggler``  the client reports the server of round r-k;
- ``nan`` / ``inf``  the client reports non-finite tensors (caught by
                 ``drop_nonfinite``);
- ``scale``      the client reports server + s*(update - server): finite
                 but huge, which only a robust aggregator bounds;
- ``sign_flip``  the client reports server - s*(update - server).

Population-scale plans and the data-pipeline hooks (``flaky`` /
``with_retries``) are not ported yet (ROADMAP A5-rest, A1-rest).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence

import numpy as np
import torch

# fault codes -- the integers the round branches on
OK = 0
CRASH = 1
STRAGGLER = 2
NAN = 3
INF = 4
SCALE = 5
SIGN_FLIP = 6

KINDS = ("crash", "straggler", "nan", "inf", "scale", "sign_flip")
_CODE = {"crash": CRASH, "straggler": STRAGGLER, "nan": NAN, "inf": INF,
         "scale": SCALE, "sign_flip": SIGN_FLIP}
_KIND_OF = {v: k for k, v in _CODE.items()}


def kind_of(code: int) -> str:
    """The human name of a fault code ("ok" for OK)."""
    return _KIND_OF.get(int(code), "ok")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One declarative fault: `kind` applied to `client` on `rounds`
    (None = every round). `scale` parameterizes the scale/sign_flip
    attackers; `staleness` is the straggler's lag k (params from round
    r−k)."""

    kind: str
    client: int
    rounds: tuple[int, ...] | None = None
    scale: float = 1.0
    staleness: int = 1

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {KINDS}")
        if self.client < 0:
            raise ValueError(f"client must be >= 0, got {self.client}")
        if not np.isfinite(self.scale):
            raise ValueError(f"scale must be finite, got {self.scale} "
                             f"(use kind='nan'/'inf' for non-finite "
                             f"poisoning)")
        if self.staleness < 1:
            raise ValueError(f"staleness must be >= 1, got "
                             f"{self.staleness}")
        if self.rounds is not None:
            object.__setattr__(self, "rounds",
                               tuple(int(r) for r in self.rounds))


class FaultPlan:
    """A deterministic per-client fault schedule for a federated run.

    `codes(r)` is a pure function of the plan and the round index, so a
    run under the plan replays bit-identically: same plan + same rng
    seed -> same round trajectory, down to the last bit. When several faults name the same client for the
    same round, the LAST one listed wins.
    """

    def __init__(self, n_clients: int, faults: Sequence[Fault] = ()):
        if n_clients < 1:
            raise ValueError(f"need n_clients >= 1, got {n_clients}")
        self.n_clients = int(n_clients)
        self.faults = tuple(faults)
        for f in self.faults:
            if f.client >= self.n_clients:
                raise ValueError(
                    f"fault {f.kind!r} names client {f.client} but the "
                    f"plan covers {self.n_clients} clients")
        lags = {f.staleness for f in self.faults
                if f.kind == "straggler"}
        if len(lags) > 1:
            # ONE stale server tree is threaded through a round, so
            # mixed lags would silently collapse to the max -- refuse rather than run a different fault model
            # than the plan declares
            raise ValueError(
                f"straggler faults in one plan must share a single "
                f"staleness, got {sorted(lags)}; use separate plans "
                f"(or rounds=) for mixed lags")

    @classmethod
    def byzantine(cls, n_clients: int, n_byzantine: int, *,
                  kind: str = "sign_flip", scale: float = 1.0,
                  seed: int = 0,
                  rounds: Sequence[int] | None = None) -> "FaultPlan":
        """Seeded attacker sampling: `n_byzantine` distinct clients are
        drawn with `seed` and given the same attack. The draw is
        deterministic -- the canonical way to build the "k of n clients
        are Byzantine" experiment reproducibly."""
        if not 0 <= n_byzantine <= n_clients:
            raise ValueError(f"need 0 <= n_byzantine <= {n_clients}, "
                             f"got {n_byzantine}")
        ids = np.random.default_rng(seed).choice(
            n_clients, size=n_byzantine, replace=False)
        return cls(n_clients, [
            Fault(kind, int(c), rounds=tuple(rounds) if rounds else None,
                  scale=scale) for c in sorted(ids)])

    def active(self, round_idx: int) -> list[Fault]:
        return [f for f in self.faults
                if f.rounds is None or round_idx in f.rounds]

    def codes(self, round_idx: int) -> tuple[np.ndarray, np.ndarray]:
        """(codes [n_clients] int32, scales [n_clients] float32) for one
        round -- the arrays the round branches on."""
        codes = np.zeros((self.n_clients,), np.int32)
        scales = np.ones((self.n_clients,), np.float32)
        for f in self.active(round_idx):
            codes[f.client] = _CODE[f.kind]
            scales[f.client] = f.scale
        return codes, scales

    def staleness(self, round_idx: int) -> int:
        """The stale-params lag k for this round's stragglers (max over
        the round's active straggler faults; 1 when none)."""
        ks = [f.staleness for f in self.active(round_idx)
              if f.kind == "straggler"]
        return max(ks) if ks else 1

    @property
    def max_staleness(self) -> int:
        ks = [f.staleness for f in self.faults if f.kind == "straggler"]
        return max(ks) if ks else 0

    def __repr__(self) -> str:
        return (f"FaultPlan(n_clients={self.n_clients}, "
                f"faults={list(self.faults)!r})")


GRAMMAR = ("comma-separated kind:clients[:param] groups; clients = a "
           "single id, an inclusive a-b range, or a +-joined list; "
           "param = scale (optionally x-prefixed) for scale/sign_flip, "
           "staleness lag for straggler (crash/nan/inf take none)")


def format_spec_error(group: str, detail: str, *, kinds=KINDS,
                      grammar=GRAMMAR) -> str:
    """One message shape for every fault-spec parse failure (the JAX
    package's serving grammar shares it): the offending group, what was
    wrong with it, the full grammar, and the valid kinds -- so a
    mistyped drill flag teaches its own syntax instead of
    bare-rejecting."""
    return (f"bad fault group {group!r}: {detail} (grammar: {grammar}; "
            f"valid kinds: {', '.join(kinds)})")


def parse_id_field(field: str, *, what: str, group: str, kinds=KINDS,
                   grammar=GRAMMAR) -> list[int]:
    """The shared id-list grammar both spec parsers target with
    `field`: a single integer, an inclusive ``a-b`` range, or a
    ``+``-joined list (client ids here; the JAX package's serving plan
    parses tick indices with it too)."""
    try:
        if "-" in field:
            a, b = field.split("-", 1)
            return list(range(int(a), int(b) + 1))
        return [int(c) for c in field.split("+")]
    except ValueError:
        raise ValueError(format_spec_error(
            group, f"bad {what} field {field!r}", kinds=kinds,
            grammar=grammar)) from None


def parse_fault_spec(spec: str, n_clients: int) -> FaultPlan:
    """CLI fault grammar: comma-separated ``kind:clients[:param]``
    groups, clients as a single id, an inclusive ``a-b`` range, or a
    ``+``-joined list. The third field is the kind's OWN parameter --
    scale (optionally ``x``-prefixed) for scale/sign_flip, staleness
    lag for straggler -- and is rejected for kinds that take none
    (crash/nan/inf), so a mistyped drill fails loudly instead of
    silently running a different fault model. Every parse error
    enumerates the valid kinds and shows the grammar
    (`format_spec_error`).

        "sign_flip:0-2:x1000,crash:5"     3 sign-flip attackers + crash
        "scale:1+4:100"                   2 scaling attackers
        "straggler:3:2"                   one straggler at lag 2
    """
    faults: list[Fault] = []
    for group in spec.split(","):
        group = group.strip()
        if not group:
            continue
        parts = group.split(":")
        if len(parts) not in (2, 3):
            raise ValueError(format_spec_error(
                group, "want kind:clients[:param]"))
        kind, clients = parts[0].strip(), parts[1].strip()
        if kind not in KINDS:
            raise ValueError(format_spec_error(
                group, f"unknown fault kind {kind!r}"))
        kw = {}
        if len(parts) == 3:
            param = parts[2].strip()
            try:
                if kind in ("scale", "sign_flip"):
                    kw["scale"] = float(param.lstrip("x"))
                elif kind == "straggler":
                    kw["staleness"] = int(param)
                else:
                    raise ValueError(format_spec_error(
                        group, f"fault kind {kind!r} takes no "
                               f"parameter, got {param!r}"))
            except ValueError as e:
                if "bad fault group" in str(e):
                    raise
                raise ValueError(format_spec_error(
                    group, f"bad parameter {param!r} for kind "
                           f"{kind!r}")) from None
        ids = parse_id_field(clients, what="clients", group=group)
        faults.extend(Fault(kind, int(c), **kw) for c in ids)
    return FaultPlan(n_clients, faults)


def apply_faults(codes: torch.Tensor, scales: torch.Tensor,
                 new_params: dict[str, torch.Tensor],
                 new_state: dict[str, torch.Tensor], weight: torch.Tensor,
                 params: dict[str, torch.Tensor],
                 state: dict[str, torch.Tensor],
                 stale_params: dict[str, torch.Tensor],
                 stale_state: dict[str, torch.Tensor]):
    """Apply one round's fault codes to the C client updates.

    `codes` / `scales` / `weight` are [C]; `new_*` leaves carry the
    leading [C] client axis; `params` / `state` are the incoming server
    weights and `stale_*` the round r-k server's. Non-float leaves pass
    through untouched. Returns the faulted (new_params, new_state,
    weight), new tensors (the inputs are not modified)."""
    k = codes.shape[0]
    weight = torch.where(codes == CRASH, 0.0, weight)

    def leafwise(new, server, stale):
        if not new.is_floating_point():
            return new
        shape = (k,) + (1,) * (new.dim() - 1)
        c = codes.reshape(shape)
        s = scales.reshape(shape).to(new.dtype)
        delta = new - server[None]
        out = torch.where(c == STRAGGLER, stale[None], new)
        out = torch.where(c == NAN, torch.full((), float("nan"),
                                               dtype=new.dtype,
                                               device=new.device), out)
        out = torch.where(c == INF, torch.full((), float("inf"),
                                               dtype=new.dtype,
                                               device=new.device), out)
        out = torch.where(c == SCALE, server[None] + s * delta, out)
        return torch.where(c == SIGN_FLIP, server[None] - s * delta, out)

    new_params = {n: leafwise(v, params[n], stale_params[n])
                  for n, v in new_params.items()}
    new_state = {n: leafwise(v, state[n], stale_state[n])
                 for n, v in new_state.items()}
    return new_params, new_state, weight
