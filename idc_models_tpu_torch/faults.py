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

Population-scale plans (`PopulationFaultPlan`) address VIRTUAL client
ids and are evaluated per cohort, in O(cohort) (`federated/population.py`,
`federated/async_fedavg.py`). The data-pipeline hooks ``flaky`` and
``with_retries`` inject and absorb transient read failures around any
read callable, such as the loads of ``data/pipeline.py``'s
``FileStream``.
"""

from __future__ import annotations

import dataclasses
import functools
import re
from collections.abc import Callable, Sequence

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


# ---------------------------------------------------------------------------
# Population-addressable fault plans (federated/population.py scale)
# ---------------------------------------------------------------------------
#
# `FaultPlan` addresses clients by POSITION in a materialized stack of
# client shards. At population scale (10k+ virtual clients, a sampled
# cohort per round) a plan addresses clients by their VIRTUAL id and
# stays O(cohort) to evaluate: a pure function of (plan, round, cohort
# ids) that never materializes a population-sized array.


@dataclasses.dataclass(frozen=True)
class PopulationFault:
    """One declarative population-scale fault: `kind` applied on
    `rounds` (None = every round) to either an explicit tuple of
    virtual-client ids (`clients`) or a seeded `fraction` of the whole
    population (0 < fraction <= 1; which clients fall in the fraction
    is a stable pure function of (plan seed, client id), so a
    fraction-crashed client is crashed on every listed round)."""

    kind: str
    rounds: tuple[int, ...] | None = None
    clients: tuple[int, ...] | None = None
    fraction: float | None = None
    scale: float = 1.0
    staleness: int = 1

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {KINDS}")
        if (self.clients is None) == (self.fraction is None):
            raise ValueError("exactly one of clients= / fraction= must "
                             "be given (explicit virtual ids, or a "
                             "seeded population fraction)")
        if self.clients is not None:
            if not self.clients:
                raise ValueError("clients= must name at least one id")
            if any(c < 0 for c in self.clients):
                raise ValueError(f"client ids must be >= 0, got "
                                 f"{sorted(self.clients)[0]}")
            object.__setattr__(self, "clients",
                               tuple(int(c) for c in self.clients))
        if self.fraction is not None and not 0.0 < self.fraction <= 1.0:
            raise ValueError(f"fraction must be in (0, 1], got "
                             f"{self.fraction}")
        if not np.isfinite(self.scale):
            raise ValueError(f"scale must be finite, got {self.scale}")
        if self.staleness < 1:
            raise ValueError(f"staleness must be >= 1, got "
                             f"{self.staleness}")
        if self.rounds is not None:
            object.__setattr__(self, "rounds",
                               tuple(int(r) for r in self.rounds))


class PopulationFaultPlan:
    """A deterministic fault schedule addressing the VIRTUAL population.

    `codes_for(r, ids)` is a pure function of (plan, round, cohort ids)
    returning arrays aligned to the cohort: O(cohort) work and memory,
    independent of the population size. `delay_unit_s` turns a
    straggler's staleness lag into a wall-clock completion delay (lag k
    completes k * delay_unit_s late) for the async server and the sync
    round's barrier, so one plan drives both the stale-params fault
    model and the wall-clock drills."""

    def __init__(self, population: int,
                 faults: Sequence[PopulationFault] = (), *,
                 seed: int = 0, delay_unit_s: float = 0.0):
        if population < 1:
            raise ValueError(f"need population >= 1, got {population}")
        if delay_unit_s < 0:
            raise ValueError(f"delay_unit_s must be >= 0, got "
                             f"{delay_unit_s}")
        self.population = int(population)
        self.faults = tuple(faults)
        self.seed = int(seed)
        self.delay_unit_s = float(delay_unit_s)
        for f in self.faults:
            if f.clients is not None:
                bad = [c for c in f.clients if c >= self.population]
                if bad:
                    raise ValueError(
                        f"fault {f.kind!r} names client c{bad[0]} but "
                        f"the population has {self.population} virtual "
                        f"clients (ids 0..{self.population - 1})")
        lags = {f.staleness for f in self.faults
                if f.kind == "straggler"}
        if len(lags) > 1:
            # as FaultPlan: ONE stale server is threaded through a round
            raise ValueError(
                f"straggler faults in one plan must share a single "
                f"staleness, got {sorted(lags)}; use separate plans "
                f"(or rounds=) for mixed lags")

    def active(self, round_idx: int) -> list[PopulationFault]:
        return [f for f in self.faults
                if f.rounds is None or round_idx in f.rounds]

    def _in_fraction(self, f: PopulationFault,
                     ids: np.ndarray) -> np.ndarray:
        """[len(ids)] bool: which of `ids` fall inside the fault's seeded
        population fraction, stable per client id across rounds. The
        fault's index is folded into the draw, so two fraction faults of
        one plan select independently (one shared uniform would make the
        smaller fraction a subset of the larger, and last-listed-wins
        would erase the earlier fault)."""
        fidx = self.faults.index(f)
        hit = np.zeros(len(ids), bool)
        for i, cid in enumerate(np.asarray(ids, np.int64)):
            u = np.random.default_rng(
                (self.seed, 0xFA, fidx, int(cid))).random()
            hit[i] = u < f.fraction
        return hit

    def _hits(self, f: PopulationFault, ids: np.ndarray) -> np.ndarray:
        if f.clients is not None:
            return np.isin(ids, np.asarray(f.clients, np.int64))
        return self._in_fraction(f, ids)

    def codes_for(self, round_idx: int,
                  ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(codes int32, scales float32) aligned to the cohort `ids` for
        one round. When several faults cover the same client on the same
        round, the LAST one listed wins (FaultPlan semantics)."""
        ids = np.asarray(ids, np.int64)
        codes = np.zeros((len(ids),), np.int32)
        scales = np.ones((len(ids),), np.float32)
        for f in self.active(round_idx):
            hit = self._hits(f, ids)
            codes[hit] = _CODE[f.kind]
            scales[hit] = f.scale
        return codes, scales

    def staleness(self, round_idx: int) -> int:
        ks = [f.staleness for f in self.active(round_idx)
              if f.kind == "straggler"]
        return max(ks) if ks else 1

    @property
    def max_staleness(self) -> int:
        ks = [f.staleness for f in self.faults if f.kind == "straggler"]
        return max(ks) if ks else 0

    def delay_s(self, round_idx: int, ids: np.ndarray) -> np.ndarray:
        """[len(ids)] float64 completion delays for the cohort: a
        straggler at lag k completes k * delay_unit_s late, everyone else
        at 0. The sync round sleeps max(delay), the barrier a synchronous
        protocol cannot avoid; the async server sees the completion
        arrive late instead."""
        ids = np.asarray(ids, np.int64)
        delay = np.zeros((len(ids),), np.float64)
        if self.delay_unit_s == 0.0:
            return delay
        for f in self.active(round_idx):
            if f.kind == "straggler":
                delay[self._hits(f, ids)] = f.staleness * self.delay_unit_s
        return delay

    def __repr__(self) -> str:
        return (f"PopulationFaultPlan(population={self.population}, "
                f"faults={list(self.faults)!r}, seed={self.seed}, "
                f"delay_unit_s={self.delay_unit_s})")


POP_GRAMMAR = (
    "comma-separated kind:rounds[:param][@clients] groups; rounds = a "
    "single round, an inclusive a-b range, or a +-joined list; param = "
    "scale (optionally x-prefixed) for scale/sign_flip, staleness lag "
    "for straggler, or a population fraction like 0.1% for any kind; "
    "clients = @-attached comma-separated c-prefixed virtual ids "
    "(e.g. @c97,c4012)")

_CLIENT_TOKEN = re.compile(r"c\d+")


def parse_population_fault_spec(spec: str, population: int, *,
                                seed: int = 0,
                                delay_unit_s: float = 0.0
                                ) -> PopulationFaultPlan:
    """CLI grammar for population-addressable fault plans:

        "straggler:3-6:2@c97,c4012"   lag-2 stragglers on rounds 3-6,
                                      virtual clients 97 and 4012
        "crash:2:0.1%"                a seeded 0.1% of the population
                                      crashes on round 2
        "sign_flip:0-9:x1000@c5"      one x1000 sign-flip attacker

    Clients address the VIRTUAL population by c-prefixed id (the cohort
    sampler decides whether they take part in a round); a trailing `%`
    param selects a seeded population fraction instead. Every parse
    failure teaches the grammar (`format_spec_error`)."""
    # client lists are comma-separated INSIDE a group ("@c97,c4012"):
    # re-attach bare c<id> tokens to the group they continue
    groups: list[str] = []
    for token in spec.split(","):
        token = token.strip()
        if not token:
            continue
        if groups and _CLIENT_TOKEN.fullmatch(token):
            groups[-1] += "," + token
        else:
            groups.append(token)
    return PopulationFaultPlan(
        population, [_parse_population_group(g) for g in groups],
        seed=seed, delay_unit_s=delay_unit_s)


def _parse_population_group(group: str) -> PopulationFault:
    err = functools.partial(format_spec_error, group,
                            grammar=POP_GRAMMAR)
    clients: tuple[int, ...] | None = None
    body = group
    if "@" in group:
        body, client_field = group.split("@", 1)
        ids = []
        for tok in client_field.split(","):
            tok = tok.strip()
            if not _CLIENT_TOKEN.fullmatch(tok):
                raise ValueError(err(
                    f"bad client token {tok!r} (want c-prefixed "
                    f"virtual ids like c97)"))
            ids.append(int(tok[1:]))
        clients = tuple(ids)
    parts = [p.strip() for p in body.split(":")]
    if len(parts) not in (2, 3):
        raise ValueError(err("want kind:rounds[:param][@clients]"))
    kind = parts[0]
    if kind not in KINDS:
        raise ValueError(err(f"unknown fault kind {kind!r}"))
    rounds = (None if parts[1] == "*" else tuple(
        parse_id_field(parts[1], what="rounds", group=group,
                       grammar=POP_GRAMMAR)))
    kw: dict = {}
    fraction = None
    if len(parts) == 3:
        param = parts[2]
        if param.endswith("%"):
            try:
                fraction = float(param[:-1]) / 100.0
            except ValueError:
                raise ValueError(err(
                    f"bad fraction {param!r}")) from None
            if not 0.0 < fraction <= 1.0:
                raise ValueError(err(
                    f"fraction {param!r} must be in (0%, 100%]"))
        elif kind in ("scale", "sign_flip"):
            try:
                kw["scale"] = float(param.lstrip("x"))
            except ValueError:
                raise ValueError(err(
                    f"bad parameter {param!r} for kind "
                    f"{kind!r}")) from None
        elif kind == "straggler":
            try:
                kw["staleness"] = int(param)
            except ValueError:
                raise ValueError(err(
                    f"bad parameter {param!r} for kind "
                    f"{kind!r}")) from None
        else:
            raise ValueError(err(
                f"fault kind {kind!r} takes no parameter, got "
                f"{param!r} (a population fraction needs the % "
                f"suffix)"))
    if fraction is not None and clients is not None:
        raise ValueError(err(
            "give EITHER a fraction param OR an @clients list, "
            "not both"))
    if fraction is None and clients is None:
        raise ValueError(err(
            "population faults must name their targets: an @clients "
            "list (e.g. @c97,c4012) or a fraction param (e.g. 0.1%)"))
    try:
        return PopulationFault(kind, rounds=rounds, clients=clients,
                               fraction=fraction, **kw)
    except ValueError as e:
        raise ValueError(err(str(e))) from None


# ---------------------------------------------------------------------------
# Transient data-pipeline read failures
# ---------------------------------------------------------------------------


class TransientReadError(IOError):
    """An injected transient read failure (the retryable kind: an NFS
    blip, an object-store 5xx, a preempted decode worker)."""


def flaky(fn: Callable, *, failure_rate: float, seed: int = 0,
          exception=TransientReadError) -> Callable:
    """Wrap a read callable so a seeded `failure_rate` fraction of calls
    raises `exception` BEFORE invoking `fn`. Which call indices fail is a
    pure function of (seed, index): two wrappers built with the same
    seed fail on exactly the same calls, so a test can replay its
    failure schedule."""
    if not 0.0 <= failure_rate <= 1.0:
        raise ValueError(f"failure_rate must be in [0, 1], got "
                         f"{failure_rate}")
    counter = {"i": 0}

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        i = counter["i"]
        counter["i"] += 1
        if np.random.default_rng((seed, i)).random() < failure_rate:
            raise exception(f"injected transient read failure "
                            f"(call {i}, seed {seed})")
        return fn(*args, **kwargs)

    return wrapped


def with_retries(fn: Callable, *, attempts: int = 3,
                 exceptions=(TransientReadError,)) -> Callable:
    """Retry `fn` up to `attempts` times on the given transient
    exceptions, re-raising the last failure: the consumer-side hook that
    turns a transient read failure into a bounded retry instead of a
    dead pipeline."""
    if attempts < 1:
        raise ValueError(f"need attempts >= 1, got {attempts}")

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        for attempt in range(attempts):
            try:
                return fn(*args, **kwargs)
            except exceptions:
                if attempt == attempts - 1:
                    raise
        raise AssertionError("unreachable")

    return wrapped
