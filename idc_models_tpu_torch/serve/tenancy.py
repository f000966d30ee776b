"""Multi-tenant serving: several tenants on ONE engine -- shared base
weights, per-tenant adapter deltas, quotas, SLOs and brownout stages --
the counterpart of ``idc_models_tpu/serve/tenancy.py``.

One parameter tree, one KV pool and one set of serving programs serve
every tenant. Each tenant may carry a low-rank LOGIT-SPACE adapter:
effective logits = ``logits + (logits @ U_t) @ V_t``, an effective head
``W (I + U_t V_t)``, applied at pick time in the window, verify and
propose programs (``models/lm.make_adapter_head_hook``). The engine
gathers each slot's tenant row by a device ``[n_slots]`` tenant-id row,
so a mix of tenants is a value, not a shape: a mixed batch is one call
and needs no new program. Because the delta is a function of the BASE
logits, all stored state stays tenant-agnostic: prefill is unchanged,
the engine's per-slot logits are base logits, and prefix-cache
snapshots are shared across tenants. An adapter that must touch the
attention or MLP weights cannot take this form; such a tenant needs a
server of its own.

**Isolation.** The scheduler enforces per-tenant quotas at admission
(resident slots, queued requests, KV pages); a tenant's TTFT SLO
(``observe/slo.py``, objective ``ttft:<tenant>``) drives that tenant's
own brownout controller, so a flooding tenant clamps and then sheds
while its neighbours stay at ``normal``.

Every accessor of the runtime takes ONE tenant and reads only that
tenant's state; the few methods that see the whole set (registration,
the stacked-adapter build, the name list) are the ones the AST scan in
``tests/test_torch_tenancy.py`` allows.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """Per-tenant admission bounds; None is unlimited on that axis.

    - `max_resident_slots`: decode slots (running and prefilling) the
      tenant may hold at once -- the floor its neighbours keep under a
      flood.
    - `max_queued`: admission-queue entries; beyond it the tenant's
      submits are refused (status ``rejected``) without touching the
      shared queue. Also sets the tenant brownout's queue watermark.
    - `kv_page_budget`: KV pool pages the tenant's admission reservations
      may hold (paged engines; exact under the default whole-budget
      decode reserve -- growth under a smaller `kv_decode_reserve` is
      not charged again).
    """

    max_resident_slots: int | None = None
    max_queued: int | None = None
    kv_page_budget: int | None = None

    def __post_init__(self):
        for field in ("max_resident_slots", "max_queued",
                      "kv_page_budget"):
            v = getattr(self, field)
            if v is not None and (not isinstance(v, int) or v < 1):
                raise ValueError(
                    f"TenantQuota.{field} must be None (unlimited) or "
                    f"an int >= 1, got {v!r} — a quota of 0 would "
                    f"admit nothing ever; unregister the tenant "
                    f"instead")


@dataclasses.dataclass(frozen=True)
class Tenant:
    """One registered tenant: its integer id (the engine's gather
    index), quota, optional adapter factors and optional TTFT SLO."""

    name: str
    tid: int
    quota: TenantQuota
    adapter: tuple | None = None         # (u [V, r], v [r, V]) host
    slo_ttft_p95_ms: float | None = None

    @property
    def slo_name(self) -> str | None:
        return (f"ttft:{self.name}"
                if self.slo_ttft_p95_ms is not None else None)


class TenantRegistry:
    """The declared tenant set: `register(...)` each tenant, then
    `build(...)` once into the `Tenancy` the server wires in. The FIRST
    registered tenant serves untagged requests unless ``default=`` names
    another."""

    def __init__(self, *, default: str | None = None):
        self._tenants: dict[str, Tenant] = {}
        self._default = default
        self._built = False

    def register(self, name: str, *, adapter=None, quota=None,
                 slo_ttft_p95_ms: float | None = None) -> Tenant:
        """Add one tenant. `adapter` is an optional ``(u, v)`` pair of
        logit-adapter factors, shapes ``[V, r]`` and ``[r, V]``, one
        (V, r) across every tenant (the engine stacks them into one
        gather table); `slo_ttft_p95_ms` declares the tenant's TTFT p95
        objective (burn-rate alerted, and its brownout's trigger)."""
        if self._built:
            raise ValueError(
                "TenantRegistry is already built — tenants register "
                "before build(); a running server's tenant set is "
                "fixed (rebuild the server to change it)")
        if not isinstance(name, str) or not name:
            raise ValueError(f"tenant name must be a non-empty string, "
                             f"got {name!r}")
        if name in self._tenants:
            raise ValueError(
                f"tenant {name!r} is already registered — tenant "
                f"names are identities; re-registering would silently "
                f"replace its adapter/quota")
        if quota is None:
            quota = TenantQuota()
        elif not isinstance(quota, TenantQuota):
            raise ValueError(f"quota must be a TenantQuota, got "
                             f"{type(quota).__name__}")
        if slo_ttft_p95_ms is not None and slo_ttft_p95_ms <= 0:
            raise ValueError(f"slo_ttft_p95_ms must be > 0, got "
                             f"{slo_ttft_p95_ms}")
        if adapter is not None:
            adapter = self._check_adapter(name, adapter)
        t = Tenant(name=name, tid=len(self._tenants), quota=quota,
                   adapter=adapter, slo_ttft_p95_ms=slo_ttft_p95_ms)
        self._tenants[name] = t
        return t

    def _check_adapter(self, name: str, adapter) -> tuple:
        """Shapes at registration (build checks V against the model):
        ``(u [V, r], v [r, V])``, one (V, r) across every tenant."""
        try:
            u, v = adapter
        except (TypeError, ValueError):
            raise ValueError(
                f"tenant {name!r}: adapter must be a (u, v) pair of "
                f"arrays with shapes [V, r] and [r, V], got "
                f"{type(adapter).__name__}") from None
        u = np.asarray(u, np.float32)
        v = np.asarray(v, np.float32)
        if u.ndim != 2 or v.ndim != 2 or u.shape[::-1] != v.shape:
            raise ValueError(
                f"tenant {name!r}: adapter shapes must be u [V, r] "
                f"and v [r, V] (transposes of each other), got "
                f"{u.shape} / {v.shape}")
        for other in self._tenants.values():
            if other.adapter is None:
                continue
            ou = other.adapter[0]
            if ou.shape != u.shape:
                raise ValueError(
                    f"tenant {name!r}: adapter shape {u.shape} != "
                    f"tenant {other.name!r}'s {ou.shape} — every "
                    f"tenant's adapter must share one [V, r] so the "
                    f"engine can stack them into a single slot-"
                    f"indexed gather table (pad the rank or register "
                    f"a zero adapter)")
            break
        return (u, v)

    def names(self) -> list[str]:
        """Registration order, which is tid order."""
        return list(self._tenants)

    def build(self, *, vocab: int | None = None, logger=None,
              registry=None, clock=time.monotonic,
              slo_short_window_s: float = 60.0,
              slo_burn_threshold: float = 2.0,
              slo_min_samples: int = 10,
              brownout_dwell_s: float = 0.25,
              brownout_clear_s: float = 1.0,
              brownout_clamp_tokens: int = 8) -> "Tenancy":
        """Freeze the tenant set into the runtime `Tenancy`: the stacked
        adapter bank (its V checked against the model's `vocab` when
        given), one SLOEngine holding every ``ttft:<name>`` objective,
        and one brownout controller for each tenant that declared an SLO
        or a queue quota (a tenant with neither has no signal to shed
        on)."""
        from idc_models_tpu_torch.observe.slo import SLO, SLOEngine
        from idc_models_tpu_torch.serve.brownout import BrownoutController

        if not self._tenants:
            raise ValueError("TenantRegistry.build() with no tenants "
                             "registered — register at least one")
        if self._default is not None and self._default not in self._tenants:
            raise ValueError(
                f"default tenant {self._default!r} is not registered "
                f"(registered: {self.names()})")
        self._built = True
        with_adapter = [t for t in self._tenants.values()
                        if t.adapter is not None]
        bank = None
        if with_adapter:
            V, r = with_adapter[0].adapter[0].shape
            if vocab is not None and V != vocab:
                raise ValueError(
                    f"adapter vocab dim {V} != model vocab {vocab} — "
                    f"the logit-space adapter maps [V] -> [V] for "
                    f"THIS model's head")
            u = np.zeros((len(self._tenants), V, r), np.float32)
            v = np.zeros((len(self._tenants), r, V), np.float32)
            for t in self._tenants.values():
                if t.adapter is not None:
                    u[t.tid], v[t.tid] = t.adapter
            # adapter-less tenants keep zero rows: their delta is exactly
            # zero, so they decode the base model through the same
            # gathered program
            bank = AdapterBank(u=u, v=v, rank=r, vocab=V)
        slo = None
        objectives = [SLO.latency(t.slo_name,
                                  threshold_s=t.slo_ttft_p95_ms / 1e3)
                      for t in self._tenants.values()
                      if t.slo_ttft_p95_ms is not None]
        if objectives:
            slo = SLOEngine(
                objectives, short_window_s=slo_short_window_s,
                long_window_s=5.0 * slo_short_window_s,
                burn_threshold=slo_burn_threshold,
                min_samples=slo_min_samples, logger=logger,
                registry=registry, clock=clock)
        brownouts = {}
        for t in self._tenants.values():
            if t.slo_name is None and t.quota.max_queued is None:
                continue
            # the watermark sits BELOW the max_queued quota: at the
            # quota submits are refused, so the queue never reaches it
            # after an admission and a watermark there would never fire
            qh = (None if t.quota.max_queued is None
                  else max((3 * t.quota.max_queued) // 4, 1))
            brownouts[t.name] = BrownoutController(
                slo=slo if t.slo_name is not None else None,
                slo_name=t.slo_name, queue_high=qh,
                clamp_tokens=brownout_clamp_tokens,
                escalate_dwell_s=brownout_dwell_s,
                clear_after_s=brownout_clear_s, logger=logger,
                registry=registry, clock=clock, tenant=t.name)
        default = self._default or next(iter(self._tenants))
        return Tenancy(dict(self._tenants), default=default, bank=bank,
                       slo=slo, brownouts=brownouts)


@dataclasses.dataclass(frozen=True)
class AdapterBank:
    """The stacked per-tenant adapter factors the engine gathers from:
    ``u [T, V, r]`` and ``v [T, r, V]``, host float32. A tenant without
    an adapter holds zero rows, so its gathered delta is exactly zero."""

    u: np.ndarray
    v: np.ndarray
    rank: int
    vocab: int


class Tenancy:
    """The built runtime the server wires through the engine, the
    scheduler and the metrics: a frozen tenant set, every lookup by ONE
    tenant name."""

    def __init__(self, tenants: dict[str, Tenant], *, default: str,
                 bank: AdapterBank | None, slo, brownouts: dict):
        self._tenants = tenants
        self.default = default
        self.bank = bank
        self.slo = slo
        self.brownouts = brownouts

    def resolve(self, name: str | None) -> Tenant:
        """The tenant a request's tag names (None: the default). An
        unknown tag is a caller error, raised loudly: lumping it into
        the default would charge one tenant's quota for another's
        traffic."""
        if name is None:
            name = self.default
        t = self._tenants.get(name)
        if t is None:
            raise ValueError(
                f"unknown tenant {name!r} (registered: "
                f"{self.names()}) — requests carry tenant= tags that "
                f"must name a registered tenant")
        return t

    def names(self) -> list[str]:
        return list(self._tenants)

    def n_tenants(self) -> int:
        return len(self._tenants)

    def quota(self, name: str) -> TenantQuota:
        return self.resolve(name).quota

    def brownout(self, name: str):
        """The tenant's own brownout controller (None when it declared
        neither an SLO nor a queue quota)."""
        return self.brownouts.get(self.resolve(name).name)

    def breached(self, name: str) -> bool:
        """The per-tenant admission signal: `SLOEngine.breached` on the
        tenant's ``ttft:<name>`` objective (False without one)."""
        t = self.resolve(name)
        if self.slo is None or t.slo_name is None:
            return False
        return self.slo.breached(t.slo_name)

    def observe_ttft(self, name: str, ttft_s: float) -> None:
        """One TTFT sample into the tenant's objective (a no-op for a
        tenant without one); the serving metrics call it."""
        t = self.resolve(name)
        if self.slo is not None and t.slo_name is not None:
            self.slo.observe(t.slo_name, ttft_s)

    def evaluate(self) -> None:
        """One burn-rate evaluation of every tenant objective, once a
        scheduler cycle (the SLOEngine walks its objectives itself)."""
        if self.slo is not None:
            self.slo.evaluate()
