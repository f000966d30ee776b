"""One serving replica under the cluster router: an `LMServer` with the
identity, role, lifecycle state and health surface the router places on
-- the counterpart of ``idc_models_tpu/serve/cluster/replica.py``.

A replica owns its OWN metrics registry (N replicas' serve_* gauges
never stomp each other, and each can serve an honest per-replica
`/healthz` through `observe.MetricsExporter`), its own journal (the
failover artifact: a killed replica's unfinished requests migrate from
its journal onto survivors), optionally its own brownout controller
(the DRAIN mechanism: draining pins it at the shed stage), and, with
``role="prefill"``, the `prefill_only` entry point that drives chunked
prefill to the last chunk boundary and publishes the boundary snapshots
into the cluster prefix registry WITHOUT decoding (the disaggregation
handoff; ``serve/cluster/registry.py``).

Lifecycle: ``live`` (placeable) -> ``draining`` (unplaceable, finishes
its work) -> gone, or ``live`` -> ``dead`` (killed or failed: the router
migrates its journaled work). State only moves forward; a drained
replica that should serve again is rebuilt.

Where the JAX package carves each replica a one-device mesh, the port
puts replica i on an explicit `torch.device` (``build_replica(device=)``).
"""

from __future__ import annotations

import time

import numpy as np

ROLES = ("mixed", "prefill", "decode")


class Replica:
    """Identity and lifecycle around one `LMServer`. The router is the
    only submitter; `state` gates placement, and the server's own
    brownout and backpressure gate admission below that."""

    def __init__(self, replica_id: str, server, *, role: str = "mixed",
                 journal_path=None, registry=None,
                 clock=time.monotonic):
        if role not in ROLES:
            raise ValueError(f"role must be one of {ROLES}, got "
                             f"{role!r}")
        self.replica_id = str(replica_id)
        self.server = server
        self.role = role
        self.journal_path = journal_path
        # the replica's own MetricsRegistry (None = the process one),
        # kept so a caller can arm a per-replica MetricsExporter on it
        self.registry = registry
        self.clock = clock
        self.state = "live"
        self._last_step: float | None = None

    # -- the serving surface the router drives ---------------------------

    def submit(self, request, *, parent_span=None) -> bool:
        if self.state != "live":
            raise RuntimeError(
                f"replica {self.replica_id} is {self.state} — the "
                f"router must not place on it")
        return self.server.submit(request, parent_span=parent_span)

    def step(self):
        """One scheduler tick; stamps the freshness the health document
        reports. Engine failures propagate: the router's step loop turns
        them into a replica death and a journal migration. While
        DRAINING the brownout stays pinned at shed (its per-cycle
        evaluation would otherwise restore it once the queue looks
        clear: a drain is an operator's decision, not a burn signal to
        hysteresis away)."""
        self._last_step = self.clock()
        b = self.server.brownout
        if self.state == "draining" and b is not None and b.stage < 3:
            b.force_stage(3, reason="drain")
        return self.server.step()

    def poll(self, rid):
        return self.server.poll(rid)

    def idle(self) -> bool:
        return self.server.scheduler.idle()

    def load(self) -> int:
        return self.server.scheduler.load()

    # -- placement signals ------------------------------------------------

    def placeable(self) -> bool:
        """True when the router may place NEW work here: live, decode-
        capable, not shedding, queue below its backpressure bound (page
        headroom is per request: `can_take`)."""
        if self.state != "live" or self.role == "prefill":
            return False
        b = self.server.brownout
        if b is not None and b.shedding:
            return False
        sch = self.server.scheduler
        return len(sch.queue) < sch.queue.max_depth

    def can_take(self, p_len: int, budget: int) -> bool:
        """`placeable` and the paged engine's page-headroom gate for this
        request (which reclaims LRU prefix snapshots as local admission
        would: True means admission will succeed)."""
        return (self.placeable()
                and self.server.engine.can_admit_pages(p_len, budget))

    def health(self) -> dict:
        """The placement-signal document, the in-process twin of the
        /healthz endpoint (``observe/exporter.py``), read off the live
        objects: queue depth, load, slot and page headroom, brownout
        stage, SLO burn and host-loop freshness."""
        s = self.server
        eng = s.engine
        sch = s.scheduler
        slo = s.metrics.slo
        pages = eng.page_stats() if eng.paged else None
        b = s.brownout
        return {
            "replica": self.replica_id,
            "role": self.role,
            "state": self.state,
            "status": "ok" if self.state == "live" else self.state,
            "queue_depth": len(sch.queue),
            "load": sch.load(),
            "free_slots": len(eng.free_slots()),
            "slot_occupancy": eng.occupancy(),
            "kv_pages_total": (None if pages is None
                               else pages["pages_total"]),
            "kv_pages_used": (None if pages is None
                              else pages["pages_used"]),
            "brownout_stage": 0 if b is None else b.stage,
            "shedding": bool(b is not None and b.shedding),
            "slo_breached": (bool(slo.breached())
                             if slo is not None else False),
            "last_tick_age_s": (
                None if self._last_step is None
                else round(self.clock() - self._last_step, 4)),
        }

    # -- disaggregated prefill --------------------------------------------

    def prefill_only(self, prompt) -> int:
        """Drive chunked prefill of `prompt` to completion WITHOUT
        decoding: every completed chunk boundary snapshots into this
        replica's prefix cache (and, wired to the cluster
        `PrefixRegistry`, publishes there); then the slot is released
        before any window decodes from it. Returns the boundary length
        now covered: the prefill half of the handoff. The engine's
        normal `start_prefill` lookup runs first, so a prompt already
        published costs only its uncached suffix."""
        eng = self.server.engine
        if self.state != "live":
            raise RuntimeError(
                f"replica {self.replica_id} is {self.state}")
        if eng.prefill_chunk is None:
            raise RuntimeError(
                "prefill_only needs an engine built with prefill_chunk "
                "— boundary snapshots are the handoff artifact")
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if prompt.size + 1 > eng.t_max:
            raise ValueError(
                f"prompt length {prompt.size} leaves no room inside "
                f"t_max {eng.t_max}")
        free = eng.free_slots()
        if not free:
            raise RuntimeError(
                f"prefill replica {self.replica_id} has no free slot")
        slot = free[0]
        # budget 1 is a placeholder: the final prefill_step inserts the
        # request into the batch row, and the release right after
        # vacates it before a window could decode from it
        eng.start_prefill(slot, prompt, 1)
        try:
            while not eng.prefill_step(slot):
                pass
        except Exception:
            # drop the partial reservation so the slot is not leaked,
            # then let the router's handoff path decide the replica's fate
            if slot in eng.prefilling():
                eng.cancel_prefill(slot)
            raise
        eng.release(slot)
        return (prompt.size // eng.prefill_chunk) * eng.prefill_chunk

    # -- lifecycle --------------------------------------------------------

    def drain(self) -> None:
        """Begin a graceful drain: the router stops placing here, the
        scheduler's sticky drain mode sheds any straggling direct submit
        (with or without a brownout controller), and an armed brownout
        jumps to its shed stage. Work in flight steps to completion;
        once `idle()` the replica can leave the fleet."""
        if self.state == "dead":
            raise RuntimeError(
                f"replica {self.replica_id} is dead — drain is for "
                f"live replicas (failover migrates dead ones)")
        self.state = "draining"
        self.server.scheduler.begin_drain()
        if self.server.brownout is not None:
            self.server.brownout.force_stage(3, reason="drain")

    def kill(self) -> None:
        """A hard replica death (simulated or acknowledged): the state
        flips to ``dead``, the admission surface closes and the journal
        is flushed shut. The journal on disk is all that survives, which
        is what the router's failover replays onto the survivors.
        Idempotent."""
        if self.state == "dead":
            return
        self.state = "dead"
        self.server.close()


def build_replica(params, *, replica_id: str, embed_dim: int,
                  num_heads: int, num_blocks: int, t_max: int,
                  device=None, role: str = "mixed", n_slots: int = 4,
                  window: int = 8, prefill_chunk: int | None = None,
                  prefix_cache_mb: float = 0.0, shared_prefix=None,
                  journal_path=None, retry=None,
                  brownout_queue_high: int | None = None,
                  brownout_dwell_s: float = 0.25,
                  brownout_clear_s: float = 1.0,
                  brownout_clamp_tokens: int = 8, slo=None,
                  logger=None, clock=time.monotonic,
                  **server_kw) -> Replica:
    """One cluster replica on `device` (a card of the fleet's; None is
    the server's default, the card), with its OWN `MetricsRegistry`,
    its local prefix cache (wired to the cluster `shared_prefix`
    registry when given), its journal and, when `brownout_queue_high`
    is set, its own brownout controller (the drain mechanism doubles as
    overload protection). Everything else, `block_impl` included, passes
    through to `LMServer`."""
    from idc_models_tpu_torch.observe.metrics_registry import (
        MetricsRegistry,
    )
    from idc_models_tpu_torch.serve.api import LMServer
    from idc_models_tpu_torch.serve.brownout import BrownoutController
    from idc_models_tpu_torch.serve.prefix_cache import PrefixCache

    reg = MetricsRegistry()
    prefix_cache = None
    paged = server_kw.get("kv_page_size") is not None
    if paged and shared_prefix is not None:
        raise ValueError(
            "paged replicas cannot join the cluster prefix registry: "
            "their snapshots are physical page ids of one engine's "
            "pool (they keep local zero-copy sharing instead)")
    if prefix_cache_mb and prefix_cache_mb > 0:
        if prefill_chunk is None:
            raise ValueError("prefix_cache_mb needs prefill_chunk")
        if paged:
            # LMServer builds the matching PagedPrefixCache, which binds
            # the engine's allocator at construction
            server_kw["prefix_cache_mb"] = prefix_cache_mb
        else:
            prefix_cache = PrefixCache(
                prefill_chunk, int(prefix_cache_mb * 1024 * 1024),
                logger=logger, registry=reg, shared=shared_prefix)
    elif shared_prefix is not None:
        raise ValueError(
            "a shared prefix registry needs a local prefix cache "
            "(prefix_cache_mb > 0) to adopt into and publish from")
    brownout = None
    if brownout_queue_high is not None:
        brownout = BrownoutController(
            slo=slo, queue_high=brownout_queue_high,
            clamp_tokens=brownout_clamp_tokens,
            escalate_dwell_s=brownout_dwell_s,
            clear_after_s=brownout_clear_s, logger=logger,
            registry=reg, clock=clock)
    server = LMServer(
        params, embed_dim=embed_dim, num_heads=num_heads,
        num_blocks=num_blocks, t_max=t_max, n_slots=n_slots,
        window=window, device=device, prefill_chunk=prefill_chunk,
        prefix_cache=prefix_cache, journal=journal_path, retry=retry,
        brownout=brownout, slo=slo, logger=logger, clock=clock,
        registry=reg, **server_kw)
    return Replica(replica_id, server, role=role,
                   journal_path=journal_path, registry=reg,
                   clock=clock)
