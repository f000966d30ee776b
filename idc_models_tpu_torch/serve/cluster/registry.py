"""Cross-replica prefix registry: chunk-boundary KV snapshots shared by
every replica of a cluster -- the counterpart of
``idc_models_tpu/serve/cluster/registry.py``.

Each replica's radix `PrefixCache` (``serve/prefix_cache.py``) is local
to one engine, so under a router fanning one workload over N replicas a
hot system prompt would be prefilled once PER REPLICA. The registry is
the tier above those caches: a host-memory store of chunk-boundary
snapshots keyed by the token prefix, shared by every replica in the
process.

What is stored is the packed form of the snapshot (the caches cut to the
prefix length, what `PrefixCache.set_packer` stores locally) as HOST
copies: numpy, or a CPU tensor for bf16, which numpy cannot hold. A
snapshot one replica's device owns never aliases another's: any
replica's `_unpack` pads the host copy back to t_max on its OWN device,
so one published snapshot serves engines on different cards. It is also
the prefill -> decode HANDOFF artifact: a dedicated prefill replica
drives chunks to the last boundary, each completed boundary publishes
here, and the decode replica's admission adopts the prefix without
running a chunk (``serve/cluster/router.py``).

The paged flavour does not publish: a `PagedPrefixCache` snapshot is a
list of page ids of ONE engine's pool. Paged replicas keep their local
zero-copy sharing.

Replicas in one process are stepped by one router loop, so access is
single-threaded by construction; the registry holds no locks.
"""

from __future__ import annotations

import numpy as np

from idc_models_tpu_torch.observe import metrics_registry as mreg
from idc_models_tpu_torch.serve.prefix_cache import (
    _Node, _copy_tree, _tree_bytes,
)


def _host_copy(tree):
    """A host copy of every leaf that shares no buffer with `tree`."""
    return _copy_tree(tree, host=True)


class PrefixRegistry:
    """Radix store of published chunk-boundary snapshots under a byte
    budget, LRU-evicted (never-hit snapshots first, like the local
    caches: a burst of unique tails churns its own entries, not the
    shared system prompts the registry exists for).

    `chunk` must equal every attached cache's chunk: snapshots live on
    one grid. `max_bytes` bounds the summed host bytes of stored
    snapshots."""

    def __init__(self, chunk: int, max_bytes: int, *, logger=None,
                 registry=None):
        if chunk < 1:
            raise ValueError(f"need chunk >= 1, got {chunk}")
        if max_bytes < 0:
            raise ValueError(f"need max_bytes >= 0, got {max_bytes}")
        self.chunk = int(chunk)
        self.max_bytes = int(max_bytes)
        self.logger = logger
        reg = registry if registry is not None else mreg.REGISTRY
        self._m_lookups = reg.counter(
            "cluster_prefix_lookups_total",
            "cross-replica prefix-registry lookups by outcome",
            labels=("result",))
        self._m_published = reg.counter(
            "cluster_prefix_published_total",
            "chunk-boundary snapshots published into the cross-replica "
            "prefix registry")
        self._m_bytes = reg.gauge(
            "cluster_prefix_registry_bytes",
            "host bytes of snapshots held by the cross-replica prefix "
            "registry")
        self._root = _Node()
        self._clock = 0
        self.nbytes = 0
        self.n_snapshots = 0
        self.publishes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # -- the chunk grid ---------------------------------------------------

    def _chunks(self, tokens) -> list[tuple]:
        toks = np.asarray(tokens).reshape(-1).tolist()
        n_full = len(toks) // self.chunk
        return [tuple(toks[i * self.chunk:(i + 1) * self.chunk])
                for i in range(n_full)]

    # -- publish / lookup -------------------------------------------------

    def publish(self, tokens, caches, logits) -> bool:
        """Store host copies of the snapshot for `tokens` (a length on
        the chunk grid). False (nothing stored) when the key already
        exists (the first publisher's copy keeps answering: boundary
        snapshots of the same tokens are the same chunk program's
        output) or the snapshot alone exceeds the whole budget."""
        toks = np.asarray(tokens).reshape(-1)
        if toks.size == 0 or toks.size % self.chunk:
            raise ValueError(
                f"prefix length {toks.size} is not a multiple of the "
                f"chunk {self.chunk} — snapshots live on chunk "
                f"boundaries only")
        node = self._root
        for edge in self._chunks(toks):
            node = node.children.setdefault(edge, _Node(node, edge))
        self._clock += 1
        node.stamp = self._clock
        if node.snapshot is not None:
            return False
        snap = (_host_copy(caches), _host_copy(logits))
        size = _tree_bytes(snap)
        if size > self.max_bytes:
            self._prune(node)
            return False
        node.snapshot = snap
        node.nbytes = size
        self.nbytes += size
        self.n_snapshots += 1
        self.publishes += 1
        self._m_published.inc()
        while self.nbytes > self.max_bytes and self.n_snapshots > 1:
            self._evict_lru(protect=node)
        self._m_bytes.set(self.nbytes)
        self._log(event="cluster_prefix_publish",
                  prefix_tokens=int(toks.size), nbytes=size)
        return True

    def lookup(self, tokens):
        """Longest published prefix of `tokens` on the chunk grid:
        ``(start, packed_caches, logits)`` as fresh host copies, or
        (0, None, None) on a miss."""
        node = self._root
        best, best_depth, depth = None, 0, 0
        for edge in self._chunks(tokens):
            node = node.children.get(edge)
            if node is None:
                break
            depth += 1
            if node.snapshot is not None:
                best, best_depth = node, depth
        if best is None:
            self.misses += 1
            self._m_lookups.inc(result="miss")
            return 0, None, None
        self._clock += 1
        best.stamp = self._clock
        best.hit_count += 1
        self.hits += 1
        self._m_lookups.inc(result="hit")
        caches, logits = best.snapshot
        return (best_depth * self.chunk, _host_copy(caches),
                _host_copy(logits))

    def covered(self, tokens) -> int:
        """Chunk-grid tokens of `tokens` the registry already holds: the
        router's handoff short-circuit (a hot prompt need not be
        prefilled again anywhere). A pure read: no hit or LRU
        bookkeeping."""
        node, depth, best = self._root, 0, 0
        for edge in self._chunks(tokens):
            node = node.children.get(edge)
            if node is None:
                break
            depth += 1
            if node.snapshot is not None:
                best = depth
        return best * self.chunk

    # -- eviction ---------------------------------------------------------

    def _walk(self):
        stack = [self._root]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n.snapshot is not None:
                yield n

    def _evict_lru(self, protect=None) -> None:
        victims = [n for n in self._walk() if n is not protect]
        if not victims:
            return
        v = min(victims, key=lambda n: (min(n.hit_count, 1), n.stamp))
        self.nbytes -= v.nbytes
        v.snapshot, v.nbytes = None, 0
        self.n_snapshots -= 1
        self.evictions += 1
        self._m_bytes.set(self.nbytes)
        self._prune(v)

    def _prune(self, node) -> None:
        while (node is not self._root and node.snapshot is None
               and not node.children and node.parent is not None):
            del node.parent.children[node.edge]
            node = node.parent

    # -- observability ----------------------------------------------------

    def summary(self) -> dict:
        return {
            "cluster_prefix_published": self.publishes,
            "cluster_prefix_hits": self.hits,
            "cluster_prefix_misses": self.misses,
            "cluster_prefix_evictions": self.evictions,
            "cluster_prefix_snapshots": self.n_snapshots,
            "cluster_prefix_bytes": self.nbytes,
        }

    def _log(self, **record) -> None:
        if self.logger is not None:
            self.logger.log(**record)
