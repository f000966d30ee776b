"""Radix prefix cache: KV snapshots at chunk boundaries, reused across
requests that share a token prefix -- the counterpart of
``idc_models_tpu/serve/prefix_cache.py``.

With chunked prefill every completed chunk boundary is a natural
snapshot point: the caches at boundary k*C are a pure function of
tokens[:k*C]. This module stores those snapshots in a radix tree whose
edges are chunk-sized token tuples, and `SlotEngine.start_prefill` asks
it for the longest cached prefix before prefilling only the suffix.

Two storage flavours share one radix/LRU core (`_RadixPrefixBase`: the
chunk grid, the longest-prefix walk, never-hit-first LRU eviction,
pruning, counters, the serve_prefix_* instruments and summary):

- `PrefixCache` (contiguous engines) stores TENSOR snapshots under a
  byte budget. The port's chunk fold writes its caches in place, so a
  hit hands back clones and never the stored master: the next chunk
  would otherwise overwrite the snapshot. A hit resumes bit for bit as
  a cold prefill of the same prompt, because the stored snapshot is the
  chunk program's own output for those tokens. Snapshots stay on the
  device by default; ``host=True`` stores host copies (numpy, or a CPU
  tensor for bf16, which numpy cannot hold) -- no server or verb passes
  it yet, as in the JAX package. With ``shared=`` (a cluster
  `PrefixRegistry`, ``serve/cluster/registry.py``) every insert also
  publishes a host copy there, and a lookup the registry knows a longer
  prefix for adopts it: a hot prompt prefilled on one replica is reused
  on every other.
- `PagedPrefixCache` (paged engines) stores refcounted page lists under
  a page budget -- no copies; see its docstring.

In both flavours eviction only ever costs extra prefill: a lookup after
an evict misses and the engine prefills from scratch. Counters feed
`ServingMetrics.summary()` and stream as `serve_prefix_*` events when a
logger is attached.
"""

from __future__ import annotations

import numpy as np
import torch

from idc_models_tpu_torch.observe import metrics_registry as mreg


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _leaves(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _leaves(x)
    elif tree is not None:
        yield tree


def _map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return None if tree is None else fn(tree)


def _tree_bytes(tree) -> int:
    return sum(int(a.nbytes) for a in _leaves(tree))


def _copy_leaf(a, host: bool):
    """A copy that shares no buffer with `a`: on the device (a clone, or
    a numpy leaf made a tensor), or on the host (a numpy copy; a bf16
    tensor, which numpy cannot hold, as a CPU tensor)."""
    if torch.is_tensor(a):
        a = a.detach()
        if not host:
            return a.clone()
        if a.dtype == torch.bfloat16:
            return a.to("cpu", copy=True)
        return a.cpu().numpy().copy()
    if host:
        return np.array(a, copy=True)
    return torch.from_numpy(np.array(a, copy=True))


def _copy_tree(tree, host: bool):
    return _map(lambda a: _copy_leaf(a, host), tree)


class _Node:
    __slots__ = ("children", "snapshot", "nbytes", "stamp", "parent",
                 "edge", "hit_count")

    def __init__(self, parent=None, edge=None):
        self.children: dict[tuple, _Node] = {}
        self.snapshot = None          # storage-flavour payload or None
        self.nbytes = 0
        self.stamp = 0                # LRU clock at last touch
        self.parent = parent
        self.edge = edge              # the chunk tuple leading here
        self.hit_count = 0            # lookups served from this node


class _RadixPrefixBase:
    """The storage-agnostic radix/LRU core of both flavours: chunk-grid
    tokenization, the longest-cached-prefix walk with hit/miss
    bookkeeping, radix insert-or-dedupe, never-hit-first LRU victims,
    pruning, and the serve_prefix_* instruments, counters and summary. Subclasses own what a snapshot is, how it is handed out
    and the budget it lives under; `_release_snapshot(node)` is the one
    storage hook eviction calls."""

    def __init__(self, chunk: int, *, logger=None, registry=None):
        if chunk < 1:
            raise ValueError(f"need chunk >= 1, got {chunk}")
        self.chunk = int(chunk)
        self.logger = logger
        reg = registry if registry is not None else mreg.REGISTRY
        self._m_lookups = reg.counter(
            "serve_prefix_lookups_total",
            "prefix-cache lookups by outcome", labels=("result",))
        self._m_evictions = reg.counter(
            "serve_prefix_evictions_total", "LRU snapshot evictions")
        self._m_bytes = reg.gauge(
            "serve_prefix_cache_bytes", "bytes of stored snapshots")
        # brownout stage 1 (serve/brownout.py) pauses inserts; lookups
        # keep serving hits
        self.writes_paused = False
        self._root = _Node()
        self._clock = 0
        self.n_snapshots = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.hit_tokens = 0           # prefix tokens served from cache
        self.lookup_tokens = 0        # prompt tokens seen by lookup

    # -- the chunk grid ---------------------------------------------------

    def _chunks(self, tokens) -> list[tuple]:
        toks = np.asarray(tokens).reshape(-1).tolist()
        n_full = len(toks) // self.chunk
        return [tuple(toks[i * self.chunk:(i + 1) * self.chunk])
                for i in range(n_full)]

    def _check_boundary(self, tokens) -> np.ndarray:
        toks = np.asarray(tokens).reshape(-1)
        if toks.size == 0 or toks.size % self.chunk:
            raise ValueError(
                f"prefix length {toks.size} is not a multiple of the "
                f"chunk {self.chunk} — snapshots live on chunk "
                f"boundaries only")
        return toks

    # -- lookup / insert plumbing -----------------------------------------

    def _lookup_node(self, tokens):
        """Longest cached prefix on the chunk grid, with the hit/miss
        bookkeeping applied: ``(node, start)`` or ``(None, 0)``."""
        node = self._root
        best, best_depth = None, 0
        depth = 0
        for edge in self._chunks(tokens):
            node = node.children.get(edge)
            if node is None:
                break
            depth += 1
            if node.snapshot is not None:
                best, best_depth = node, depth
        n_tokens = int(np.asarray(tokens).size)
        self.lookup_tokens += n_tokens
        if best is None:
            self.misses += 1
            self._m_lookups.inc(result="miss")
            self._log(event="serve_prefix_miss", prompt_tokens=n_tokens)
            return None, 0
        self._clock += 1
        best.stamp = self._clock
        best.hit_count += 1
        self.hits += 1
        self._m_lookups.inc(result="hit")
        start = best_depth * self.chunk
        self.hit_tokens += start
        self._log(event="serve_prefix_hit", prefix_tokens=start,
                  prompt_tokens=n_tokens)
        return best, start

    def _insert_node(self, toks):
        """Create-or-walk the radix path for `toks` and LRU-touch it;
        the node, or None when a snapshot already sits there (the
        existing entry keeps answering)."""
        node = self._root
        for edge in self._chunks(toks):
            node = node.children.setdefault(edge, _Node(node, edge))
        self._clock += 1
        node.stamp = self._clock
        return None if node.snapshot is not None else node

    # -- eviction ---------------------------------------------------------

    def _walk(self):
        stack = [self._root]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n.snapshot is not None:
                yield n

    def _evict_lru(self, protect=None, victim=None) -> int:
        """Evict ONE snapshot: never-hit ones before hit-proven ones, LRU
        within each class, so a burst of unique-tail prompts churns its
        own snapshots instead of the shared system prefix. `victim`
        overrides the choice (the paged flavour's reclaim ranks by
        freeable pages first). Returns what `_release_snapshot` freed
        (pool pages for the paged flavour, 0 for tensors)."""
        if victim is None:
            victims = [n for n in self._walk() if n is not protect]
            if not victims:
                return 0
            victim = min(victims,
                         key=lambda n: (min(n.hit_count, 1), n.stamp))
        v = victim
        freed_bytes = v.nbytes
        freed = self._release_snapshot(v)
        v.snapshot, v.nbytes = None, 0
        self.n_snapshots -= 1
        self.evictions += 1
        self._m_evictions.inc()
        self._m_bytes.set(self.nbytes)
        self._log(event="serve_prefix_evict", freed_bytes=freed_bytes)
        self._prune(v)
        return freed

    def _release_snapshot(self, node) -> int:
        raise NotImplementedError

    def _prune(self, node) -> None:
        while (node is not self._root and node.snapshot is None
               and not node.children and node.parent is not None):
            del node.parent.children[node.edge]
            node = node.parent

    def pause_writes(self, paused: bool) -> None:
        """Brownout stage 1's side effect: toggle snapshot storage.
        Reads are never paused, so a warm cache keeps serving hits."""
        self.writes_paused = bool(paused)

    def clear(self) -> None:
        """Drop every snapshot (each one released through
        `_release_snapshot`: bytes for tensors, pool pages for the paged
        flavour); the counters stay."""
        for node in list(self._walk()):
            self._release_snapshot(node)
        self._root = _Node()
        self.n_snapshots = 0
        self._m_bytes.set(self.nbytes)

    # -- observability ----------------------------------------------------

    def hit_rate(self) -> float | None:
        total = self.hits + self.misses
        return None if total == 0 else self.hits / total

    def token_hit_rate(self) -> float | None:
        return (None if self.lookup_tokens == 0
                else self.hit_tokens / self.lookup_tokens)

    def summary(self) -> dict:
        """The `serve_prefix_*` fields merged into the serving rollup,
        the same keys for both flavours."""
        return {
            "serve_prefix_hits": self.hits,
            "serve_prefix_misses": self.misses,
            "serve_prefix_evictions": self.evictions,
            "serve_prefix_hit_rate": (
                None if self.hit_rate() is None
                else round(self.hit_rate(), 4)),
            "serve_prefix_token_hit_rate": (
                None if self.token_hit_rate() is None
                else round(self.token_hit_rate(), 4)),
            "serve_prefix_bytes": self.nbytes,
            "serve_prefix_snapshots": self.n_snapshots,
        }

    def _log(self, **record) -> None:
        if self.logger is not None:
            self.logger.log(**record)


class PrefixCache(_RadixPrefixBase):
    """Radix tree of chunk-boundary TENSOR snapshots with an LRU byte
    budget -- the contiguous engines' flavour.

    `chunk` fixes the snapshot grid: node depth d holds the state after
    tokens[:d*chunk]. `max_bytes` bounds the summed bytes of stored
    snapshots (0 disables storage: lookups always miss).

    `shared` is a cluster-wide `PrefixRegistry` on the same chunk grid:
    inserts publish each boundary snapshot there (it keeps host copies,
    which any replica's engine pads and moves onto its own device), and
    a lookup whose local walk falls short adopts the registry's longer
    prefix. Tensor snapshots only: a paged snapshot's page ids name
    pages of one engine's pool."""

    def __init__(self, chunk: int, max_bytes: int, *,
                 host: bool = False, logger=None, registry=None,
                 shared=None):
        if max_bytes < 0:
            raise ValueError(f"need max_bytes >= 0, got {max_bytes}")
        super().__init__(chunk, logger=logger, registry=registry)
        self.max_bytes = int(max_bytes)
        self.host = bool(host)
        self._pack = None             # (caches, n_tokens) -> stored tree
        self._unpack = None           # stored tree -> caller tree
        self.nbytes = 0
        if shared is not None and shared.chunk != self.chunk:
            raise ValueError(
                f"shared registry chunk {shared.chunk} != cache chunk "
                f"{self.chunk} — snapshots live on one chunk grid")
        self.shared = shared
        self.shared_hits = 0
        self.shared_hit_tokens = 0

    def set_packer(self, pack, unpack) -> None:
        """Install a storage transform: ``pack(caches, n_tokens)`` maps
        the live caches to what is stored (the engine cuts rows to the
        prefix: positions past it are zeros by construction);
        ``unpack(stored)`` maps a stored tree back to what lookup hands
        out (padded back to t_max on the engine's device). `unpack` must
        return FRESH tensors, never views of the stored master. Identity
        when unset."""
        self._pack, self._unpack = pack, unpack

    # -- lookup / insert --------------------------------------------------

    def lookup(self, tokens):
        """Longest cached prefix of `tokens` on the chunk grid:
        ``(start, caches, logits)`` with `start` tokens already in the
        returned caches ((0, None, None) on a miss). Both halves are
        fresh copies, safe for the in-place chunk fold; the stored
        master is untouched. A longer prefix in the shared registry is
        adopted: unpacked, stored locally (so the next lookup needs no
        registry hop; a no-op while writes are paused) and handed out.
        The pure-read `covered` gates the registry's copy, so a prefix
        the local cache already holds costs nothing there."""
        best, start = self._lookup_node(tokens)
        if (self.shared is not None
                and self.shared.covered(tokens) > start):
            s2, packed, logits2 = self.shared.lookup(tokens)
            if s2 > start:
                self.shared_hits += 1
                self.shared_hit_tokens += s2 - start
                self._log(event="serve_prefix_shared_hit",
                          prefix_tokens=s2,
                          prompt_tokens=int(np.asarray(tokens).size))
                caches = (self._unpack(packed) if self._unpack is not None
                          else _copy_tree(packed, self.host))
                self.insert(np.asarray(tokens).reshape(-1)[:s2], caches,
                            logits2)
                return s2, caches, _copy_tree(logits2, self.host)
        if best is None:
            return 0, None, None
        caches, logits = best.snapshot
        caches = (self._unpack(caches) if self._unpack is not None
                  else _copy_tree(caches, self.host))
        return start, caches, _copy_tree(logits, self.host)

    def insert(self, tokens, caches, logits) -> bool:
        """Store the state after `tokens` (a length on the chunk grid).
        Copies the tensors; False (nothing stored) when the snapshot
        alone exceeds the whole budget or the key is already present
        (the existing entry is LRU-touched)."""
        toks = self._check_boundary(tokens)
        if self.writes_paused:
            return False
        node = self._insert_node(toks)
        if node is None:
            return False
        if self._pack is not None:
            caches = self._pack(caches, int(toks.size))
        snap = (_copy_tree(caches, self.host),
                _copy_tree(logits, self.host))
        size = _tree_bytes(snap)
        if size > self.max_bytes:
            self._prune(node)
            return False
        node.snapshot = snap
        node.nbytes = size
        self.nbytes += size
        self.n_snapshots += 1
        while self.nbytes > self.max_bytes and self.n_snapshots > 1:
            self._evict_lru(protect=node)
        self._m_bytes.set(self.nbytes)
        # publish to the cluster registry, which copies to the host and
        # dedupes by key (republishing an adopted prefix is a no-op);
        # local eviction never unpublishes: the registry has its own
        # budget and LRU
        if self.shared is not None:
            self.shared.publish(toks, snap[0], snap[1])
        return True

    def _release_snapshot(self, node) -> int:
        self.nbytes -= node.nbytes
        return 0

    def summary(self) -> dict:
        out = super().summary()
        if self.shared is not None:
            # only with a registry attached: a one-replica summary keeps
            # its keys
            out["serve_prefix_shared_hits"] = self.shared_hits
            out["serve_prefix_shared_hit_tokens"] = self.shared_hit_tokens
        return out


class PagedPrefixCache(_RadixPrefixBase):
    """Radix prefix cache for the PAGED engine: a snapshot is a list of
    pool page ids plus a copy of the boundary logits -- never a copy of
    the K/V itself.

    Chunk boundaries land on the page grid (page_size divides the chunk,
    which the engine enforces), so the pages covering a completed
    boundary are fully written and -- chunks splice [start, p_end),
    decode appends at >= p_len -- never written again. A snapshot takes
    a refcount on the prefilling slot's own pages
    (`PageAllocator.retain`), and a hit hands the ids to the new slot,
    which retains them too: N requests sharing a system prompt hold ONE
    physical copy of its K/V. No write ever targets a shared page.

    Eviction is the base LRU under a budget counted in PAGES; evicting a
    snapshot drops its references, and a page returns to the free list
    only when no slot still shares it. `reclaim(n)` is the allocator-
    pressure hook: admission and mid-decode growth evict snapshots to
    free pages before declaring exhaustion."""

    is_paged = True

    def __init__(self, chunk: int, max_pages: int | None = None, *,
                 budget_mb: float | None = None, logger=None,
                 registry=None):
        if (max_pages is None) == (budget_mb is None):
            raise ValueError("pass exactly one of max_pages (a page "
                             "budget) or budget_mb (resolved to pages "
                             "when the engine binds its allocator)")
        if max_pages is not None and max_pages < 0:
            raise ValueError(f"need max_pages >= 0, got {max_pages}")
        if budget_mb is not None and budget_mb < 0:
            raise ValueError(f"need budget_mb >= 0, got {budget_mb}")
        super().__init__(chunk, logger=logger, registry=registry)
        self.max_pages = None if max_pages is None else int(max_pages)
        self._budget_mb = budget_mb
        self._alloc = None
        self._page_bytes = 0
        # distinct pages this cache references -> snapshot refcount (a
        # page shared by k snapshots counts once against the budget; the
        # allocator holds k references for it)
        self._page_refs: dict[int, int] = {}

    def bind(self, allocator, page_bytes: int) -> None:
        """Attach the engine's allocator (the refcount authority) and the
        page byte size; resolves a budget_mb construction into pages.

        Rebinding a populated cache to ANOTHER allocator (a server
        rebuilt around the old cache object) drops every snapshot first:
        page ids name pages of the pool that died with the old engine,
        and carrying them over would retain or release pages the new
        allocator grants to unrelated live requests. The rebuilt cache
        starts cold."""
        if self._alloc is not None and allocator is not self._alloc:
            self._root = _Node()
            self._page_refs.clear()
            self.n_snapshots = 0
        self._alloc = allocator
        self._page_bytes = int(page_bytes)
        if self.max_pages is None:
            self.max_pages = int(self._budget_mb * 1024 * 1024
                                 // max(page_bytes, 1))

    # -- accounting -------------------------------------------------------

    def cached_pages(self) -> int:
        return len(self._page_refs)

    def reclaimable_pages(self) -> int:
        """Pages that evicting every snapshot would free: those whose
        allocator refcount is entirely cache-held (a page a live slot
        still shares frees nothing). The admission gate checks this
        before evicting, so a hopeless query cannot empty the cache for
        no admission."""
        if self._alloc is None:
            return 0
        return sum(1 for p, refs in self._page_refs.items()
                   if self._alloc.refcount(p) == refs)

    @property
    def nbytes(self) -> int:
        return self.cached_pages() * self._page_bytes

    # -- lookup / insert --------------------------------------------------

    def lookup(self, tokens):
        """Longest cached prefix of `tokens` on the chunk grid:
        ``(start, page_ids, logits)`` with `start` tokens already in the
        returned pages ((0, None, None) on a miss). The CALLER retains
        the pages for its own lifetime; the ids are a fresh list and the
        logits a fresh copy."""
        best, start = self._lookup_node(tokens)
        if best is None:
            return 0, None, None
        pages, logits = best.snapshot
        return start, list(pages), _copy_leaf(logits, False)

    def insert(self, tokens, pages, logits) -> bool:
        """Snapshot the state after `tokens` as the page ids covering
        them (a length on the chunk grid; the pages cover it exactly).
        Takes cache-owned refcounts, no copy. False (nothing stored)
        when the key exists or the page budget cannot fit it even after
        eviction."""
        if self._alloc is None:
            raise RuntimeError("PagedPrefixCache.bind(allocator, "
                               "page_bytes) must run before insert — "
                               "the engine does this at construction")
        toks = self._check_boundary(tokens)
        if self.writes_paused:
            return False
        pages = [int(p) for p in pages]
        node = self._insert_node(toks)
        if node is None:
            return False
        new_distinct = sum(1 for p in pages if p not in self._page_refs)
        while (self.cached_pages() + new_distinct > self.max_pages
               and self.n_snapshots > 0):
            before = self.n_snapshots
            self._evict_lru(protect=node)
            if self.n_snapshots == before:      # nothing evictable
                break
            new_distinct = sum(1 for p in pages
                               if p not in self._page_refs)
        if self.cached_pages() + new_distinct > self.max_pages:
            self._prune(node)
            return False
        self._alloc.retain(pages)
        for p in pages:
            self._page_refs[p] = self._page_refs.get(p, 0) + 1
        node.snapshot = (tuple(pages), _copy_leaf(logits, False))
        node.nbytes = len(pages) * self._page_bytes
        self.n_snapshots += 1
        self._m_bytes.set(self.nbytes)
        return True

    # -- eviction / reclaim -----------------------------------------------

    def _release_snapshot(self, node) -> int:
        pages = node.snapshot[0]
        for p in pages:
            self._page_refs[p] -= 1
            if self._page_refs[p] == 0:
                del self._page_refs[p]
        return self._alloc.release(pages)

    def reclaim(self, n_pages: int) -> int:
        """Free at least `n_pages` pool pages by evicting snapshots (or
        as many as evictions can free); returns the count freed.

        Victims rank FREEABILITY above LRU: a snapshot whose eviction
        frees pages now (it holds the last reference) beats one that only
        unblocks a later eviction (pages shared with other snapshots),
        and snapshots pinned entirely by live slots are never evicted
        here: they free nothing, and a hit-proven shared prefix would be
        lost for no page."""
        freed = 0
        while freed < n_pages and self.n_snapshots > 0:
            best, best_key = None, None
            for node in self._walk():
                pages = node.snapshot[0]
                frees = sum(1 for p in pages
                            if self._alloc.refcount(p) == 1)
                # progress: some page frees once its OTHER cache-held
                # references go too (chained boundary snapshots)
                progress = any(self._alloc.refcount(p)
                               == self._page_refs[p] for p in pages)
                if not frees and not progress:
                    continue                   # slot-pinned: keep it
                key = (frees == 0, min(node.hit_count, 1), node.stamp)
                if best is None or key < best_key:
                    best, best_key = node, key
            if best is None:
                break
            freed += self._evict_lru(victim=best)
        return freed
