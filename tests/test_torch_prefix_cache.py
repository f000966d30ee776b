"""The port's radix prefix cache (idc_models_tpu_torch/serve/
prefix_cache.py) on the CPU: its lookups, evictions, counters and summary
against the JAX package's `PrefixCache` and `PagedPrefixCache` over
scripted sequences, its snapshots never aliasing what it hands out or
takes in, and its place in chunked admission -- a hit resumes bit for bit
as a cold prefill of the same prompt, and a lookup after an eviction
prefills again (never stale state)."""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

from idc_models_tpu.models import lm as jlm
from idc_models_tpu.observe import metrics_registry as jreg
from idc_models_tpu.serve import pages as jpages
from idc_models_tpu.serve import prefix_cache as jpc
from idc_models_tpu_torch.observe import JsonlLogger, MetricsRegistry
from idc_models_tpu_torch.serve import (
    LMServer, PageAllocator, PagedPrefixCache, PrefixCache, Request,
    SlotEngine,
)

VOCAB, SEQ, E, HEADS, MLP, BLOCKS = 11, 32, 32, 2, 64, 2
CHUNK = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share a few cores: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _params():
    model = jlm.attention_lm(VOCAB, SEQ, embed_dim=E, num_heads=HEADS,
                             mlp_dim=MLP, num_blocks=BLOCKS)
    return jax.tree.map(np.array, jax.device_get(
        model.init(jax.random.key(0)).params))


def _kw(**kw):
    return dict(embed_dim=E, num_heads=HEADS, num_blocks=BLOCKS, t_max=SEQ,
                device="cpu", cache_dtype=torch.float32, **kw)


def _snap(x):
    """A small snapshot whose bytes are predictable: (caches, logits)."""
    return (np.full((x,), 1.0, np.float32),), np.zeros(4, np.float32)


def _both(cls_port, cls_jax, *args, **kw):
    return (cls_port(*args, registry=MetricsRegistry(), **kw),
            cls_jax(*args, registry=jreg.MetricsRegistry(), **kw))


def _state(pc):
    return (pc.hits, pc.misses, pc.evictions, pc.n_snapshots, pc.nbytes,
            pc.hit_tokens, pc.lookup_tokens, pc.summary())


# -- the radix structure against the JAX package's ---------------------------


def test_radix_lookups_and_lru_evictions_equal_jax():
    """One scripted sequence of inserts and lookups under a two-snapshot
    byte budget through both packages' PrefixCache: every lookup's start,
    every insert's verdict, the counters and the summary equal after
    each call -- the chunk grid, longest-prefix walk, dedupe, the
    refusal of a snapshot over the whole budget, and never-hit-first LRU
    eviction."""
    caches, logits = _snap(64)
    size = sum(a.nbytes for a in caches) + logits.nbytes
    ours, theirs = _both(PrefixCache, jpc.PrefixCache, 4, 2 * size)
    big = _snap(10_000)
    script = [
        ("insert", list(range(4))), ("insert", list(range(8))),
        ("lookup", list(range(8)) + [99, 98]),
        ("lookup", list(range(4)) + [7, 7, 7, 7]),
        ("lookup", [9, 9, 9, 9, 9]), ("lookup", [0, 1]),
        ("insert", [1, 1, 1, 1]), ("insert", list(range(8))),
        ("lookup", [1, 1, 1, 1, 5]), ("insert", [2, 2, 2, 2]),
        ("lookup", list(range(4))), ("lookup", [2, 2, 2, 2, 0]),
        ("big", [4, 4, 4, 4]), ("lookup", [4, 4, 4, 4, 1]),
        ("insert", [3, 3, 3, 3]), ("lookup", [1, 1, 1, 1]),
    ]
    for op, toks in script:
        out = []
        for pc in (ours, theirs):
            if op == "lookup":
                out.append(pc.lookup(toks)[0])
            else:
                c, lg = big if op == "big" else (caches, logits)
                out.append(pc.insert(toks, c, lg))
        assert out[0] == out[1], (op, toks, out)
        assert _state(ours) == _state(theirs), (op, toks)
    assert ours.evictions > 0 and ours.nbytes <= ours.max_bytes
    for pc in (ours, theirs):
        with pytest.raises(ValueError, match="chunk"):
            pc.insert([1, 2, 3], caches, logits)


def test_hit_proven_snapshots_outlive_speculative_ones():
    """Eviction prefers never-hit snapshots over hit-proven ones whatever
    their recency: a burst of unique prompts churns its own snapshots,
    not the shared system prefix."""
    caches, logits = _snap(64)
    size = sum(a.nbytes for a in caches) + logits.nbytes
    pc = PrefixCache(chunk=2, max_bytes=3 * size,
                     registry=MetricsRegistry())
    pc.insert([1, 1], caches, logits)
    pc.lookup([1, 1, 9])
    for k in (2, 3, 4, 5):
        pc.insert([k, k], caches, logits)
    assert pc.evictions == 2
    assert pc.lookup([1, 1, 9])[0] == 2
    assert pc.lookup([2, 2, 9])[0] == 0
    assert pc.lookup([3, 3, 9])[0] == 0


def test_insert_dedupes_and_budget_zero_disables():
    caches, logits = _snap(8)
    pc = PrefixCache(chunk=2, max_bytes=1 << 20, registry=MetricsRegistry())
    assert pc.insert([1, 2], caches, logits)
    assert not pc.insert([1, 2], caches, logits)
    assert pc.n_snapshots == 1
    off = PrefixCache(chunk=2, max_bytes=0, registry=MetricsRegistry())
    assert not off.insert([1, 2], caches, logits)
    assert off.lookup([1, 2, 3])[0] == 0


@pytest.mark.parametrize("host", [False, True], ids=["device", "host"])
def test_lookup_hands_out_copies_never_the_master(host):
    """The port's chunk fold writes its caches in place: what a lookup
    returns must share no buffer with the stored snapshot, nor the
    stored snapshot with what insert was given. Writing into a hit's
    tensors (as the next chunk does) leaves the next hit unchanged.
    ``host=True`` stores numpy copies, and a bf16 tensor (which numpy
    cannot hold) as a CPU tensor copy."""
    pc = PrefixCache(chunk=2, max_bytes=1 << 20, host=host,
                     registry=MetricsRegistry())
    given = (torch.ones(4), torch.ones(3, dtype=torch.bfloat16))
    pc.insert([1, 2], given, torch.zeros(3))
    given[0].fill_(5.0)
    stored = pc._root.children[(1, 2)].snapshot[0]
    if host:
        assert isinstance(stored[0], np.ndarray)
        assert torch.is_tensor(stored[1]) and stored[1].device.type == "cpu"
    _, got, lg = pc.lookup([1, 2, 9])
    torch.as_tensor(got[0])[:] = -7.0
    torch.as_tensor(lg)[:] = -7.0
    _, again, lg2 = pc.lookup([1, 2, 9])
    assert torch.equal(torch.as_tensor(again[0]), torch.ones(4))
    assert torch.equal(torch.as_tensor(lg2), torch.zeros(3))
    assert torch.as_tensor(again[1]).dtype == torch.bfloat16


def test_paged_cache_sequence_equals_jax():
    """One scripted sequence through both packages' PagedPrefixCache over
    their own allocators: page references, lookups (start and page ids),
    budget evictions, reclaim and the allocators' free lists equal after
    every call."""
    ours_a, theirs_a = PageAllocator(16, 4), jpages.PageAllocator(16, 4)
    ours, theirs = _both(PagedPrefixCache, jpc.PagedPrefixCache, CHUNK,
                         max_pages=5)
    ours.bind(ours_a, 64)
    theirs.bind(theirs_a, 64)
    logits = np.zeros((1, 4), np.float32)
    grants = {}

    def run(pc, alloc, op, arg):
        if op == "grant":
            grants.setdefault(id(alloc), {})[arg[0]] = alloc.alloc(arg[1])
            return grants[id(alloc)][arg[0]]
        if op == "free":
            return alloc.release(grants[id(alloc)][arg])
        if op == "insert":
            toks, key, n = arg
            return pc.insert(toks, grants[id(alloc)][key][:n], logits)
        if op == "lookup":
            start, pages, _ = pc.lookup(arg)
            return start, pages
        return pc.reclaim(arg)

    script = [
        ("grant", ("a", 4)), ("insert", ([1] * 8, "a", 2)),
        ("insert", ([1] * 16, "a", 4)), ("lookup", [1] * 16 + [2]),
        ("free", "a"), ("grant", ("b", 3)), ("insert", ([3] * 8, "b", 2)),
        ("lookup", [3] * 8), ("lookup", [1] * 8 + [5] * 8),
        ("free", "b"), ("grant", ("c", 2)), ("insert", ([4] * 8, "c", 2)),
        ("reclaim", 3), ("lookup", [1] * 16), ("reclaim", 16),
    ]
    for op, arg in script:
        a = run(ours, ours_a, op, arg)
        b = run(theirs, theirs_a, op, arg)
        assert a == b, (op, arg, a, b)
        assert _state(ours) == _state(theirs), (op, arg)
        assert ours.cached_pages() == theirs.cached_pages()
        assert ours.reclaimable_pages() == theirs.reclaimable_pages()
        assert [ours_a.refcount(p) for p in range(16)] == \
            [theirs_a.refcount(p) for p in range(16)]


def test_summary_keys_and_metrics_merge_equal_jax():
    """ServingMetrics with a prefix cache attached: the same hook calls
    and cache traffic through both packages give equal summaries, the
    serve_prefix_* keys merged in."""
    from idc_models_tpu.serve import metrics as jmetrics
    from idc_models_tpu_torch.serve import ServingMetrics

    caches, logits = _snap(8)
    out = []
    for pcls, mcls, reg in (
            (PrefixCache, ServingMetrics, MetricsRegistry),
            (jpc.PrefixCache, jmetrics.ServingMetrics,
             jreg.MetricsRegistry)):
        r = reg()
        pc = pcls(2, 1 << 20, registry=r)
        m = mcls(prefix_cache=pc, registry=r)
        m.on_submit("a", 1.0)
        pc.insert([1, 2], caches, logits)
        pc.lookup([1, 2, 3])
        pc.lookup([5, 6, 7])
        m.on_admit("a", 0.25)
        m.on_cycle(queue_depth=0, occupancy=1.0, tokens=3, prefill_s=0.01)
        m.on_pages(pages_total=8, pages_used=3, pages_cached=2,
                   resident_tokens=10, resident_bytes=1024)
        m.on_page_exhausted(rid="a", needed=12)
        m.on_finish("a", n_tokens=3, ttft_s=0.5, decode_s=0.2,
                    reason="budget", t=2.0)
        out.append(m.summary())
    assert out[0] == out[1]
    assert out[0]["serve_prefix_hits"] == 1
    assert out[0]["serve_kv_pages_used_peak"] == 3


# -- in chunked admission ------------------------------------------------


def test_prefix_hit_is_bit_identical_to_cold_prefill(tmp_path):
    """The same request admitted COLD (a miss, the whole chunked prefill)
    and WARM (a hit on a contiguous engine's truncated snapshot, the
    suffix only): its caches row and logits equal bit for bit after the
    insert, and so does every later step; the hit and miss stream as
    serve_prefix_* events."""
    rng = np.random.default_rng(5)
    sys_p = tuple(int(x) for x in rng.integers(0, VOCAB, 2 * CHUNK))
    logger = JsonlLogger(tmp_path / "p.jsonl")
    pc = PrefixCache(CHUNK, 1 << 20, logger=logger,
                     registry=MetricsRegistry())
    warm = SlotEngine(_params(), n_slots=2, prefill_chunk=CHUNK,
                      prefix_cache=pc, **_kw())
    cold = SlotEngine(_params(), n_slots=2, prefill_chunk=CHUNK, **_kw())
    warm.admit(0, np.asarray(sys_p + (1, 2)), 3)
    stored = [a.shape[1] for a in pc._root.children[sys_p[:CHUNK]]
              .children[sys_p[CHUNK:]].snapshot[0][0]]
    assert stored == [2 * CHUNK, 2 * CHUNK]          # cut to the prefix
    prompt = np.asarray(sys_p + (3, 4, 5))
    warm.admit(1, prompt, 4)
    cold.admit(1, prompt, 4)
    assert pc.hits == 1 and pc.misses == 1
    for _ in range(4):
        assert torch.equal(warm._logits[1], cold._logits[1])
        for (wk, wv), (ck, cv) in zip(warm._caches, cold._caches):
            assert torch.equal(wk[1], ck[1]) and torch.equal(wv[1], cv[1])
        warm.step_window(1)
        cold.step_window(1)
    logger.close()
    events = (tmp_path / "p.jsonl").read_text()
    assert '"serve_prefix_hit"' in events and '"serve_prefix_miss"' in events


def test_hit_after_evict_reprefills_never_stale():
    """A budget of about one request's snapshots: admitting B evicts A's,
    and A's next request misses, prefills again and still gives the
    tokens of a server without a cache; a re-populated prefix hits."""
    rng = np.random.default_rng(9)
    pa = tuple(int(x) for x in rng.integers(0, VOCAB, 16))
    pb = tuple(int(x) for x in rng.integers(0, VOCAB, 16))
    full = 2 * BLOCKS * SEQ * HEADS * (E // HEADS) * 4
    per_req = full * (8 + 16) // SEQ + 2 * VOCAB * 4
    server = LMServer(_params(), n_slots=1, window=4, prefill_chunk=CHUNK,
                      prefix_cache_mb=1.2 * per_req / (1024 * 1024),
                      registry=MetricsRegistry(), **_kw())
    plain = LMServer(_params(), n_slots=1, window=4, prefill_chunk=CHUNK,
                     registry=MetricsRegistry(), **_kw())
    pc = server.engine.prefix_cache

    def serve_both(rid, prompt):
        for s in (server, plain):
            s.run([(0.0, Request(id=rid, prompt=prompt, max_new_tokens=5))])
        assert server.poll(rid).tokens == plain.poll(rid).tokens, rid

    serve_both("a0", pa + (1,))
    serve_both("b0", pb + (2,))
    assert pc.evictions > 0, (pc.nbytes, pc.max_bytes)
    hits = pc.hits
    serve_both("a1", pa + (3,))
    assert pc.misses > 0
    serve_both("a2", pa + (4,))
    assert pc.hits > hits
    s = server.summary()
    assert s["serve_prefix_evictions"] == pc.evictions
    assert s["serve_prefix_hit_rate"] is not None
