"""The port's paged KV (idc_models_tpu_torch/serve/pages.py, the paged
folds in ring_decode.py, the paged SlotEngine, page-aware admission, the
page metrics, the server's knobs and the `serve` verb's flags) on the
CPU, against the JAX package's paged serving on the same numpy inputs
and weights (carried across by `convert.load_jax`), and against the
port's own contiguous path.

The contracts, as the JAX package's tests/test_paged_kv.py holds them:
the paged folds and the paged engine give the contiguous ones' outputs
BIT for bit at world size 1 (only the cache indirection differs); pages
are safe (dead rows, unallocated entries and foreign pages untouched,
refcounts balanced over 100 recycles, a killed zombie row writes
nothing, exhaustion handled honestly); int8 pages are held on
determinism, bounded drift and their byte ratio. The speculative verify
through the paged folds (tests/test_paged_kv.py:325) is held in
tests/test_torch_spec_decode.py, and page pressure feeding the brownout
controller (:532) in tests/test_torch_serve_resilience.py."""

from __future__ import annotations

import contextlib
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idc_models_tpu import mesh as jmeshlib
from idc_models_tpu import ring_decode as jrd
from idc_models_tpu import serve as jserve
from idc_models_tpu.models import lm as jlm
from idc_models_tpu_torch import cli
from idc_models_tpu_torch import ring_decode as trd
from idc_models_tpu_torch.observe import MetricsRegistry
from idc_models_tpu_torch.serve import (
    LMServer, PageAllocator, PagedPrefixCache, PrefixCache, Request,
    RetryPolicy, SlotEngine,
)

VOCAB, SEQ, E, HEADS, MLP, BLOCKS = 11, 32, 32, 2, 64, 2
PS, PAGES, CHUNK = 4, 24, 8          # the shared paged configuration
KW = dict(embed_dim=E, num_heads=HEADS, num_blocks=BLOCKS, t_max=SEQ)
PAGED = dict(prefill_chunk=CHUNK, kv_page_size=PS, kv_pages=PAGES)
F32_TOL = 1e-5                       # of the largest |value|


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share a few cores: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _params():
    """The JAX LM's weights (seed 0), the head sharpened so greedy picks
    win by more than the two packages' rounding."""
    model = jlm.attention_lm(VOCAB, SEQ, embed_dim=E, num_heads=HEADS,
                             mlp_dim=MLP, num_blocks=BLOCKS)
    params = jax.tree.map(np.array, jax.device_get(
        model.init(jax.random.key(0)).params))
    params["head"]["kernel"] = params["head"]["kernel"] * 8.0
    return params


def _kw(**kw):
    return dict(KW, device="cpu", cache_dtype=torch.float32, **kw)


def _engine(**kw):
    return SlotEngine(_params(), **_kw(**kw))


def _server(**kw):
    return LMServer(_params(), registry=MetricsRegistry(), **_kw(**kw))


def _prompt(rng, n):
    return tuple(int(x) for x in rng.integers(0, VOCAB, n))


def _drive(eng, prompt, budget, slot=0, window=2):
    """One request alone through `slot`: its tokens and, per step, the
    logits row its pick read."""
    eng.admit(slot, np.asarray(prompt), budget)
    toks, seen = [], []
    while not eng.finished(slot):
        seen.append(eng._logits[slot].clone())
        toks += eng.step_window(1).get(slot, [])
    eng.release(slot)
    return toks, seen


# -- fold level ----------------------------------------------------------


def _pool_from_rows(rows, pt, n_pages):
    """Scatter contiguous [S, T, H, D] rows into a pool per the page
    table: the inverse of the fold's gathered view."""
    s, t, h, d = rows.shape
    pool = np.zeros((n_pages, PS, h, d), rows.dtype)
    for b in range(s):
        for j in range(t // PS):
            if pt[b, j] >= 0:
                pool[pt[b, j]] = rows[b, j * PS:(j + 1) * PS]
    return pool


def _rows_from_pool(pool, pt, t):
    s, n_l = pt.shape
    out = np.zeros((s, t) + pool.shape[2:], pool.dtype)
    for b in range(s):
        for j in range(n_l):
            if pt[b, j] >= 0:
                out[b, j * PS:(j + 1) * PS] = pool[pt[b, j]]
    return out


def _quantize_pool(pool, rng):
    scale = (np.abs(rng.normal(size=(pool.shape[0], pool.shape[2])))
             * 0.02 + 0.01).astype(np.float32)
    q = np.clip(np.round(pool / scale[:, None, :, None]), -127, 127)
    return q.astype(np.int8), scale


def _t(*xs):
    return tuple(torch.from_numpy(np.array(x, copy=True)) for x in xs)


def _with_sink(*xs):
    """The port's pools and scales: JAX's, plus the folds' sink page."""
    return tuple(np.concatenate([x, np.zeros_like(x[:1])]) for x in xs)


@functools.lru_cache(maxsize=None)
def _jax_fold(kind: str, quantized: bool):
    """The JAX paged fold on a one-device mesh, jitted once a module."""
    make = {"batched": jrd.make_paged_batched_ring_decode,
            "chunk": jrd.make_paged_chunk_ring_decode}[kind]
    return make(jmeshlib.seq_mesh(1), page_size=PS, quantized=quantized,
                jit=True)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_paged_batched_fold_matches_jax_and_the_contiguous_fold(quantized):
    """Rows of one-token decode through pages scattered at random in an
    oversized pool: a live row, a row at position 0, a dead row, and a
    live row whose page is unallocated (-1). Held against the JAX paged
    fold (outputs within f32 rounding, pools and scales bit-equal) and,
    in f32, against the port's contiguous batched fold bit for bit; the
    dead row's pages, the unallocated row and a spare page are
    untouched."""
    S, H, D = 4, 2, 8
    rng = np.random.default_rng(0)
    kc = rng.normal(size=(S, SEQ, H, D)).astype(np.float32)
    vc = rng.normal(size=(S, SEQ, H, D)).astype(np.float32)
    pos = np.array([5, 0, 9, 13])
    live = np.array([True, True, False, True])
    for b in range(S):
        kc[b, pos[b]:] = 0.0
        vc[b, pos[b]:] = 0.0
    q, kt, vt = (rng.normal(size=(S, 1, H, D)).astype(np.float32)
                 for _ in range(3))
    l_pages = SEQ // PS
    n_pg = S * l_pages + 4
    perm = rng.permutation(n_pg)[:S * l_pages]
    pt = perm.reshape(S, l_pages).astype(np.int32)
    pt[3, 13 // PS:] = -1                # row 3 appends into a -1 page
    kp = _pool_from_rows(kc, pt, n_pg)
    vp = _pool_from_rows(vc, pt, n_pg)
    spare = sorted(set(range(n_pg)) - set(pt.ravel().tolist()))
    kp[spare] = 7.25
    scales = ()
    if quantized:
        (kp, ks), (vp, vs) = _quantize_pool(kp, rng), _quantize_pool(vp, rng)
        scales = (ks, vs)
    fold = trd.make_paged_batched_ring_decode(page_size=PS,
                                              quantized=quantized)
    out, kp2, vp2 = fold(*_t(*_with_sink(kp, vp), pt, q, kt, vt), pos,
                         live, *_t(*_with_sink(*scales)))
    kp2, vp2 = kp2[:-1], vp2[:-1]
    jfold = _jax_fold("batched", quantized)
    jout, jkp, jvp = jfold(*map(jnp.asarray, (kp, vp, pt, q, kt, vt)), pos,
                           live, *map(jnp.asarray, scales))
    want = np.asarray(jout)[live]
    err = np.abs(out.numpy()[live] - want).max()
    assert err <= F32_TOL * np.abs(want).max(), err
    assert np.array_equal(kp2.numpy(), np.asarray(jkp))
    assert np.array_equal(vp2.numpy(), np.asarray(jvp))
    for b in (2, 3):                     # dead; unallocated target page
        for j in range(l_pages):
            if pt[b, j] >= 0:
                assert np.array_equal(kp2.numpy()[pt[b, j]], kp[pt[b, j]])
    assert np.array_equal(kp2.numpy()[spare], kp[spare])
    if quantized:
        return
    cfold = trd.make_batched_ring_decode()
    ready = np.array([True, True, False, False])
    cout, kc2, vc2 = cfold(*_t(kc, vc, q, kt, vt), pos, live & ready)
    assert torch.equal(out[ready], cout[ready])
    assert np.array_equal(_rows_from_pool(kp2.numpy(), pt, SEQ)[ready],
                          kc2.numpy()[ready])
    assert np.array_equal(_rows_from_pool(vp2.numpy(), pt, SEQ)[ready],
                          vc2.numpy()[ready])


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_paged_chunk_fold_matches_jax_and_the_contiguous_fold(quantized):
    """A ragged chunk (5 real of 8) spliced through the page table: the
    JAX paged chunk fold's outputs within f32 rounding, its pools
    bit-equal (int8: within one level, and each filled page's new scale,
    absmax / 127, within one ulp); in f32 the
    port's contiguous chunk fold's outputs and logical cache bit-equal,
    positions past p_end never written."""
    H, D, C = 2, 8, CHUNK
    rng = np.random.default_rng(1)
    start, p_end = 8, 13
    kc = np.zeros((1, SEQ, H, D), np.float32)
    vc = np.zeros((1, SEQ, H, D), np.float32)
    kc[:, :start] = rng.normal(size=(1, start, H, D))
    vc[:, :start] = rng.normal(size=(1, start, H, D))
    q, kt, vt = (rng.normal(size=(1, C, H, D)).astype(np.float32)
                 for _ in range(3))
    l_pages = SEQ // PS
    pt = rng.permutation(PAGES)[:l_pages].reshape(1, l_pages).astype(
        np.int32)
    kp = _pool_from_rows(kc, pt, PAGES)
    vp = _pool_from_rows(vc, pt, PAGES)
    scales = ()
    if quantized:
        (kp, ks), (vp, vs) = _quantize_pool(kp, rng), _quantize_pool(vp, rng)
        scales = (ks, vs)
    fold = trd.make_paged_chunk_ring_decode(page_size=PS,
                                            quantized=quantized)
    got = fold(*_t(*_with_sink(kp, vp), pt, q, kt, vt), start, p_end,
               *_t(*_with_sink(*scales)))
    got = (got[0],) + tuple(x[:-1] for x in got[1:])
    jfold = _jax_fold("chunk", quantized)
    want = jfold(*map(jnp.asarray, (kp, vp, pt, q, kt, vt)),
                 np.int32(start), np.int32(p_end),
                 *map(jnp.asarray, scales))
    n_real = p_end - start
    w = np.asarray(want[0])[:, :n_real]
    err = np.abs(got[0].numpy()[:, :n_real] - w).max()
    assert err <= F32_TOL * np.abs(w).max(), err
    if quantized:
        # XLA divides the absmax by 127 through a reciprocal: a scale may
        # sit one ulp off, and a level flip where x / scale ties
        for a, b in zip(got[1:3], want[1:3]):
            assert np.abs(a.numpy().astype(int)
                          - np.asarray(b).astype(int)).max() <= 1
        for a, b in zip(got[3:], want[3:]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-7,
                                       atol=0)
        return
    for a, b in zip(got[1:], want[1:]):
        assert np.array_equal(a.numpy(), np.asarray(b))
    cout, kc2, _ = trd.make_chunk_ring_decode()(*_t(kc, vc, q, kt, vt),
                                                start, p_end)
    assert torch.equal(got[0][:, :n_real], cout[:, :n_real])
    assert np.array_equal(_rows_from_pool(got[1].numpy(), pt, SEQ),
                          kc2.numpy())


@pytest.mark.parametrize("case,match", [
    ("page dim", "page dim"), ("two tokens", "ONE token"),
    ("positions", "one position per"), ("scales", "scales passed"),
    ("no scales", "needs \\(k_scale, v_scale\\)"),
    ("chunk off the grid", "multiple of the page"),
    ("table rank", "page table must be"),
])
def test_paged_fold_validation_carries_the_jax_messages(case, match):
    kp = torch.zeros((PAGES, PS, 2, 8))
    pt = torch.zeros((2, SEQ // PS), dtype=torch.int32)
    q = torch.zeros((2, 1, 2, 8))
    pos, live = np.zeros(2, np.int64), np.ones(2, bool)
    fold = trd.make_paged_batched_ring_decode(page_size=PS)
    calls = {
        "page dim": lambda: fold(torch.zeros((PAGES, PS + 1, 2, 8)), kp,
                                 pt, q, q, q, pos, live),
        "two tokens": lambda: fold(kp, kp, pt, torch.zeros((2, 2, 2, 8)),
                                   q, q, pos, live),
        "positions": lambda: fold(kp, kp, pt, q, q, q, np.zeros(3), live),
        "scales": lambda: fold(kp, kp, pt, q, q, q, pos, live,
                               torch.zeros((PAGES, 2))),
        "no scales": lambda: trd.make_paged_batched_ring_decode(
            page_size=PS, quantized=True)(kp, kp, pt, q, q, q, pos, live),
        "chunk off the grid": lambda: trd.make_paged_chunk_ring_decode(
            page_size=PS)(kp, kp, pt[:1], *[torch.zeros((1, PS + 1, 2, 8))]
                          * 3, 0, 0),
        "table rank": lambda: fold(kp, kp, pt[0], q, q, q, pos, live),
    }
    with pytest.raises(ValueError, match=match):
        calls[case]()


# -- the allocator ---------------------------------------------------------


def test_page_allocator_grants_and_refcounts_equal_jax():
    """One scripted call sequence through both allocators: the same page
    ids granted, the same refcounts and free counts after every call,
    and the same refusals."""
    from idc_models_tpu.serve.pages import PageAllocator as JAlloc

    script = [("alloc", 3), ("alloc", 6), ("retain", [0]),
              ("release", [0, 1, 2]), ("alloc", 2), ("alloc", 4),
              ("retain", [3, 4]), ("release", [4]), ("release", [0]),
              ("alloc", 5), ("release", [3, 4, 1]), ("alloc", 0),
              ("release", [5]), ("retain", [5]), ("alloc", 8)]
    ours, theirs = PageAllocator(8, 4), JAlloc(8, 4)
    for op, arg in script:
        out = []
        for a in (ours, theirs):
            try:
                out.append(getattr(a, op)(arg))
            except ValueError as e:
                out.append(f"ValueError: {e}")
        assert out[0] == out[1], (op, arg, out)
        assert ours.free_count() == theirs.free_count()
        assert [ours.refcount(p) for p in range(8)] == \
            [theirs.refcount(p) for p in range(8)]
    assert ours.alloc(2) is None or ours.used_count() <= 8
    with pytest.raises(ValueError):
        PageAllocator(0, 4)


# -- engine and server -----------------------------------------------------


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_paged_engine_is_bit_equal_to_the_contiguous_engine(mode):
    """The same requests in the same slots of a paged and a contiguous
    chunked engine (2 slots, windows of 3, recycling): every step's
    logits and every token equal bit for bit -- greedy, and sampled at
    temperature 1.3, top-k 4 with each request's seed."""
    sampled = dict(temperature=1.3, top_k=4) if mode == "sampled" else {}
    rng = np.random.default_rng(5)
    reqs = [(_prompt(rng, 3 + 2 * i), 4 + (i % 5) * 2, 100 + i)
            for i in range(6)]
    runs = []
    for kw in (dict(PAGED), dict(prefill_chunk=CHUNK)):
        eng = _engine(n_slots=2, **kw, **sampled)
        eng.warmup(3)
        queue, slot_of = list(range(len(reqs))), {}
        toks = {i: [] for i in queue}
        seen = {i: [] for i in queue}
        while queue or slot_of:
            for s in eng.free_slots():
                if queue:
                    i = queue.pop(0)
                    p, b, seed = reqs[i]
                    eng.admit(s, np.asarray(p), b,
                              rng=seed if sampled else None)
                    slot_of[s] = i
            for s, i in slot_of.items():
                seen[i].append(eng._logits[s].clone())
            for s, row in eng.step_window(3).items():
                toks[slot_of[s]] += row
            for s in [s for s in slot_of if eng.finished(s)]:
                eng.release(s)
                del slot_of[s]
        runs.append((toks, seen))
        if kw.get("kv_pages"):
            assert eng._alloc.used_count() == 0
    (pt, ps), (ct, cs) = runs
    assert pt == ct
    for i in ps:
        assert all(torch.equal(a, b) for a, b in zip(ps[i], cs[i])), i


@functools.lru_cache(maxsize=None)
def _jax_paged_served():
    """The JAX paged LMServer with a paged prefix cache: (summary,
    {id: tokens}) over `_trace()` -- 3 slots, window 4, f32 caches, a
    one-device mesh."""
    server = jserve.LMServer(_params(), n_slots=3, window=4,
                             mesh=jmeshlib.seq_mesh(1),
                             cache_dtype=jnp.float32, prefix_cache_mb=1.0,
                             **PAGED, **KW)
    trace = _trace()
    server.run(trace)
    return server.summary(), {r.id: server.poll(r.id).tokens
                              for _, r in trace}


def _trace():
    rng = np.random.default_rng(7)
    shared = _prompt(rng, 2 * CHUNK)
    return [(0.0, Request(id=f"r{i}",
                          prompt=(shared if i % 2 else ())
                          + _prompt(rng, 1 + i),
                          max_new_tokens=3 + i // 2)) for i in range(7)]


def test_paged_lmserver_matches_the_jax_paged_lmserver():
    """The same trace (half the requests sharing a two-chunk prefix)
    through the port's and the JAX paged server with a prefix cache:
    greedy tokens equal request for request, the summary's key set equal
    (page and prefix keys included), the same pool size, peak pages,
    prefix hits and exhaustions, and every page but the cache's back at
    drain."""
    want_summary, want = _jax_paged_served()
    server = _server(n_slots=3, window=4, prefix_cache_mb=1.0, **PAGED)
    server.run(_trace())
    for _, r in _trace():
        assert server.poll(r.id).status == "ok"
        assert server.poll(r.id).tokens == want[r.id], r.id
    got = server.summary()
    assert set(got) == set(want_summary)
    for key in ("serve_kv_pages_total", "serve_kv_pages_used_peak",
                "serve_prefix_hits", "serve_prefix_snapshots",
                "serve_page_exhaustions", "serve_tokens"):
        assert got[key] == want_summary[key], key
    eng = server.engine
    assert eng._alloc.used_count() == eng.prefix_cache.cached_pages() > 0
    assert got["serve_kv_tokens_per_hbm_byte"] > 0


def test_paged_chunk_boundary_prompt_lengths():
    """Prompt lengths on every boundary class (1, C-1, C, C+1, a page-
    exact length, the longest admissible prompt) through a paged and a
    contiguous chunked engine: tokens and logits equal bit for bit."""
    paged, contig = _engine(n_slots=1, **PAGED), _engine(
        n_slots=1, prefill_chunk=CHUNK)
    rng = np.random.default_rng(3)
    for p_len in (1, CHUNK - 1, CHUNK, CHUNK + 1, 2 * PS, SEQ - 2):
        prompt = _prompt(rng, p_len)
        budget = min(3, SEQ - p_len)
        got, want = _drive(paged, prompt, budget), _drive(contig, prompt,
                                                           budget)
        assert got[0] == want[0], p_len
        assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))


def test_paged_slot_recycle_returns_every_page():
    """100 admit / decode / release cycles through 2 slots: the free
    list is whole after every one (no leak), and the last requests,
    decoding over pages with stale content, equal the contiguous
    engine's."""
    eng = _engine(n_slots=2, **PAGED)
    eng.warmup(4)
    contig = _engine(n_slots=1, prefill_chunk=CHUNK)
    rng = np.random.default_rng(7)
    for i in range(100):
        slot = i % 2
        prompt = rng.integers(0, VOCAB, 3 + int(rng.integers(0, 8)))
        eng.admit(slot, prompt, 2)
        got = []
        while not eng.finished(slot):
            got.extend(eng.step_window(2).get(slot, []))
        eng.release(slot)
        assert eng._alloc.used_count() == 0, i
        if i >= 98:
            assert got == _drive(contig, tuple(prompt), 2)[0], i


def test_paged_int8_deterministic_drift_and_page_bytes():
    """int8 pages: two identical runs give identical tokens; after a
    window the final logits lie within 0.35 of max |logit| of the f32
    paged engine's; an f32 page costs at least 3x an int8 one (with its
    scales), a bf16 page nearly 2x."""
    rng = np.random.default_rng(3)
    reqs = [Request(id=f"q{i}", prompt=_prompt(rng, 5 + i),
                    max_new_tokens=6) for i in range(3)]
    outs = []
    for _ in range(2):
        srv = _server(n_slots=2, window=4, kv_dtype="int8", **PAGED)
        srv.run([(0.0, r) for r in reqs])
        outs.append({r.id: tuple(srv.poll(r.id).tokens) for r in reqs})
        assert all(srv.poll(r.id).status == "ok" for r in reqs)
    assert outs[0] == outs[1]
    f32 = _engine(n_slots=2, **PAGED)
    i8 = _engine(n_slots=2, kv_dtype="int8", **PAGED)
    bf16 = SlotEngine(_params(), **dict(_kw(n_slots=2, **PAGED),
                                        cache_dtype=torch.bfloat16))
    assert f32.kv_page_bytes() / i8.kv_page_bytes() >= 3.0
    ratio = bf16.kv_page_bytes() / i8.kv_page_bytes()
    assert ratio == 2 * PS * E * 2 * BLOCKS / (
        2 * PS * E * BLOCKS + 2 * BLOCKS * HEADS * 4)
    for eng in (f32, i8):
        eng.admit(0, np.asarray(reqs[0].prompt), 4)
        eng.step_window(4)
    lf, li = f32._logits[0], i8._logits[0]
    assert float((lf - li).abs().max()) < 0.35 * max(
        float(lf.abs().max()), 1.0)


def test_paged_prefix_sharing_zero_copy_and_hit_equals_cold():
    """Two requests sharing a two-chunk prefix: the snapshot shares the
    first request's pages (refcounts, no copy), the second is granted
    fewer fresh pages, its logits at every step equal a cold prefill's
    on a fresh engine bit for bit, and evicting the cache returns every
    page."""
    pc = PagedPrefixCache(CHUNK, budget_mb=1.0)
    eng = _engine(n_slots=2, prefix_cache=pc, **PAGED)
    rng = np.random.default_rng(11)
    pre = _prompt(rng, 2 * CHUNK)
    _drive(eng, pre + (1, 2), 4)
    assert pc.n_snapshots == 2 and pc.cached_pages() == 2 * CHUNK // PS
    assert eng._alloc.used_count() == pc.cached_pages()   # only the cache
    free_before = eng._alloc.free_count()
    eng.start_prefill(1, np.asarray(pre + (3, 4, 5)), 4)
    fresh = free_before - eng._alloc.free_count()
    assert fresh == eng._pages_for(len(pre) + 3, 4) - 2 * CHUNK // PS
    assert eng.prefill_grant(1) == (fresh, 2 * CHUNK // PS)
    assert eng.prefill_grant(0) is None
    assert pc.hits == 1
    while not eng.prefill_step(1):
        pass
    toks, seen = [], []
    while not eng.finished(1):
        seen.append(eng._logits[1].clone())
        toks += eng.step_window(1)[1]
    eng.release(1)
    cold = _drive(_engine(n_slots=2, **PAGED), pre + (3, 4, 5), 4, slot=1)
    assert toks == cold[0]
    assert all(torch.equal(a, b) for a, b in zip(seen, cold[1]))
    assert eng._alloc.used_count() == pc.cached_pages()
    pc.reclaim(PAGES)
    assert eng._alloc.used_count() == 0 and pc.n_snapshots == 0


def test_paged_prefix_reclaim_spares_slot_pinned_snapshots():
    """Reclaim ranks freeability above LRU: a snapshot whose pages a live
    slot still shares frees nothing and is never evicted by reclaim,
    while a freeable one goes whatever its rank."""
    a = PageAllocator(8, 4)
    pc = PagedPrefixCache(CHUNK, max_pages=8, registry=MetricsRegistry())
    pc.bind(a, 64)
    slot1 = a.alloc(2)                  # a live slot holds these
    pc.insert([1] * CHUNK, slot1, torch.zeros((1, 4)))
    pc.lookup([1] * CHUNK)              # hit-proven and older
    slot2 = a.alloc(2)
    pc.insert([2] * CHUNK, slot2, torch.zeros((1, 4)))
    a.release(slot2)                    # its slot finished
    assert pc.reclaimable_pages() == 2
    assert pc.reclaim(1) == 2           # evicts the freeable snapshot
    assert pc.n_snapshots == 1
    assert pc.lookup([1] * CHUNK)[0] == CHUNK
    assert pc.reclaim(4) == 0           # the pinned one stays
    assert pc.n_snapshots == 1


def test_paged_prefix_cache_rebind_drops_stale_pages():
    """A server rebuilt around a populated paged cache: the rebind drops
    every snapshot (their ids name the old pool's pages), the new server
    starts cold, re-warms, and its tokens equal a cold engine's."""
    pc = PagedPrefixCache(CHUNK, max_pages=16)
    rng = np.random.default_rng(29)
    pre = _prompt(rng, 2 * CHUNK)
    srv_a = _server(n_slots=2, window=4, prefix_cache=pc, **PAGED)
    srv_a.run([(0.0, Request(id="a", prompt=pre + (1,), max_new_tokens=4))])
    assert pc.n_snapshots > 0
    srv_a.close()
    srv_b = _server(n_slots=2, window=4, prefix_cache=pc, **PAGED)
    assert pc.n_snapshots == 0 and pc.cached_pages() == 0
    reqs = [Request(id=f"b{i}", prompt=pre + (2 + i,), max_new_tokens=4)
            for i in range(2)]
    for r in reqs:
        srv_b.run([(0.0, r)])
    assert pc.hits >= 1
    cold = _engine(n_slots=1, **PAGED)
    for r in reqs:
        assert srv_b.poll(r.id).tokens == _drive(cold, r.prompt, 4)[0]


def test_paged_prefix_eviction_under_page_budget():
    """A 4-page snapshot budget under many distinct prefixes: the LRU
    evicts, the budget holds, and a request whose prefix was evicted
    prefills again with the cold tokens."""
    pc = PagedPrefixCache(CHUNK, max_pages=4)
    server = _server(n_slots=2, window=4, prefix_cache=pc, **PAGED)
    rng = np.random.default_rng(13)
    prompts = [_prompt(rng, CHUNK) + (i,) for i in range(4)]
    for i, p in enumerate(prompts):
        server.run([(0.0, Request(id=f"e{i}", prompt=p, max_new_tokens=3))])
    assert pc.evictions > 0 and pc.cached_pages() <= 4
    server.run([(0.0, Request(id="again", prompt=prompts[0],
                              max_new_tokens=3))])
    assert server.poll("again").tokens == server.poll("e0").tokens
    assert server.poll("again").tokens == _drive(
        _engine(n_slots=1, **PAGED), prompts[0], 3)[0]


def test_page_exhaustion_mid_decode_is_honest():
    """A small pool and a decode reserve of 4 force mid-decode growth to
    fail: with retries the starved request restarts, and whatever
    finishes ok has the cold tokens; without, it finishes as an error (slot_fault) and
    the survivor's tokens are untouched. Every page returns at drain."""
    rng = np.random.default_rng(17)
    ra = Request(id="x", prompt=_prompt(rng, 8), max_new_tokens=20)
    rb = Request(id="y", prompt=_prompt(rng, 8), max_new_tokens=20)
    cold = _engine(n_slots=1, **PAGED)
    want = {r.id: _drive(cold, r.prompt, 20)[0] for r in (ra, rb)}
    tight = dict(prefill_chunk=CHUNK, kv_page_size=PS, kv_pages=8,
                 kv_decode_reserve=4)
    srv = _server(n_slots=2, window=4, retry=RetryPolicy(max_retries=4,
                                                         backoff_s=0.0),
                  **tight)
    srv.run([(0.0, ra), (0.0, rb)])
    assert srv.summary()["serve_slot_faults"] > 0
    ok = [r for r in (ra, rb) if srv.poll(r.id).status == "ok"]
    assert ok
    for r in ok:
        assert srv.poll(r.id).tokens == want[r.id], r.id
    assert srv.engine._alloc.used_count() == 0
    srv2 = _server(n_slots=2, window=4, **tight)
    srv2.run([(0.0, ra), (0.0, rb)])
    statuses = {r.id: srv2.poll(r.id).status for r in (ra, rb)}
    assert "error" in statuses.values()
    for r in (ra, rb):
        got = srv2.poll(r.id)
        if got.status == "ok":
            assert got.tokens == want[r.id]
        else:
            assert got.finish_reason == "slot_fault"
    assert srv2.summary()["serve_page_exhaustions"] > 0
    assert srv2.engine._alloc.used_count() == 0


def test_page_gate_holds_the_head_until_pages_free():
    """A pool that fits one request at a time: the queue head waits on
    pages (no refusal, no corruption), the wait is counted, and every
    request finishes with the cold tokens."""
    srv = _server(n_slots=2, window=4, prefill_chunk=CHUNK,
                  kv_page_size=PS, kv_pages=8)
    rng = np.random.default_rng(19)
    reqs = [Request(id=f"w{i}", prompt=_prompt(rng, 10), max_new_tokens=16)
            for i in range(3)]
    srv.run([(0.0, r) for r in reqs])
    assert srv.summary()["serve_page_exhaustions"] > 0
    cold = _engine(n_slots=1, **PAGED)
    for r in reqs:
        assert srv.poll(r.id).status == "ok"
        assert srv.poll(r.id).tokens == _drive(cold, r.prompt, 16)[0]


def test_paged_release_kills_zombie_row():
    """Releasing a slot mid-run kills its device row in the same step
    its pages free: the freed pages are granted again at once, and the
    new owner's prompt pages stay bit-untouched while it decodes."""
    eng = _engine(n_slots=2, **PAGED)
    eng.warmup(4)
    rng = np.random.default_rng(23)
    eng.admit(0, rng.integers(0, VOCAB, 4), 24)      # long budget
    eng.step_window(2)
    eng.release(0)                                   # ~22 left
    assert eng._alloc.used_count() == 0
    assert int(eng._rem[0]) == 0                     # the row is dead
    assert bool((eng._pt[0] == -1).all())
    pb = rng.integers(0, VOCAB, 16)
    eng.admit(1, pb, 8)

    def prompt_region():
        kp = eng._caches[0][0]
        return torch.stack([kp[int(p)] for p in eng._pt[1][:16 // PS]])

    before = prompt_region().clone()
    got = []
    while not eng.finished(1):
        got.extend(eng.step_window(2).get(1, []))
    assert torch.equal(before, prompt_region())
    eng.release(1)
    assert got == _drive(_engine(n_slots=1, **PAGED), tuple(pb), 8)[0]


def test_paged_deadline_cancel_frees_prefill_grant():
    """A request cancelled while still chunking returns its whole grant,
    its table row cleared; the slot is free at once."""
    eng = _engine(n_slots=1, **PAGED)
    eng.warmup(2)
    eng.start_prefill(0, np.arange(20) % VOCAB, 4)
    assert eng._alloc.used_count() == 6
    eng.prefill_step(0)
    eng.cancel_prefill(0)
    assert eng._alloc.used_count() == 0
    assert bool((eng._pt[0] == -1).all())
    assert eng.free_slots() == [0]


@pytest.mark.parametrize("kw,match", [
    (dict(kv_page_size=PS), "BOTH kv_page_size"),
    (dict(kv_page_size=PS, kv_pages=PAGES), "chunked prefill"),
    (dict(prefill_chunk=CHUNK, kv_page_size=5, kv_pages=PAGES),
     "divide t_max"),
    (dict(prefill_chunk=2, kv_page_size=4, kv_pages=PAGES),
     "multiple of kv_page_size"),
    (dict(prefill_chunk=CHUNK, kv_page_size=PS, kv_pages=SEQ // PS - 1),
     "could never be admitted"),
    (dict(kv_decode_reserve=4), "kv_decode_reserve needs paged"),
    (dict(kv_decode_reserve=0, **PAGED), "need kv_decode_reserve >= 1"),
    (dict(prefix_cache="contig", **PAGED), "flavor must match"),
    (dict(prefill_chunk=CHUNK, prefix_cache="paged"), "flavor must match"),
    (dict(prefix_cache="paged"), "needs chunked prefill"),
    (dict(prefill_chunk=CHUNK, prefix_cache="chunk 4"),
     "prefix cache chunk 4 != engine prefill_chunk 8"),
], ids=lambda v: v if isinstance(v, str) else None)
def test_paged_validation_carries_the_jax_messages(kw, match):
    caches = {"contig": lambda: PrefixCache(CHUNK, 1 << 20),
              "paged": lambda: PagedPrefixCache(CHUNK, max_pages=4),
              "chunk 4": lambda: PrefixCache(4, 1 << 20)}
    if "prefix_cache" in kw:
        kw = dict(kw, prefix_cache=caches[kw["prefix_cache"]]())
    with pytest.raises(ValueError, match=match):
        _engine(**kw)


def test_prefix_cache_flavour_and_budget_checks():
    with pytest.raises(ValueError, match="exactly one"):
        PagedPrefixCache(CHUNK)
    with pytest.raises(ValueError, match="exactly one"):
        PagedPrefixCache(CHUNK, max_pages=4, budget_mb=1.0)
    with pytest.raises(ValueError, match="needs prefill_chunk"):
        _server(prefix_cache_mb=4.0, warmup=False)
    with pytest.raises(ValueError, match="not both"):
        _server(prefix_cache_mb=4.0, prefill_chunk=CHUNK, warmup=False,
                prefix_cache=PrefixCache(CHUNK, 1 << 20))
    assert isinstance(_server(prefix_cache_mb=1.0, warmup=False, **PAGED)
                      .engine.prefix_cache, PagedPrefixCache)
    contig = _server(prefix_cache_mb=1.0, prefill_chunk=CHUNK, warmup=False)
    assert type(contig.engine.prefix_cache) is PrefixCache
    assert contig.engine.prefix_cache.max_bytes == 1 << 20


def test_paged_kv_resident_accounting():
    """kv_bytes_resident follows pages, not slots: a short request costs
    its pages only, and page_stats reports the pool to the metrics."""
    eng = _engine(n_slots=4, **PAGED)
    eng.warmup(2)
    contig = _engine(n_slots=4)
    assert eng.kv_bytes_resident() == 0
    assert eng.kv_page_bytes() == BLOCKS * 2 * PS * E * 4
    assert eng.kv_bytes_per_slot() == SEQ // PS * eng.kv_page_bytes()
    eng.admit(0, np.arange(5) % VOCAB, 3)     # 8 tokens -> 2 pages
    assert eng._alloc.used_count() == 2
    assert eng.kv_bytes_resident() == 2 * eng.kv_page_bytes()
    assert eng.page_stats() == {
        "pages_total": PAGES, "pages_used": 2, "pages_cached": 0,
        "resident_tokens": 5, "resident_bytes": 2 * eng.kv_page_bytes()}
    assert contig.page_stats() is None
    assert contig.kv_bytes_resident() == 4 * contig.kv_bytes_per_slot()
    assert eng.kv_bytes_resident() < contig.kv_bytes_resident()
    assert eng.cache_sizes() == {"window": 0, "insert": 0, "health": 0,
                                 "prefill_chunk": 0, "page_row": 0}
    eng.release(0)
    assert eng.kv_bytes_resident() == 0


def test_serve_verb_prints_the_paged_and_prefix_lines(tmp_path):
    """`serve --kv-page-size 4 --kv-pages 16 --prefix-cache-mb 4` on the
    CPU: every request ok, the epilogue's `prefix cache:` and `paged
    kv:` lines as the JAX verb prints them, and the summary's page
    keys."""
    import json

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["serve", "--device", "cpu", "--requests", "6",
                       "--slots", "2", "--window", "4", "--t-max", "32",
                       "--prefill-chunk", "8", "--kv-page-size", "4",
                       "--kv-pages", "16", "--prefix-cache-mb", "4"])
    lines = out.getvalue().splitlines()
    assert rc == 0
    assert any(ln.startswith("served: ok=6 ") for ln in lines)
    paged = [ln for ln in lines if ln.startswith("paged kv: ")]
    assert paged and "/16 pages peak (page 4 tokens), resident peak " \
        in paged[0] and "exhaustion backpressure " in paged[0]
    assert any(ln.startswith("prefix cache: hit rate ") for ln in lines)
    summary = json.loads(next(ln for ln in lines
                              if ln.startswith("serve summary: "))[15:])
    assert summary["serve_kv_pages_total"] == 16
    assert 0 < summary["serve_kv_pages_used_peak"] <= 16
