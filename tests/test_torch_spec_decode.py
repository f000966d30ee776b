"""The port's speculative decoding (idc_models_tpu_torch/models/draft.py,
the batched chunk folds in ring_decode.py, the SlotEngine's verify
program, the scheduler's draft-and-verify policy, the speculative
metrics, LMServer(spec_decode=...), the `serve` verb's drafter table and
`SlotEngine.program_costs`) on the CPU, against the JAX package's
drafters, folds and speculative LMServer on the same numpy inputs, and
against the port's own spec-off path and serial Generator.

The contracts, as tests/test_spec_decode.py and tests/test_paged_kv.py
hold them for the JAX package: the drafters propose the JAX drafters'
tokens; the folds give the JAX folds' outputs within f32 rounding and
their caches bit for bit, a dead row's cache bit-untouched; a verify
emits what the window would, and a speculative server makes the JAX
server's verify-or-window choices and ledger -- held here under the
engine-against-serial contract (tokens equal up to the first step where
the serial top-2 margin falls inside 1e-5 of the largest |logit|), and
against the port's own spec-off engine for sampled and int8 caches (the
JAX int8 speculative path is not an oracle: its test fails on the
reference)."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idc_models_tpu import mesh as jmeshlib
from idc_models_tpu import ring_decode as jrd
from idc_models_tpu.models import draft as jdraft
from idc_models_tpu.models import lm as jlm
from idc_models_tpu_torch import cli
from idc_models_tpu_torch import ring_decode as trd
from idc_models_tpu_torch.models import lm as tlm
from idc_models_tpu_torch.models.draft import ChainedDrafter, NGramDrafter
from idc_models_tpu_torch.observe import MetricsRegistry
from idc_models_tpu_torch.serve import (
    LMServer, Request, Scheduler, SlotEngine,
)

VOCAB, SEQ, E, HEADS, MLP, BLOCKS = 11, 32, 32, 2, 64, 2
KW = dict(embed_dim=E, num_heads=HEADS, num_blocks=BLOCKS, t_max=SEQ)
PAGED = dict(prefill_chunk=8, kv_page_size=4, kv_pages=24)
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


def _server(**kw):
    return LMServer(_params(), registry=MetricsRegistry(), **_kw(**kw))


@functools.lru_cache(maxsize=None)
def _gen(temperature=0.0, top_k=None):
    return tlm.Generator(_params(), **_kw(temperature=temperature,
                                          top_k=top_k))


def _serial(prompt, steps):
    """The serial Generator's tokens and, per step, the logits its pick
    read."""
    gen = _gen()
    logits, caches = gen.prefill([list(prompt)])
    toks, seen = [], []
    for i in range(steps):
        seen.append(logits[0].clone())
        tok, logits, caches = gen.decode(caches, logits, len(prompt) + i, 1)
        toks.append(int(tok[0, 0]))
    return toks, seen


def _held(got, want, seen):
    """The engine-against-serial contract for one request: equal tokens
    up to the first step whose serial top-2 margin is inside F32_TOL of
    the largest |logit|. Returns the steps held."""
    assert len(got) == len(want)
    for j, (g, w) in enumerate(zip(got, want)):
        top2 = seen[j].topk(2).values
        if float(top2[0] - top2[1]) < F32_TOL * float(seen[j].abs().max()):
            return j
        assert g == w, (j, got, want)
    return len(want)


class ScriptedDrafter:
    """A drafter forcing an exact accepted-prefix length a request: the
    reference continuation for the first `accept` positions, then
    guaranteed-wrong tokens (reference + 1 mod vocab). Requests are
    keyed by prompt, so plans need prefix-distinct prompts."""

    def __init__(self, k, plans):
        self.k = k
        self.plans = plans              # [(prompt, stream, accept)]

    def propose(self, history):
        h = [int(x) for x in history]
        for prompt, stream, accept in self.plans:
            p = list(prompt)
            if h[:len(p)] != p:
                continue
            done = len(h) - len(p)
            cont = list(stream[done:done + self.k])
            cont += [0] * (self.k - len(cont))
            for j in range(accept, self.k):
                cont[j] = (cont[j] + 1) % VOCAB
            return np.asarray(cont, np.int32)
        return None


def _run(server, reqs):
    server.run([(0.0, r) for r in reqs])
    out = {}
    for r in reqs:
        got = server.poll(r.id)
        assert got is not None and got.status == "ok", (r.id, got)
        out[r.id] = got.tokens
    return out


# -- the drafters against the JAX drafters ----------------------------------


@pytest.mark.parametrize("k,order,min_order,lookback", [
    (3, 2, 1, None), (4, 3, 1, 512), (2, 3, 2, 6), (5, 1, 1, None)])
def test_ngram_drafter_matches_jax(k, order, min_order, lookback):
    """On templated and random histories of every length (1 to 40), the
    port's drafter proposes what the JAX drafter proposes (None alike),
    continuation padding included."""
    ours = NGramDrafter(k, order=order, min_order=min_order,
                        lookback=lookback)
    theirs = jdraft.NGramDrafter(k, order=order, min_order=min_order,
                                 lookback=lookback)
    rng = np.random.default_rng(k * 10 + order)
    hists = [rng.integers(0, 4, n) for n in range(1, 41)]
    hists += [np.tile([1, 2, 3, 4, 5], 6)[:n] for n in range(1, 31)]
    hits = 0
    for h in hists:
        got, want = ours.propose(h), theirs.propose(h)
        assert (got is None) == (want is None), h
        if got is not None:
            hits += 1
            assert got.dtype == np.int32 and np.array_equal(got, want), h
    assert hits >= 5


def test_drafter_validation_and_chain_match_jax():
    """The drafters' refusals carry the JAX messages; a chain is
    first-hit-wins per slot, as the JAX chain."""
    for kw, match in ((dict(k=0), "k >= 1"),
                      (dict(k=2, order=2, min_order=0), "min_order"),
                      (dict(k=2, order=3, lookback=2), "lookback")):
        for cls in (NGramDrafter, jdraft.NGramDrafter):
            with pytest.raises(ValueError, match=match):
                cls(**kw)

    class Fixed:
        def __init__(self, k, row):
            self.k, self.row = k, row

        def propose(self, history):
            return None if self.row is None else np.asarray(self.row)

    for cls in (ChainedDrafter, jdraft.ChainedDrafter):
        with pytest.raises(ValueError, match="at least 2"):
            cls(NGramDrafter(2))
        with pytest.raises(ValueError, match="disagree on k"):
            cls(NGramDrafter(2), NGramDrafter(3))
    hist = np.asarray([1, 2, 1, 2, 1])
    for cls, ng in ((ChainedDrafter, NGramDrafter),
                    (jdraft.ChainedDrafter, jdraft.NGramDrafter)):
        chain = cls(ng(3, order=2), Fixed(3, [7, 7, 7]))
        assert list(chain.propose(hist)) == [2, 1, 1]
        assert list(chain.propose(np.asarray([5, 6]))) == [7, 7, 7]
        assert cls(Fixed(3, None), Fixed(3, None)).propose(hist) is None
        assert chain.learned is None


# -- the folds against the JAX folds ----------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_fold(paged: bool, quantized: bool):
    """The JAX batched chunk fold on a one-device mesh, jitted once."""
    mesh = jmeshlib.seq_mesh(1)
    if paged:
        return jrd.make_paged_batched_chunk_ring_decode(
            mesh, page_size=4, quantized=quantized, jit=True)
    return jrd.make_batched_chunk_ring_decode(mesh, quantized=quantized,
                                              jit=True)


def _t(*xs):
    return tuple(torch.from_numpy(np.array(x, copy=True)) for x in xs)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_batched_chunk_fold_matches_jax(quantized):
    """C = 4 draft queries on rows at their own positions (a live row, a
    live row at 0, a dead row at t_max, a live row whose chunk ends at
    t_max): the JAX fold's outputs within f32 rounding, the caches bit
    for bit, the dead row's cache bit-untouched, nothing outside each
    live row's span written."""
    S, C, H, D = 4, 4, 2, 8
    rng = np.random.default_rng(3)
    kc = rng.normal(size=(S, SEQ, H, D)).astype(np.float32)
    vc = rng.normal(size=(S, SEQ, H, D)).astype(np.float32)
    pos = np.array([6, 0, SEQ, SEQ - C])
    live = np.array([True, True, False, True])
    q, kt, vt = (rng.normal(size=(S, C, H, D)).astype(np.float32)
                 for _ in range(3))
    scales = ()
    if quantized:
        scales = tuple((np.abs(rng.normal(size=(S, H))) * 0.02 + 0.01)
                       .astype(np.float32) for _ in range(2))
        kc = np.clip(np.round(kc / scales[0][:, None, :, None] * 0.02),
                     -127, 127).astype(np.int8)
        vc = np.clip(np.round(vc / scales[1][:, None, :, None] * 0.02),
                     -127, 127).astype(np.int8)
    fold = trd.make_batched_chunk_ring_decode(quantized=quantized)
    out, kc2, vc2 = fold(*_t(kc, vc, q, kt, vt), pos, live, *_t(*scales))
    jout, jkc, jvc = _jax_fold(False, quantized)(
        *map(jnp.asarray, (kc, vc, q, kt, vt, pos, live, *scales)))
    want = np.asarray(jout)[live]
    err = np.abs(out.numpy()[live] - want).max()
    assert err <= F32_TOL * np.abs(want).max(), err
    assert np.array_equal(kc2.numpy(), np.asarray(jkc))
    assert np.array_equal(vc2.numpy(), np.asarray(jvc))
    assert np.array_equal(kc2.numpy()[2], kc[2])
    assert np.array_equal(vc2.numpy()[2], vc[2])
    assert np.array_equal(kc2.numpy()[0, :6], kc[0, :6])
    assert np.array_equal(kc2.numpy()[0, 10:], kc[0, 10:])


def _pool_from_rows(rows, pt, n_pages, ps=4):
    s, t, h, d = rows.shape
    pool = np.zeros((n_pages, ps, h, d), rows.dtype)
    for b in range(s):
        for j in range(t // ps):
            if pt[b, j] >= 0:
                pool[pt[b, j]] = rows[b, j * ps:(j + 1) * ps]
    return pool


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_paged_batched_chunk_fold_matches_jax(quantized):
    """The paged verify fold through pages scattered in an oversized
    pool: a live row, a live row crossing a page edge, a dead row and a
    live row whose chunk runs onto an unallocated page. The JAX fold's
    outputs within f32 rounding and pools bit for bit (its dropped
    writes are the port's sink page's), the dead row's and the spare
    pages untouched, no scale written; in f32 the live rows' outputs and
    logical caches bit-equal to the port's contiguous batched chunk
    fold's."""
    S, C, H, D, PS = 4, 4, 2, 8, 4
    rng = np.random.default_rng(4)
    kc = rng.normal(size=(S, SEQ, H, D)).astype(np.float32)
    vc = rng.normal(size=(S, SEQ, H, D)).astype(np.float32)
    pos = np.array([4, 6, 9, 17])
    live = np.array([True, True, False, True])
    q, kt, vt = (rng.normal(size=(S, C, H, D)).astype(np.float32)
                 for _ in range(3))
    l_pages = SEQ // PS
    n_pg = S * l_pages + 3
    pt = rng.permutation(n_pg)[:S * l_pages].reshape(S, l_pages).astype(
        np.int32)
    pt[3, 20 // PS:] = -1                # 20 of row 3's span: no page
    kp, vp = (_pool_from_rows(x, pt, n_pg) for x in (kc, vc))
    spare = sorted(set(range(n_pg)) - set(pt.ravel().tolist()))
    scales = ()
    if quantized:
        scales = tuple((np.abs(rng.normal(size=(n_pg, H))) * 0.02 + 0.01)
                       .astype(np.float32) for _ in range(2))
        kp = np.clip(np.round(kp * 10), -127, 127).astype(np.int8)
        vp = np.clip(np.round(vp * 10), -127, 127).astype(np.int8)

    def sink(*xs):
        return _t(*(np.concatenate([x, np.zeros_like(x[:1])]) for x in xs))

    fold = trd.make_paged_batched_chunk_ring_decode(page_size=PS,
                                                    quantized=quantized)
    tscales = sink(*scales)
    out, kp2, vp2 = fold(*sink(kp, vp), *_t(pt, q, kt, vt), pos, live,
                         *tscales)
    jout, jkp, jvp = _jax_fold(True, quantized)(
        *map(jnp.asarray, (kp, vp, pt, q, kt, vt, pos, live, *scales)))
    want = np.asarray(jout)[live]
    err = np.abs(out.numpy()[live] - want).max()
    assert err <= F32_TOL * np.abs(want).max(), err
    assert np.array_equal(kp2.numpy()[:-1], np.asarray(jkp))
    assert np.array_equal(vp2.numpy()[:-1], np.asarray(jvp))
    for j in range(l_pages):
        assert np.array_equal(kp2.numpy()[pt[2, j]], kp[pt[2, j]])
    assert np.array_equal(kp2.numpy()[spare], kp[spare])
    for got, before in zip(tscales, sink(*scales)):
        assert torch.equal(got, before)
    if quantized:
        return
    cout, kc2, _ = trd.make_batched_chunk_ring_decode()(
        *_t(kc, vc, q, kt, vt), pos, live & (pos + C <= 20))
    for b in (0, 1):
        assert torch.equal(out[b], cout[b])
        rows = np.concatenate([kp2.numpy()[p] for p in pt[b]])
        assert np.array_equal(rows, kc2.numpy()[b])


# -- the verify program -----------------------------------------------------


def test_parity_at_every_accept_length():
    """Accepted prefixes of 0, 1, k-1 and k (a scripted drafter) all emit
    the serial Generator's streams under the contract, and the ledger
    counts the accepts."""
    k = 4
    prompts = [(i, 2 + i % 3, 5) for i in range(4)]
    budgets = [11, 12, 13, 9]
    refs = [_serial(p, b) for p, b in zip(prompts, budgets)]
    drafter = ScriptedDrafter(k, [(p, r[0], a) for p, r, a
                                  in zip(prompts, refs, (0, 1, k - 1, k))])
    server = _server(n_slots=4, window=4, spec_decode=True, draft_k=k,
                     drafter=drafter)
    reqs = [Request(id=f"a{i}", prompt=p, max_new_tokens=b)
            for i, (p, b) in enumerate(zip(prompts, budgets))]
    got = _run(server, reqs)
    for r, (want, seen) in zip(reqs, refs):
        assert _held(got[r.id], want, seen) == len(want), r.id
    s = server.summary()
    assert s["serve_spec_verify_dispatches"] > 0
    assert s["serve_spec_accepted"] > 0
    assert s["serve_spec_tokens_per_dispatch"] > 1.0


def test_parity_with_eos_inside_accepted_prefix():
    """An EOS inside the accepted prefix truncates as the window's rule
    does: emitted through the EOS, the stream the serial one cut at its
    first EOS."""
    prompt = (1, 2, 3)
    stream, seen = _serial(prompt, 12)
    eos = stream[5]
    cut = stream[:stream.index(eos) + 1]
    server = _server(n_slots=1, window=4, eos_id=eos, spec_decode=True,
                     draft_k=4,
                     drafter=ScriptedDrafter(4, [(prompt, stream, 4)]))
    got = _run(server, [Request(id="e", prompt=prompt, max_new_tokens=12)])
    assert server.poll("e").finish_reason == "eos"
    assert _held(got["e"], cut, seen) == len(cut)


def test_parity_across_slot_recycle_and_budget_edges():
    """Speculative traffic through 2 slots with recycling, and a request
    whose prompt + budget fills the cache to t_max: near the edge
    `spec_room` fails and the cycle falls back to windows, so it still
    finishes; every stream held to the serial one."""
    rng = np.random.default_rng(23)
    reqs, refs, plans = [], [], []
    for i in range(6):
        p = tuple(int(x) for x in rng.integers(0, VOCAB, 3 + 2 * i))
        b = SEQ - len(p) if i == 2 else 4 + (i % 4) * 3
        reqs.append(Request(id=f"r{i}", prompt=p, max_new_tokens=b))
        refs.append(_serial(p, b))
        plans.append((p, refs[-1][0], 4))
    server = _server(n_slots=2, window=4, spec_decode=True, draft_k=4,
                     drafter=ScriptedDrafter(4, plans))
    got = _run(server, reqs)
    for r, (want, seen) in zip(reqs, refs):
        assert _held(got[r.id], want, seen) == len(want), r.id
    assert server.summary()["serve_spec_verify_dispatches"] > 0


@pytest.mark.parametrize("kind", ["sampled", "int8", "chunked", "paged"])
def test_spec_matches_the_spec_off_engine(kind):
    """The spec-off server's streams, fed back to a scripted drafter at
    mixed accept lengths, come out of the spec-on server unchanged:
    sampled (temperature 1.3, top-k 4, seeded -- each verify's draws
    rewound to its emitted count), int8 caches, chunked prefill admitting
    in the same cycle as verifies, and the paged engine (every page back
    at drain)."""
    extra = {"sampled": dict(temperature=1.3, top_k=4),
             "int8": dict(kv_dtype="int8"),
             "chunked": dict(prefill_chunk=8, max_prefills_per_cycle=1),
             "paged": dict(PAGED)}[kind]
    rng = np.random.default_rng(7)
    reqs = [Request(id=f"s{i}", prompt=tuple(
        int(x) for x in rng.integers(0, VOCAB, 2 + 3 * i)),
        max_new_tokens=int(rng.integers(6, 14)), seed=100 + i)
        for i in range(5)]
    base = _run(_server(n_slots=3, window=4, **extra), reqs)
    plans = [(r.prompt, base[r.id], a)
             for r, a in zip(reqs, (3, 1, 0, 3, 2))]
    server = _server(n_slots=3, window=4, spec_decode=True, draft_k=3,
                     drafter=ScriptedDrafter(3, plans), **extra)
    got = _run(server, reqs)
    assert got == base
    s = server.summary()
    assert s["serve_spec_verify_dispatches"] > 0
    assert s["serve_spec_accepted"] > 0
    if kind == "paged":
        assert server.engine._alloc.used_count() == 0


def test_paged_spec_on_repetitive_traffic_with_the_ngram_drafter():
    """The JAX package's paged speculative case: repetitive prompts through
    the default n-gram drafter on the paged engine, streams held to the
    serial Generator, speculation genuinely running."""
    server = _server(n_slots=2, window=4, spec_decode=True, draft_k=4,
                     draft_order=2, **PAGED)
    reqs = [Request(id=f"p{i}", prompt=(1, 2, 3, 1, 2, 3, 1, 2),
                    max_new_tokens=10) for i in range(3)]
    got = _run(server, reqs)
    want, seen = _serial(reqs[0].prompt, 10)
    for r in reqs:
        assert _held(got[r.id], want, seen) == len(want)
    assert server.summary()["serve_spec_verify_dispatches"] > 0


# the speculative summary values both servers must agree on exactly (the
# propose seconds are a clock reading)
SPEC_KEYS = ("serve_spec_verify_dispatches", "serve_spec_drafted",
             "serve_spec_accepted", "serve_spec_accept_rate",
             "serve_spec_tokens_per_dispatch", "serve_decode_dispatches",
             "serve_tokens", "serve_requests")


def _jax_case(case):
    """(server kwargs, drafter factory, requests) of one case of the
    speculative LMServer held against the JAX one, greedy f32 caches:
    "scripted", five requests through four slots, four drafted at
    accepted prefixes of 0, 1, k-1 and k and one never drafted (it rides
    along in verifies, then recycles into a freed slot); "ngram_paged",
    the default n-gram drafter on the paged engine over repetitive and
    random prompts, so some cycles have nothing to verify and dispatch a
    window."""
    if case == "scripted":
        k = 4
        prompts = [(i, 2 + i % 3, 5) for i in range(4)] + [(7, 7, 1, 0)]
        budgets = [11, 12, 13, 9, 10]
        refs = [_serial(p, b)[0] for p, b in zip(prompts[:4], budgets)]
        plans = [(p, r, a) for p, r, a
                 in zip(prompts, refs, (0, 1, k - 1, k))]
        kw = dict(n_slots=4, window=4, draft_k=k)
        return kw, lambda: ScriptedDrafter(k, plans), [
            Request(id=f"j{i}", prompt=p, max_new_tokens=b)
            for i, (p, b) in enumerate(zip(prompts, budgets))]
    rng = np.random.default_rng(11)
    prompts = [(1, 2, 3, 1, 2, 3, 1, 2), (4, 5, 4, 5, 4, 5),
               tuple(int(x) for x in rng.integers(0, VOCAB, 7)),
               (6, 1, 6, 1, 6, 1, 6, 1, 6),
               tuple(int(x) for x in rng.integers(0, VOCAB, 5))]
    return (dict(n_slots=2, window=4, draft_k=4, draft_order=2, **PAGED),
            lambda: None, [Request(id=f"n{i}", prompt=p, max_new_tokens=10)
                           for i, p in enumerate(prompts)])


@functools.lru_cache(maxsize=None)
def _jax_spec_served(case):
    """The JAX speculative LMServer's (summary, {id: tokens}) on one
    `_jax_case`: a one-device mesh, f32 caches."""
    from idc_models_tpu import serve as jserve

    kw, drafter, reqs = _jax_case(case)
    server = jserve.LMServer(_params(), mesh=jmeshlib.seq_mesh(1),
                             cache_dtype=jnp.float32, spec_decode=True,
                             drafter=drafter(), **kw, **KW)
    server.run([(0.0, r) for r in reqs])
    return server.summary(), {r.id: server.poll(r.id).tokens for r in reqs}


@pytest.mark.parametrize("case", ["scripted", "ngram_paged"])
def test_spec_lmserver_matches_the_jax_spec_lmserver(case):
    """The same requests, drafter and weights through the port's and the
    JAX speculative LMServer (greedy, f32): tokens equal request for
    request, every serial pick's top-2 margin far above the rounding (so
    the contract is equality here), and the verify-or-window choices and
    the speculative ledger equal -- verify and window dispatches,
    drafted, accepted, accept rate and tokens a dispatch."""
    want_summary, want = _jax_spec_served(case)
    kw, drafter, reqs = _jax_case(case)
    server = _server(spec_decode=True, drafter=drafter(), **kw)
    got = _run(server, reqs)
    for r in reqs:
        assert got[r.id] == want[r.id], r.id
        for seen in _serial(r.prompt, r.max_new_tokens)[1]:
            top2 = seen.topk(2).values
            assert float(top2[0] - top2[1]) > 1e-3
    summary = server.summary()
    assert set(summary) == set(want_summary)
    for key in SPEC_KEYS:
        assert summary[key] == want_summary[key], key
    assert summary["serve_spec_verify_dispatches"] > 0
    assert summary["serve_spec_accepted"] > 0
    if case == "ngram_paged":
        assert summary["serve_decode_dispatches"] > \
            summary["serve_spec_verify_dispatches"]
        assert server.engine._alloc.used_count() == 0


def test_ledger_counts_only_real_proposals():
    """Two running slots, one drafted for and one riding along: the
    engine's `last_spec` and the summary count only the proposed rows,
    and the ride-along still advances one token a verify."""
    prompt_a, prompt_b = (1, 2, 3), (4, 5, 6, 7)
    stream = _serial(prompt_a, 9)[0]
    server = _server(n_slots=2, window=4, spec_decode=True, draft_k=3,
                     drafter=ScriptedDrafter(3, [(prompt_a, stream, 3)]))
    specs = []
    eng = server.engine
    collect = eng.collect

    def spy():
        out = collect()
        if eng.last_spec is not None:
            specs.append((dict(eng.last_spec), {s: len(t)
                                                for s, t in out.items()}))
        return out

    eng.collect = spy
    _run(server, [Request(id="a", prompt=prompt_a, max_new_tokens=9),
                  Request(id="b", prompt=prompt_b, max_new_tokens=9)])
    assert specs
    for spec, lens in specs:
        assert spec["slots"] == 1 and spec["drafted"] == 3
        assert spec["emitted"] == spec["accepted"] + 1 or spec["emitted"] \
            == spec["accepted"]
    both = [lens for _, lens in specs if len(lens) == 2]
    assert both and all(min(lens.values()) == 1 for lens in both)
    s = server.summary()
    assert s["serve_spec_drafted"] == 3 * len(specs)
    assert s["serve_spec_accept_rate"] == round(
        s["serve_spec_accepted"] / s["serve_spec_drafted"], 4)


def test_engine_and_scheduler_validation_errors():
    """The engine's and scheduler's refusals: draft_k outside
    [1, t_max - 2], a verify on an engine without draft_k, wrong shapes,
    out-of-vocab drafts, a dead or roomless slot, `proposed` outside
    `vlive`, a drafter on an engine without draft_k, a custom drafter
    without spec_decode, and every malformed proposal naming the drafter
    class and the contract."""
    for k in (0, SEQ - 1):
        with pytest.raises(ValueError, match="draft_k"):
            SlotEngine(_params(), draft_k=k, **_kw())
    plain = SlotEngine(_params(), n_slots=2, **_kw())
    with pytest.raises(RuntimeError, match="not armed"):
        plain.begin_verify(np.zeros((2, 3), np.int64), np.zeros(2, bool))
    eng = SlotEngine(_params(), n_slots=2, draft_k=3, **_kw())
    eng.admit(0, (1, 2, 3), 4)
    ok = np.array([True, False])
    for drafts, vlive, match in (
            (np.zeros((2, 4), np.int64), ok, r"drafts must be \[2, 3\]"),
            (np.full((2, 3), VOCAB), ok, "token ids"),
            (np.zeros((2, 3), np.float32), ok, "token ids"),
            (np.zeros((2, 3), np.int64), np.ones(2, bool), "not occupied"),
            (np.zeros((2, 3), np.int64), np.ones(3, bool), "vlive must")):
        with pytest.raises(ValueError, match=match):
            eng.begin_verify(drafts, vlive)
    with pytest.raises(ValueError, match="subset"):
        eng.begin_verify(np.zeros((2, 3), np.int64), ok,
                         proposed=np.array([False, True]))
    eng.admit(1, (1,) * (SEQ - 3), 2)
    assert eng.spec_room(0) and not eng.spec_room(1)
    with pytest.raises(ValueError, match="lacks room"):
        eng.begin_verify(np.zeros((2, 3), np.int64), np.ones(2, bool))
    with pytest.raises(ValueError, match="needs an engine built with"):
        Scheduler(plain, drafter=NGramDrafter(3))
    with pytest.raises(ValueError, match="needs spec_decode"):
        _server(drafter=NGramDrafter(3), warmup=False)
    sched = Scheduler(eng, drafter=NGramDrafter(3))

    class Bad:
        pass

    sched.drafter = Bad()
    assert sched._check_proposal(None, 3) is None
    for prop, match in ((np.zeros(3, np.float32), "dtype float32"),
                        (np.zeros((1, 3), np.int32), "shape"),
                        (np.zeros(2, np.int32), "returned 2 tokens"),
                        (np.array([0, VOCAB, 1]), "out-of-vocab id 11")):
        with pytest.raises(ValueError, match=match) as err:
            sched._check_proposal(prop, 3)
        assert "Bad.propose" in str(err.value)
        assert "models/draft.py contract" in str(err.value)


def test_serve_drafters_table_matches_argparse_and_contract(capsys):
    """`cli.SERVE_DRAFTERS` names exactly the `serve --drafter` choices,
    each entry's class imports and honours `propose(history) -> [k] ids |
    None`."""
    import importlib
    import re

    with pytest.raises(SystemExit):
        cli._parse(["serve", "--drafter", "bogus"])
    listed = re.search(r"choose from ([^)]*)\)", capsys.readouterr().err)
    assert sorted(c.strip(" '") for c in listed.group(1).split(",")) == \
        sorted(cli.SERVE_DRAFTERS)
    for name in cli.SERVE_DRAFTERS:
        assert cli._parse(["serve", "--drafter", name]).drafter == name
    from idc_models_tpu_torch.models import draft_lm as tdlm

    cfg = tdlm.draft_config(VOCAB, SEQ)
    learned = tdlm.DraftLM(3, _draft_tree(cfg), cfg, device="cpu")
    made = {"ngram": NGramDrafter(3, order=2), "learned": learned,
            "chained": ChainedDrafter(NGramDrafter(3, order=2), learned)}
    hist = np.asarray([5, 1, 2, 1, 2, 1, 2], np.int64)
    for name, (module, cls, story) in cli.SERVE_DRAFTERS.items():
        klass = getattr(importlib.import_module(module), cls)
        assert isinstance(made[name], klass) and story
        got = made[name].propose(hist)
        assert got.shape == (3,) and np.issubdtype(got.dtype, np.integer)
        assert ((got >= 0) & (got < VOCAB)).all()
    assert made["chained"].learned is learned


def _draft_tree(cfg):
    from idc_models_tpu_torch import convert
    from idc_models_tpu_torch.models import draft_lm as tdlm
    from idc_models_tpu_torch.models.core import init_params

    return convert.to_jax(init_params(tdlm.draft_lm(cfg), 1))[0]


def _engine_state(eng):
    """Every tensor of the engine's state (a paged pool without its sink
    page, which dead appends may write), and the sampling generators'
    states."""
    sink = slice(None, -1) if eng.paged else slice(None)
    out = [t[sink] for pair in eng._caches for t in pair]
    out += [eng._logits, eng._pos, eng._rem, eng._eos]
    out += [t[sink] for pair in eng._scales for t in pair]
    if eng.paged:
        out.append(eng._pt)
    if eng._dmodel is not None:
        out += [t for pair in eng._dcaches for t in pair]
    out += [g.get_state() for g in eng._gens if g is not None]
    return [t.clone() for t in out]


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_program_costs_leave_the_engine_state_unchanged(layout):
    """`program_costs` runs each program for real, with every row dead:
    on an engine with three live sampled slots mid-decode, a learned
    drafter and (paged) int8 pages, every state tensor is bit-equal
    after it, the programs are filed, and decoding goes on to the
    tokens an untouched twin engine emits."""
    from idc_models_tpu_torch.models import draft_lm as tdlm
    from idc_models_tpu_torch.observe import profile as prof

    cfg = tdlm.draft_config(VOCAB, SEQ)
    extra = (dict(PAGED, kv_dtype="int8") if layout == "paged" else {})
    engines = [SlotEngine(_params(), n_slots=3, draft_k=3, temperature=0.9,
                          draft_model=tdlm.DraftLM(3, _draft_tree(cfg), cfg),
                          **_kw(**extra)) for _ in range(2)]
    for eng in engines:
        for s in range(3):
            eng.admit(s, (1 + s, 2, 3, 4 + s), 8, rng=s)
        eng.step_window(2)
    eng, twin = engines
    before = _engine_state(eng)
    costs = eng.program_costs(4)
    names = {("serve.window_paged" if layout == "paged"
              else "serve.window"), "lm.verify", "serve.propose",
             ("serve.prefill_chunk_paged" if layout == "paged"
              else "serve.prefill")}
    assert set(costs) == names
    assert names <= set(prof.registered_programs())
    assert all(c.available and c.flops for c in costs.values())
    for a, b in zip(before, _engine_state(eng)):
        assert torch.equal(a, b)
    assert eng.step_window(4) == twin.step_window(4)


def test_spec_server_summary_and_cache_sizes():
    """A spec server's `cache_sizes` carries the JAX key set (zeros by
    design), and its warmup leaves no verify rollup behind."""
    from idc_models_tpu_torch.models import draft_lm as tdlm

    cfg = tdlm.draft_config(VOCAB, SEQ)
    server = _server(n_slots=2, spec_decode=True, draft_k=3,
                     drafter=tdlm.DraftLM(3, _draft_tree(cfg), cfg))
    assert server.engine.cache_sizes() == {
        "window": 0, "insert": 0, "health": 0, "prefill": 0, "verify": 0,
        "propose": 0, "draft_ingest": 0, "draft_insert": 0,
        "draft_prefill": 0}
    s = server.summary()
    assert (s["serve_spec_verify_dispatches"], s["serve_spec_drafted"],
            s["serve_spec_propose_s"]) == (0, 0, None)


def test_profile_serve_verb_on_the_cpu(tmp_path, capsys):
    """`profile --model serve --device cpu`: the contiguous and paged
    windows timed, and the window, verify, propose and prefill programs
    accounted, printed and written as profile_program records."""
    import json

    out = tmp_path / "p.jsonl"
    assert cli.main(["profile", "--model", "serve", "--device", "cpu",
                     "--steps", "2", "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert "profile: serve decode loop (4 slots x 8 tokens/window" in text
    assert "  paged: " in text and "ms/window" in text
    programs = {json.loads(line)["program"]
                for line in out.read_text().splitlines()
                if json.loads(line)["event"] == "profile_program"}
    assert programs == {"serve.window", "serve.window_paged", "lm.verify",
                        "serve.propose", "serve.prefill",
                        "serve.prefill_chunk_paged"}


def test_serve_verb_speculative_line(capsys):
    """`serve --spec-decode` (n-gram) on the CPU: every request ok and the
    `speculative (ngram): ...` line with verify and window dispatches."""
    import re

    assert cli.main(["serve", "--device", "cpu", "--requests", "8",
                     "--slots", "4", "--window", "8", "--t-max", "64",
                     "--spec-decode", "--draft-k", "4"]) == 0
    text = capsys.readouterr().out
    assert "served: ok=8 " in text
    line = re.search(r"speculative \(ngram\): drafted=(\d+) accepted=(\d+) "
                     r"accept_rate=\S+ tokens/dispatch=\S+ \((\d+) verify \+ "
                     r"(\d+) window dispatches\) propose_s=\S+", text)
    assert line and int(line.group(3)) > 0
