"""Multi-tenant serving in the port (idc_models_tpu_torch/serve/tenancy.py
and its wiring through the engine, scheduler, metrics, journal and the
`serve` verb) on the CPU, held against the JAX package at the sizes of
``tests/test_tenancy.py`` (vocab 11, T 32, E 32, 2 heads, 2 blocks,
adapters of rank 3 drawn from numpy seeds).

Each of the JAX tests has its counterpart here: a tenant's stream under a
mixed-tenant load equals the same request's on a one-tenant server, bit
for bit (window and verify, contiguous and paged, greedy and sampled);
tenant mixes need no new program; quotas, SLOs and brownouts are scoped
to one tenant; the journal carries the tags; the errors teach. Beside
them the port is held against JAX: the adapter hook within 1e-6 of the
largest |logit| (a zero row bit for bit), the tenanted `LMServer`'s
tokens and `serve_tenants` rollup under the serve tests' contract (f32:
1e-5 of the largest |logit|, tokens while the pick's margin is above
it), the SLO and brownout transitions on a fake clock, the verb's lines
and its usage errors.
"""

from __future__ import annotations

import ast
import contextlib
import functools
import io
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idc_models_tpu import serve as jserve
from idc_models_tpu.models import lm as jlm
from idc_models_tpu.observe import metrics_registry as jreg
from idc_models_tpu.serve import tenancy as jtenancy
from idc_models_tpu_torch import cli
from idc_models_tpu_torch.models import lm as tlm
from idc_models_tpu_torch.observe import MetricsRegistry
from idc_models_tpu_torch.observe import profile as prof
from idc_models_tpu_torch.serve import (
    AdapterBank, LMServer, Request, RequestJournal, SlotEngine, Tenancy,
    TenantQuota, TenantRegistry, pending_requests,
)
from idc_models_tpu_torch.serve import tenancy as ttenancy
from idc_models_tpu_torch.serve.scheduler import Entry

VOCAB, SEQ, E, HEADS, MLP, BLOCKS = 11, 32, 32, 2, 64, 2
RANK = 3
F32_TOL = 1e-5            # of the largest |logit|
HOOK_TOL = 1e-6           # of the largest |logit|


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share a few cores: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _params(sharpen: float = 1.0):
    """The JAX LM's weights (seed 0) as host arrays; `sharpen` scales the
    head, so greedy picks win by more than the two packages' rounding
    where tokens are compared across packages."""
    model = jlm.attention_lm(VOCAB, SEQ, embed_dim=E, num_heads=HEADS,
                             mlp_dim=MLP, num_blocks=BLOCKS)
    params = jax.tree.map(np.array, jax.device_get(
        model.init(jax.random.key(0)).params))
    params["head"]["kernel"] = params["head"]["kernel"] * sharpen
    return params


def _kw(**over):
    kw = dict(embed_dim=E, num_heads=HEADS, num_blocks=BLOCKS, t_max=SEQ,
              cache_dtype=torch.float32, device="cpu")
    kw.update(over)
    return kw


def _engine(**kw):
    return SlotEngine(_params(), **_kw(**kw))


def _server(params=None, **kw):
    return LMServer(_params() if params is None else params,
                    registry=MetricsRegistry(), **_kw(**kw))


def _adapter(seed, scale=0.5):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, scale, (VOCAB, RANK)).astype(np.float32),
            rng.normal(0, scale, (RANK, VOCAB)).astype(np.float32))


def _bank(*adapters):
    """Explicit (u, v) pairs (None: zero rows) stacked into a bank."""
    u = np.zeros((len(adapters), VOCAB, RANK), np.float32)
    v = np.zeros((len(adapters), RANK, VOCAB), np.float32)
    for i, a in enumerate(adapters):
        if a is not None:
            u[i], v[i] = a
    return AdapterBank(u=u, v=v, rank=RANK, vocab=VOCAB)


def _registry(*, quotas=None, slos=None, adapters=None, module=None):
    reg = (module or ttenancy).TenantRegistry()
    for name in ("acme", "globex"):
        reg.register(name, adapter=(adapters or {}).get(name),
                     quota=(quotas or {}).get(name),
                     slo_ttft_p95_ms=(slos or {}).get(name))
    return reg


def _errors(module, steps) -> list[str]:
    """Each step's ValueError message ('' when it did not raise)."""
    out = []
    for step in steps:
        try:
            step(module)
            out.append("")
        except ValueError as e:
            out.append(str(e))
    return out


# -- the adapter hook against JAX ---------------------------------------


@pytest.mark.parametrize("shape", [(4, VOCAB), (4, 5, VOCAB)],
                         ids=["window", "verify"])
def test_adapter_hook_matches_jax_and_a_zero_row_is_the_base(shape):
    """`make_adapter_head_hook` on [S, V] window rows and [S, K+1, V]
    verify candidates, against JAX's on the same numpy inputs within
    1e-6 of the largest |logit|; the rows of a tenant with zero factors
    come back bit for bit."""
    bank = _bank(None, _adapter(1), _adapter(2))
    tslot = np.array([1, 0, 2, 1])
    logits = np.random.default_rng(4).normal(0, 3, shape).astype(np.float32)
    ours = tlm.make_adapter_head_hook(
        torch.from_numpy(bank.u), torch.from_numpy(bank.v),
        torch.from_numpy(tslot))(torch.from_numpy(logits)).numpy()
    theirs = np.asarray(jlm.make_adapter_head_hook(
        jnp.asarray(bank.u), jnp.asarray(bank.v),
        jnp.asarray(tslot, jnp.int32))(jnp.asarray(logits)))
    scale = np.abs(theirs).max()
    assert np.abs(ours - theirs).max() <= HOOK_TOL * scale
    assert np.array_equal(ours[1], logits[1])
    assert not np.allclose(ours[0], logits[0])


# -- registry and build errors ------------------------------------------


def test_registry_validation_teaching_errors():
    """Each misuse raises, with the JAX registry's message."""
    def built(m):
        reg = m.TenantRegistry()
        reg.register("only")
        reg.build()
        reg.register("late")

    def dup(m):
        reg = m.TenantRegistry()
        reg.register("acme")
        reg.register("acme")

    def default(m):
        reg = m.TenantRegistry(default="ghost")
        reg.register("x")
        reg.build()

    steps = [dup, lambda m: m.TenantRegistry().register(""),
             lambda m: m.TenantQuota(max_resident_slots=0),
             lambda m: m.TenantQuota(max_queued=-1),
             lambda m: m.TenantRegistry().register("b", slo_ttft_p95_ms=0),
             lambda m: m.TenantRegistry().register("c", quota=3),
             lambda m: m.TenantRegistry().build(), default, built]
    ours = _errors(ttenancy, steps)
    assert ours == _errors(jtenancy, steps)
    for msg, want in zip(ours, ("already registered", "non-empty string",
                                "admit nothing ever", "admit nothing ever",
                                "slo_ttft_p95_ms", "TenantQuota",
                                "no tenants", "default tenant",
                                "already built")):
        assert want in msg, (msg, want)


def test_adapter_shape_mismatch_rejected_at_build():
    u, v = _adapter(0)
    rng = np.random.default_rng(9)
    other = (rng.normal(size=(VOCAB, RANK + 2)).astype(np.float32),
             rng.normal(size=(RANK + 2, VOCAB)).astype(np.float32))

    def shared(m):
        reg = m.TenantRegistry()
        reg.register("a", adapter=(u, v))
        reg.register("b", adapter=other)

    def vocab(m):
        reg = m.TenantRegistry()
        reg.register("a", adapter=(u, v))
        reg.build(vocab=VOCAB + 5)

    steps = [lambda m: m.TenantRegistry().register("a", adapter=u),
             lambda m: m.TenantRegistry().register("a", adapter=(u, v.T)),
             shared, vocab]
    ours = _errors(ttenancy, steps)
    assert ours == _errors(jtenancy, steps)
    for msg, want in zip(ours, ("(u, v) pair", "transposes",
                                "share one [V, r]", "model vocab")):
        assert want in msg, (msg, want)
    # the bank: zero rows for the adapter-less tenant
    reg = ttenancy.TenantRegistry()
    reg.register("plain")
    reg.register("a", adapter=(u, v))
    bank = reg.build(vocab=VOCAB).bank
    assert bank.u.shape == (2, VOCAB, RANK) and bank.rank == RANK
    assert not bank.u[0].any() and not bank.v[0].any()
    assert np.array_equal(bank.u[1], u) and np.array_equal(bank.v[1], v)


def test_engine_rejects_wrong_vocab_bank_and_bad_tid():
    bank = AdapterBank(u=np.zeros((2, VOCAB + 1, RANK), np.float32),
                       v=np.zeros((2, RANK, VOCAB + 1), np.float32),
                       rank=RANK, vocab=VOCAB + 1)
    with pytest.raises(ValueError, match="model vocab"):
        _engine(n_slots=2, adapter_bank=bank)
    eng = _engine(n_slots=2, adapter_bank=_bank(_adapter(0), None))
    for tid in (2, -1):
        with pytest.raises(ValueError, match="out of range"):
            eng.admit(0, [1, 2, 3], 4, tid=tid)
    chunked = _engine(n_slots=2, prefill_chunk=8,
                      adapter_bank=_bank(_adapter(0), None))
    with pytest.raises(ValueError, match="out of range"):
        chunked.start_prefill(0, [1, 2, 3], 4, tid=2)
    # without a bank the id steers nothing
    _engine(n_slots=2).admit(0, [1, 2, 3], 4, tid=5)
    with pytest.raises(ValueError, match="multi-tenant server"):
        _engine(n_slots=2).swap_adapters(bank.u, bank.v)
    with pytest.raises(ValueError, match="must equal"):
        eng.swap_adapters(bank.u, bank.v)


def test_unknown_tenant_is_a_loud_caller_error():
    server = _server(n_slots=2, tenancy=_registry())
    with pytest.raises(ValueError, match="unknown tenant 'ghost'"):
        server.submit(Request(id="x", prompt=(1, 2), max_new_tokens=2,
                              tenant="ghost"))
    # an untagged request is the first registered tenant's
    assert server.submit(Request(id="y", prompt=(1, 2), max_new_tokens=2))
    server.drain()
    assert server.summary()["serve_tenants"]["acme"]["requests"] == 1


# -- parity: engine level (window, verify) and server level (paged) -----


def _engine_tokens(eng, prompt, budget, tid, *, rng=None):
    eng.admit(0, prompt, budget, tid=tid, rng=rng)
    out = []
    while not eng.finished(0):
        out.extend(eng.step_window(4).get(0, []))
    eng.release(0)
    return out


def test_engine_mixed_vs_single_tenant_parity_greedy_and_sampled():
    """A tenant's stream through a two-tenant bank (its row gathered at
    tid 1) equals a one-tenant bank's (tid 0) bit for bit, greedy and
    seeded top-k, and the adapter changes the stream against the base."""
    a = _adapter(7)
    prompt = [1, 4, 2, 7, 5]
    mixed = _engine(n_slots=2, adapter_bank=_bank(_adapter(3), a))
    solo = _engine(n_slots=2, adapter_bank=_bank(a))
    want = _engine_tokens(solo, prompt, 8, 0)
    assert _engine_tokens(mixed, prompt, 8, 1) == want
    assert _engine_tokens(_engine(n_slots=2), prompt, 8, 0) != want
    samp = dict(n_slots=2, temperature=0.9, top_k=5)
    m_s = _engine(adapter_bank=_bank(_adapter(3), a), **samp)
    s_s = _engine(adapter_bank=_bank(a), **samp)
    assert (_engine_tokens(m_s, prompt, 8, 1, rng=123)
            == _engine_tokens(s_s, prompt, 8, 0, rng=123))


def test_engine_zero_bank_reproduces_the_untenanted_tokens():
    """A bank of zero rows changes nothing: tokens, stored logits and
    positions equal the bank-less engine's bit for bit."""
    prompt = [3, 1, 4, 1, 5]
    plain = _engine(n_slots=2)
    zero = _engine(n_slots=2, adapter_bank=_bank(None, None, None))
    assert (_engine_tokens(zero, prompt, 9, 2)
            == _engine_tokens(plain, prompt, 9, 0))
    assert torch.equal(zero._logits, plain._logits)


def test_engine_verify_program_applies_adapter_identically():
    """The verify's adapter path: the same drafts into a mixed-bank
    engine (tid 1) and a one-tenant bank (tid 0) emit the same tokens,
    and those are the tokens a window emits through the same head."""
    a = _adapter(11)
    outs = []
    for bank, tid in ((_bank(_adapter(5), a), 1), (_bank(a), 0)):
        eng = _engine(n_slots=2, draft_k=3, adapter_bank=bank)
        eng.admit(0, [2, 6, 1], 10, tid=tid)
        drafts = np.zeros((2, 3), np.int64)
        drafts[0] = [3, 1, 4]
        eng.begin_verify(drafts, np.array([True, False]))
        outs.append(eng.collect()[0])
    assert outs[0] == outs[1] and outs[0]
    # drafts equal to the window's own picks are all accepted
    want = _engine_tokens(_engine(n_slots=2, adapter_bank=_bank(a)),
                          [2, 6, 1], 10, 0)
    eng = _engine(n_slots=2, draft_k=3, adapter_bank=_bank(a))
    eng.admit(0, [2, 6, 1], 10)
    drafts = np.zeros((2, 3), np.int64)
    drafts[0] = want[:3]
    eng.begin_verify(drafts, np.array([True, False]))
    assert eng.collect()[0] == want[:4]
    assert eng.last_spec["accepted"] == 3


def test_server_mixed_vs_single_tenant_parity_paged():
    """Mixed two-tenant load on a PAGED server against a one-tenant
    paged server, bit for bit per request."""
    a, g = _adapter(21), _adapter(22)
    paged = dict(prefill_chunk=4, kv_page_size=4, kv_pages=24)
    mixed = _server(n_slots=3, window=4,
                    tenancy=_registry(adapters={"acme": a, "globex": g}),
                    **paged)
    reqs = [Request(id=f"r{i}",
                    prompt=tuple([1 + i, 2, 3 + i, 4, 5][:3 + i % 3]),
                    max_new_tokens=5 + i % 4,
                    tenant=("acme" if i % 2 else "globex"))
            for i in range(6)]
    got = {r.id: r.tokens for r in mixed.run([(0.0, r) for r in reqs])}
    for name, adapter in (("acme", a), ("globex", g)):
        reg = TenantRegistry()
        reg.register(name, adapter=adapter)
        solo = _server(n_slots=3, window=4, tenancy=reg, **paged)
        for r in reqs:
            if r.tenant != name:
                continue
            want = solo.run([(0.0, Request(
                id=r.id, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                tenant=name))])[0]
            assert got[r.id] == want.tokens, (r.id, got[r.id], want.tokens)


def test_zero_new_programs_across_tenant_arrival_patterns():
    """Tenant ids are values: after a first mixed wave any arrival
    pattern runs with the engine's program counts and the compile
    watchdog flat (eager PyTorch compiles nothing at all)."""
    server = _server(n_slots=3, window=4, tenancy=_registry(
        adapters={"acme": _adapter(1), "globex": _adapter(2)}))
    rng = np.random.default_rng(3)

    def wave(tag, tenants):
        return [(0.0, Request(
            id=f"{tag}{i}", prompt=tuple(int(x) for x in
                                         rng.integers(0, VOCAB, 3 + i % 5)),
            max_new_tokens=3 + i % 4, tenant=t))
            for i, t in enumerate(tenants)]

    server.run(wave("w", ["acme", "globex"]))
    sizes = server.engine.cache_sizes()
    wd = prof.arm_watchdog(registry=MetricsRegistry())
    try:
        server.run(wave("a", ["acme"] * 4))
        server.run(wave("b", ["globex"] * 4))
        server.run(wave("c", ["globex", "acme", "acme", "globex"]))
    finally:
        prof.disarm_watchdog()
    assert server.engine.cache_sizes() == sizes
    assert wd.report()["total_compiles"] == 0
    assert server.summary()["serve_compiles_observed"] == 0


def _eff_steps(eng, prompt, budget, tid):
    """The effective pick logits of every step of one request decoded
    alone in slot 0 (windows of 1), and its tokens."""
    eng.admit(0, prompt, budget, tid=tid)
    rows, toks = [], []
    while not eng.finished(0):
        hook = eng._head_hook()
        rows.append((eng._logits if hook is None
                     else hook(eng._logits))[0].clone())
        toks.extend(eng.step_window(1)[0])
    eng.release(0)
    return rows, toks


@functools.lru_cache(maxsize=None)
def _jax_tenanted():
    """The JAX LMServer with two adapter tenants over a 6-request
    round-robin trace: ({id: tokens}, serve_tenants)."""
    reg = _registry(adapters={"acme": _adapter(31), "globex": _adapter(32)},
                    module=jtenancy)
    server = jserve.LMServer(_params(8.0), n_slots=3, window=4, mesh=None,
                             cache_dtype=jnp.float32, tenancy=reg,
                             registry=jreg.MetricsRegistry(),
                             embed_dim=E, num_heads=HEADS,
                             num_blocks=BLOCKS, t_max=SEQ)
    trace = jserve.poisson_trace(6, rate_per_s=50.0, vocab=VOCAB,
                                 t_max=SEQ, prompt_lens=(2, 12),
                                 budgets=(2, 12), seed=3,
                                 tenants=["acme", "globex"])
    server.run(trace)
    return ({r.id: server.poll(r.id).tokens for _, r in trace},
            server.summary()["serve_tenants"])


def test_tenanted_lmserver_matches_the_jax_lmserver():
    """The same tagged trace through both tenanted servers: each
    request's tokens equal JAX's while the effective pick's top-2 margin
    stays above the f32 tolerance (every step here, checked on the
    port's own per-step effective logits), and the per-tenant rollup's
    counts equal JAX's."""
    from idc_models_tpu_torch.serve import poisson_trace

    want, want_tenants = _jax_tenanted()
    adapters = {"acme": _adapter(31), "globex": _adapter(32)}
    server = _server(_params(8.0), n_slots=3, window=4,
                     tenancy=_registry(adapters=adapters))
    trace = poisson_trace(6, rate_per_s=50.0, vocab=VOCAB, t_max=SEQ,
                          prompt_lens=(2, 12), budgets=(2, 12), seed=3,
                          tenants=["acme", "globex"])
    server.run(trace)
    probe = SlotEngine(_params(8.0), n_slots=3,
                       adapter_bank=server.tenancy.bank, **_kw())
    held = 0
    for _, r in trace:
        res = server.poll(r.id)
        assert res.status == "ok"
        rows, _ = _eff_steps(probe, r.prompt, r.max_new_tokens,
                             server.tenancy.resolve(r.tenant).tid)
        for row, got, exp in zip(rows, res.tokens, want[r.id]):
            top2 = row.topk(2).values
            assert float(top2[0] - top2[1]) > 2 * F32_TOL * float(
                row.abs().max())
            assert got == exp, r.id
            held += 1
        assert len(res.tokens) == len(want[r.id])
    assert held == sum(len(t) for t in want.values())
    got_tenants = server.summary()["serve_tenants"]
    assert set(got_tenants) == set(want_tenants)
    for name, rec in got_tenants.items():
        for key in ("requests", "tokens", "shed", "quota_rejections",
                    "slo_breached"):
            assert rec[key] == want_tenants[name][key], (name, key)


# -- isolation: quotas, SLOs, per-tenant brownout -----------------------


def test_slot_quota_caps_tenant_without_starving_neighbor():
    """acme holds at most 1 of 3 slots through a burst of its own work
    while globex's entries, queued behind it, are admitted past it."""
    server = _server(n_slots=3, window=4, tenancy=_registry(
        quotas={"acme": TenantQuota(max_resident_slots=1)}))
    reqs = ([Request(id=f"a{i}", prompt=(1, 2, 3), max_new_tokens=8,
                     tenant="acme") for i in range(4)]
            + [Request(id=f"g{i}", prompt=(4, 5), max_new_tokens=8,
                       tenant="globex") for i in range(4)])
    for r in reqs:
        assert server.submit(r)
    peak = {"acme": 0, "globex": 0}
    while not server.scheduler.idle():
        server.step()
        slots, _ = server.scheduler._tenant_residency()
        for name in peak:
            peak[name] = max(peak[name], slots.get(name, 0))
    assert peak == {"acme": 1, "globex": 2}
    assert all(server.poll(r.id).status == "ok" for r in reqs)
    assert server.scheduler._tenant_residency() == ({}, {})


def test_queue_quota_rejects_flood_without_touching_neighbors(tmp_path):
    from idc_models_tpu_torch.observe import JsonlLogger

    logger = JsonlLogger(tmp_path / "serve.jsonl")
    server = _server(n_slots=1, window=4, logger=logger, tenancy=_registry(
        quotas={"acme": TenantQuota(max_queued=2)}))
    acc = [server.submit(Request(id=f"a{i}", prompt=(1, 2),
                                 max_new_tokens=4, tenant="acme"))
           for i in range(6)]
    assert acc == [True, True, False, False, False, False]
    assert len(server.scheduler.queue) == 2
    assert server.submit(Request(id="g0", prompt=(3,), max_new_tokens=4,
                                 tenant="globex"))
    server.drain()
    logger.close()
    s = server.summary()
    assert s["serve_tenants"]["acme"]["quota_rejections"] == 4
    assert s["serve_tenants"]["globex"]["quota_rejections"] == 0
    assert s["serve_tenants"]["globex"]["requests"] == 1
    assert s["serve_rejected"] == 4
    events = [json.loads(line) for line in
              (tmp_path / "serve.jsonl").read_text().splitlines()]
    rejects = [e for e in events
               if e["event"] == "serve_tenant_quota_reject"]
    assert [(e["id"], e["tenant"], e["kind"]) for e in rejects] == [
        (f"a{i}", "acme", "queued") for i in range(2, 6)]
    assert sum(e["event"] == "serve_tenant_finish" for e in events) == 3
    assert server.metrics._m_t_quota.value(tenant="acme",
                                           kind="queued") == 4


def test_page_quota_bounds_tenant_kv_reservations():
    """Paged engine: acme's admissions hold at most 3 pool pages, so its
    requests run one at a time while globex admits from the same pool."""
    server = _server(n_slots=3, window=4, prefill_chunk=4, kv_page_size=4,
                     kv_pages=24, tenancy=_registry(
                         quotas={"acme": TenantQuota(kv_page_budget=3)}))
    # prompt 4 + budget 8 = 12 tokens = 3 pages a request
    reqs = ([Request(id=f"a{i}", prompt=(1, 2, 3, 4), max_new_tokens=8,
                     tenant="acme") for i in range(3)]
            + [Request(id=f"g{i}", prompt=(5, 6, 7, 8), max_new_tokens=8,
                       tenant="globex") for i in range(3)])
    for r in reqs:
        assert server.submit(r)
    peak = {"acme": 0, "globex": 0}
    while not server.scheduler.idle():
        server.step()
        _, pages = server.scheduler._tenant_residency()
        for name in peak:
            peak[name] = max(peak[name], pages.get(name, 0))
    assert peak["acme"] == 3 and peak["globex"] == 6
    assert all(server.poll(r.id).status == "ok" for r in reqs)


class _Clock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _slo_drill(module):
    """Burn acme's ttft:acme objective (5x its 100 ms) beside a healthy
    globex on a fake clock; returns (breached, stages, transitions)."""
    clock = _Clock()
    ten = _registry(slos={"acme": 100.0, "globex": 100.0},
                    module=module).build(
        clock=clock, slo_short_window_s=10.0, slo_min_samples=5,
        brownout_dwell_s=0.0,
        registry=(MetricsRegistry() if module is ttenancy
                  else jreg.MetricsRegistry()))
    for _ in range(20):
        clock.now += 0.1
        ten.observe_ttft("acme", 0.5)
        ten.observe_ttft("globex", 0.01)
    ten.evaluate()
    breached = (ten.breached("acme"), ten.breached("globex"))
    for _ in range(4):
        ten.brownouts["acme"].evaluate(queue_depth=0)
        ten.brownouts["globex"].evaluate(queue_depth=0)
        clock.now += 1.0
    return (breached,
            {n: b.stage for n, b in ten.brownouts.items()},
            {n: b.transitions for n, b in ten.brownouts.items()})


def test_per_tenant_slo_breach_and_brownout_are_tenant_scoped():
    """Only the burning tenant's objective breaches and only its own
    brownout escalates, to shed; the transitions are JAX's."""
    ours = _slo_drill(ttenancy)
    assert ours[0] == (True, False)
    assert ours[1] == {"acme": 3, "globex": 0}
    assert [t["tenant"] for t in ours[2]["acme"]] == ["acme"] * 3
    assert ours == _slo_drill(jtenancy)


def test_tenant_shed_refuses_only_that_tenant():
    reg = _registry(quotas={"acme": TenantQuota(max_queued=8)})
    ten = reg.build(registry=MetricsRegistry())
    assert isinstance(ten, Tenancy) and ten.brownout("globex") is None
    ten.brownouts["acme"].force_stage(3, reason="drill")
    server = _server(n_slots=2, tenancy=ten)
    assert not server.submit(Request(id="a0", prompt=(1, 2),
                                     max_new_tokens=2, tenant="acme"))
    assert server.poll("a0").status == "shed"
    assert server.submit(Request(id="g0", prompt=(1, 2), max_new_tokens=2,
                                 tenant="globex"))
    server.drain()
    assert server.poll("g0").status == "ok"
    s = server.summary()["serve_tenants"]
    assert s["acme"]["shed"] == 1 and s["globex"]["shed"] == 0


def test_tenant_clamp_composes_with_the_server_clamp_by_min():
    """The server-wide clamp (stage 2, 6 tokens) and acme's own (stage
    2, 3 tokens) compose by min: acme's budget is cut to 3, globex's to
    the server's 6."""
    from idc_models_tpu_torch.serve import BrownoutController

    reg = _registry(quotas={"acme": TenantQuota(max_queued=8)})
    ten = reg.build(registry=MetricsRegistry(), brownout_clamp_tokens=3)
    ten.brownouts["acme"].force_stage(2, reason="drill")
    server_bc = BrownoutController(queue_high=50, clamp_tokens=6,
                                   registry=MetricsRegistry())
    server_bc.force_stage(2, reason="drill")
    server = _server(n_slots=2, tenancy=ten, brownout=server_bc)
    for rid, tenant in (("a0", "acme"), ("g0", "globex")):
        assert server.submit(Request(id=rid, prompt=(1, 2),
                                     max_new_tokens=10, tenant=tenant))
    server.drain()
    assert [len(server.poll(r).tokens) for r in ("a0", "g0")] == [3, 6]
    assert server.poll("a0").clamped and server.poll("g0").clamped


_QUOTA_REQS = {       # (id, prompt, budget, tenant) for each scenario
    "slot": [(f"a{i}", (1, 2, 3), 8, "acme") for i in range(4)]
    + [(f"g{i}", (4, 5), 8, "globex") for i in range(4)],
    "page": [(f"a{i}", (1, 2, 3, 4), 8, "acme") for i in range(3)]
    + [(f"g{i}", (5, 6, 7, 8), 8, "globex") for i in range(3)],
    "clamp": [("a0", (1, 2), 10, "acme"), ("g0", (1, 2), 10, "globex"),
              ("a1", (3,), 10, "acme"), ("g1", (4, 5, 6), 10, "globex")],
}


def _quota_run(port: bool, kind: str, path: Path):
    """One quota scenario through the port's LMServer (`port`) or the
    JAX package's, with adapters on both tenants: (the server, its
    per-cycle `_tenant_residency()`, its `serve_admit` ids in order)."""
    from idc_models_tpu.observe import JsonlLogger as JLogger
    from idc_models_tpu_torch.observe import JsonlLogger
    from idc_models_tpu_torch.serve import BrownoutController

    mod = ttenancy if port else jtenancy
    new_registry = MetricsRegistry if port else jreg.MetricsRegistry
    kw = dict(n_slots=3, window=4)
    reg = _registry(quotas={
        "slot": {"acme": mod.TenantQuota(max_resident_slots=1)},
        "page": {"acme": mod.TenantQuota(kv_page_budget=3)},
        "clamp": {"acme": mod.TenantQuota(max_queued=8)},
    }[kind], adapters={"acme": _adapter(31), "globex": _adapter(32)},
        module=mod)
    if kind == "page":           # 12 tokens = 3 pages a request
        kw.update(prefill_chunk=4, kv_page_size=4, kv_pages=24)
    if kind == "clamp":          # acme's own clamp 3, the server's 6
        kw["n_slots"] = 2
        reg = reg.build(vocab=VOCAB, registry=new_registry(),
                        brownout_clamp_tokens=3, brownout_clear_s=1e9)
        reg.brownouts["acme"].force_stage(2, reason="drill")
        bc_cls = BrownoutController if port else jserve.BrownoutController
        kw["brownout"] = bc_cls(queue_high=50, clamp_tokens=6,
                                clear_after_s=1e9, registry=new_registry())
        kw["brownout"].force_stage(2, reason="drill")
    logger = (JsonlLogger if port else JLogger)(path)
    if port:
        server = _server(_params(8.0), tenancy=reg, logger=logger, **kw)
    else:
        server = jserve.LMServer(_params(8.0), mesh=None,
                                 cache_dtype=jnp.float32, tenancy=reg,
                                 registry=jreg.MetricsRegistry(),
                                 logger=logger, embed_dim=E,
                                 num_heads=HEADS, num_blocks=BLOCKS,
                                 t_max=SEQ, **kw)
    req_cls = Request if port else jserve.Request
    for rid, prompt, budget, tenant in _QUOTA_REQS[kind]:
        assert server.submit(req_cls(id=rid, prompt=prompt,
                                     max_new_tokens=budget, tenant=tenant))
    cycles = []
    while not server.scheduler.idle():
        server.step()
        slots, pages = server.scheduler._tenant_residency()
        cycles.append((dict(slots), {k: int(v) for k, v in pages.items()}))
    logger.close()
    admits = [e["id"] for e in map(json.loads, path.read_text().splitlines())
              if e["event"] == "serve_admit"]
    return server, cycles, admits


@pytest.mark.parametrize("kind", ["slot", "page", "clamp"])
def test_quota_admission_matches_the_jax_lmserver(kind, tmp_path):
    """The tenanted admission scan against JAX's on the same registry and
    requests: a slot quota (contiguous), a page quota (paged), and the
    tenant clamp composed with the server's by min. The per-cycle
    residency, the admission order and each request's tokens (while the
    effective pick's top-2 margin stays above the f32 tolerance) equal
    JAX's."""
    server, cycles, admits = _quota_run(True, kind, tmp_path / "p.jsonl")
    jserver, jcycles, jadmits = _quota_run(False, kind,
                                           tmp_path / "j.jsonl")
    assert cycles == jcycles
    assert admits == jadmits
    if kind != "clamp":          # the quota binds: acme 1 slot, 3 pages
        held = [c[0 if kind == "slot" else 1].get("acme", 0) for c in cycles]
        assert max(held) == (1 if kind == "slot" else 3)
    assert sorted(admits) == sorted(r[0] for r in _QUOTA_REQS[kind])
    probe = SlotEngine(_params(8.0), n_slots=3,
                       adapter_bank=server.tenancy.bank, **_kw())
    for rid, prompt, _, tenant in _QUOTA_REQS[kind]:
        res, want = server.poll(rid), jserver.poll(rid)
        assert res.status == want.status == "ok"
        if kind == "clamp":      # acme's own 3 and the server's 6 by min
            assert res.clamped and len(res.tokens) == (
                3 if tenant == "acme" else 6)
        rows, _ = _eff_steps(probe, prompt, len(res.tokens),
                             server.tenancy.resolve(tenant).tid)
        for row in rows:
            top2 = row.topk(2).values
            assert float(top2[0] - top2[1]) > 2 * F32_TOL * float(
                row.abs().max())
        assert list(res.tokens) == list(want.tokens), rid


# -- the journal ---------------------------------------------------------


def test_journal_preserves_tenant_tags(tmp_path):
    """Recovery bills the same tenant: the journaled submits carry their
    tags (JAX's `load_journal` reads them off the port's file too), and
    a rebuilt server's resubmissions land under each tenant's rollup."""
    path = tmp_path / "wal.jsonl"
    server = _server(n_slots=2, tenancy=_registry(), journal=str(path))
    for i, tenant in enumerate(["acme", "globex", "acme"]):
        assert server.submit(Request(id=f"r{i}", prompt=(1, 2, 3),
                                     max_new_tokens=3, tenant=tenant))
    server.close()
    assert [r.tenant for r in pending_requests(path)] == [
        "acme", "globex", "acme"]
    from idc_models_tpu.serve.journal import (
        pending_requests as jpending,
    )

    assert [r.tenant for r in jpending(path)] == ["acme", "globex", "acme"]
    server2 = _server(n_slots=2, tenancy=_registry(), journal=str(path))
    assert server2.resubmit_pending(path) == ["r0", "r1", "r2"]
    server2.drain()
    s = server2.summary()["serve_tenants"]
    assert s["acme"]["requests"] == 2 and s["globex"]["requests"] == 1


def test_journal_without_tenants_stays_byte_identical(tmp_path):
    """An untagged submit writes no tenant key; a tagged one writes the
    JAX journal's record."""
    from idc_models_tpu.serve.journal import RequestJournal as JJournal
    from idc_models_tpu.serve.scheduler import Entry as JEntry

    for name, tenant in (("plain", None), ("tagged", "acme")):
        ours, theirs = tmp_path / f"{name}.t", tmp_path / f"{name}.j"
        for cls, ent, path in ((RequestJournal, Entry, ours),
                               (JJournal, JEntry, theirs)):
            j = cls(path)
            j.record_submit(ent(rid="r0", prompt=np.array([1, 2]),
                                budget=3, tenant=tenant), deadline_s=None)
            j.close()
        got, want = (json.loads(p.read_text()) for p in (ours, theirs))
        got.pop("ts"), want.pop("ts")
        assert got == want
        assert ("tenant" in got) == (tenant is not None)


def test_recovery_skips_decommissioned_tenant_without_aborting(tmp_path):
    """A WAL entry of a tenant the rebuilt server no longer registers is
    skipped with a warning, stays in the WAL, and every other request
    comes back."""
    path = tmp_path / "wal.jsonl"
    server = _server(n_slots=2, tenancy=_registry(), journal=str(path))
    for i, tenant in enumerate(["acme", "globex", "acme"]):
        assert server.submit(Request(id=f"r{i}", prompt=(1, 2, 3),
                                     max_new_tokens=3, tenant=tenant))
    server.close()
    reg = TenantRegistry()
    reg.register("acme")                 # globex decommissioned
    server2 = _server(n_slots=2, tenancy=reg, journal=str(path))
    with pytest.warns(UserWarning, match="skipped request 'r1'"):
        recovered = server2.resubmit_pending(path)
    assert recovered == ["r0", "r2"]
    server2.drain()
    assert server2.summary()["serve_tenants"]["acme"]["requests"] == 2
    server2.close()
    assert [r.id for r in pending_requests(path)] == ["r1"]


# -- /healthz, the drafter heads ----------------------------------------


def test_healthz_gains_a_tenants_block_only_with_tenancy():
    from idc_models_tpu_torch.observe import MetricsExporter

    reg = MetricsRegistry()
    tenanted = LMServer(_params(), registry=reg, n_slots=2, tenancy=_registry(
        quotas={"acme": TenantQuota(max_queued=4)}).build(registry=reg),
        **_kw())
    tenanted.run([(0.0, Request(id="r0", prompt=(1, 2), max_new_tokens=3,
                                tenant="globex"))])
    doc = MetricsExporter(reg).health()
    assert doc["tenants"] == {
        "acme": {"queue_depth": 0, "slots_used": 0, "kv_pages_used": 0,
                 "brownout_stage": 0},
        "globex": {"queue_depth": 0, "slots_used": 0, "kv_pages_used": 0,
                   "brownout_stage": None}}
    plain = MetricsRegistry()
    LMServer(_params(), registry=plain, n_slots=2, **_kw()).run(
        [(0.0, Request(id="r0", prompt=(1, 2), max_new_tokens=3))])
    assert "tenants" not in MetricsExporter(plain).health()
    assert "serve_tenant" not in plain.prometheus_text()


@functools.lru_cache(maxsize=None)
def _draft_model():
    """A one-block learned drafter's (params, config), seed 1."""
    from idc_models_tpu.models import draft_lm as jdlm

    config = jdlm.draft_config(VOCAB, SEQ, embed_dim=16, num_heads=2,
                               mlp_dim=32, num_blocks=1)
    return jax.tree.map(np.array, jax.device_get(
        jdlm.draft_lm(config).init(jax.random.key(1)).params)), config


def test_drafter_heads_gather_by_the_slot_tenant():
    """Per-tenant drafter heads: a learned drafter whose tenant-1 head
    is zero proposes the head-less drafter's tokens for a tenant-1 slot
    and other tokens for a tenant-0 slot with a strong head."""
    from idc_models_tpu_torch.models.draft_lm import DraftLM

    dparams, config = _draft_model()
    head = _adapter(41, scale=3.0)
    du = np.stack([head[0], np.zeros_like(head[0])])
    dv = np.stack([head[1], np.zeros_like(head[1])])
    prompt = [1, 5, 2, 8, 3]
    drafts = {}
    for name, adapters, tid in (("plain", None, 0), ("zero", (du, dv), 1),
                                ("head", (du, dv), 0)):
        eng = _engine(n_slots=2, draft_k=3, adapter_bank=_bank(None, None),
                      draft_model=DraftLM(3, dparams, config,
                                          adapters=adapters))
        eng.admit(0, prompt, 8, tid=tid)
        drafts[name] = eng.propose_all()[0][0].tolist()
    assert drafts["zero"] == drafts["plain"]
    assert drafts["head"] != drafts["plain"]


def test_drafter_bank_rows_are_checked_without_a_target_bank():
    """Tenants without target adapters (no target bank) still index a
    learned drafter's per-tenant heads by tenant id: an id past the
    drafter bank's rows is refused at admission, and a tenancy whose
    tenant count differs from those rows is refused when the server is
    built, not by an out-of-range gather mid-serve."""
    from idc_models_tpu_torch.models.draft_lm import DraftLM

    dparams, config = _draft_model()
    head = _adapter(41, scale=3.0)
    one = (head[0][None], head[1][None])
    eng = _engine(n_slots=2, draft_k=3,
                  draft_model=DraftLM(3, dparams, config, adapters=one))
    eng.admit(0, [1, 5, 2], 4, tid=0)
    for tid in (1, -1):
        with pytest.raises(ValueError,
                           match="drafter adapter bank was built with 1"):
            eng.admit(1, [1, 5, 2], 4, tid=tid)
    with pytest.raises(ValueError, match="one row per registered tenant"):
        _server(n_slots=2, spec_decode=True, draft_k=3,
                drafter=DraftLM(3, dparams, config, adapters=one),
                tenancy=_registry())
    two = tuple(np.concatenate([a, np.zeros_like(a)]) for a in one)
    server = _server(n_slots=2, spec_decode=True, draft_k=3,
                     drafter=DraftLM(3, dparams, config, adapters=two),
                     tenancy=_registry())
    assert server.engine.n_tenants == 0
    for rid, tenant in (("a0", "acme"), ("g0", "globex")):
        assert server.submit(Request(id=rid, prompt=(1, 5, 2),
                                     max_new_tokens=4, tenant=tenant))
    server.drain()
    assert all(len(server.poll(r).tokens) == 4 for r in ("a0", "g0"))


# -- the serve verb -------------------------------------------------------

_VERB = ["--vocab", str(VOCAB), "--embed-dim", str(E), "--num-heads",
         str(HEADS), "--mlp-dim", str(MLP), "--num-blocks", str(BLOCKS),
         "--t-max", str(SEQ), "--slots", "2", "--window", "4",
         "--requests", "9"]
_TENANT_FLAGS = ["--tenants", "acme,globex,initech", "--tenant-quota",
                 "globex=2:8:-", "--tenant-slo-ttft-ms", "2000",
                 "--rollout-adapters", "3"]


def _verb(argv, module=cli):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = module.main(["serve", *argv])
    return rc, out.getvalue().splitlines()


def _tenant_lines(lines):
    """The per-tenant lines without their TTFT (a wall-clock figure),
    and the hot-swap line."""
    out = []
    for ln in lines:
        if ln.startswith("tenant "):
            out.append(" ".join(w for w in ln.split()
                                if not w.startswith("ttft_p95=")))
        elif ln.startswith(("adapter rollout:", "served:")):
            out.append(ln)
    return out


def test_serve_verb_with_the_tenant_flags_prints_the_jax_lines():
    """`serve --tenants ... --tenant-quota ... --tenant-slo-ttft-ms ...
    --rollout-adapters R` at a tiny width: one line a tenant (the trace
    is tagged round-robin) and the hot-swap line, the JAX verb's lines
    for the same flags."""
    from idc_models_tpu import cli as jcli

    rc, lines = _verb(["--device", "cpu", *_VERB, *_TENANT_FLAGS])
    assert rc == 0
    ours = _tenant_lines(lines)
    assert "adapter rollout: hot-swapped rank-3 adapters for 3 tenant(s), " \
           "zero recompile" in ours
    for name in ("acme", "globex", "initech"):
        assert f"tenant {name}: requests=3 " in " ".join(ours)
    summary = json.loads(next(ln for ln in lines
                              if ln.startswith("serve summary: "))[15:])
    assert list(summary["serve_tenants"]) == ["acme", "globex", "initech"]
    assert ours == _tenant_lines(_verb([*_VERB, *_TENANT_FLAGS], jcli)[1])


@pytest.mark.parametrize("argv,match", [
    (["--tenant-quota", "acme=1"], "--tenant-quota needs --tenants"),
    (["--tenant-slo-ttft-ms", "5"], "--tenant-slo-ttft-ms needs --tenants"),
    (["--rollout-adapters", "4"], "--rollout-adapters needs --tenants"),
    (["--tenants", "a,,b"], "empty tenant name"),
    (["--tenants", "a,a"], "duplicate tenant name"),
    (["--tenants", "a", "--tenant-quota", "a"], "malformed"),
    (["--tenants", "a", "--tenant-quota", "b=1"], "unknown tenant 'b'"),
    (["--tenants", "a", "--tenant-quota", "a=x"], "is not an int"),
    (["--tenants", "a", "--tenant-quota", "a=0"], "bounds must be >= 1"),
    (["--tenants", "a", "--tenant-quota", "a=1", "--tenant-quota", "a=2"],
     "already has a quota"),
    (["--tenants", "a", "--tenant-slo-ttft-ms", "fast"], "is not a number"),
    (["--tenants", "a", "--tenant-slo-ttft-ms", "-3"], "must be > 0"),
    (["--tenants", "a", "--tenant-slo-ttft-ms", "z=3"], "unknown tenant 'z'"),
    (["--tenants", "a", "--tenant-slo-ttft-ms", "3",
      "--tenant-slo-ttft-ms", "a=4"], "already has a TTFT SLO"),
    (["--tenants", "a", "--rollout-adapters", "0"], "must be >= 1"),
])
def test_serve_verb_tenant_usage_errors_carry_the_jax_messages(argv, match):
    from idc_models_tpu import cli as jcli

    with pytest.raises(SystemExit) as ours:
        _verb(["--device", "cpu", *argv])
    with pytest.raises(SystemExit) as theirs:
        _verb(list(argv), jcli)
    assert str(ours.value) == str(theirs.value)
    assert match in str(ours.value)


# -- the cross-tenant discipline -----------------------------------------

# the methods of the port's tenancy.py that may read the whole tenant
# set, each with why (the JAX package's allowlist, method for method)
CROSS_TENANT_ALLOWLIST = {
    "register": "the duplicate-name check is the identity contract",
    "_check_adapter": "one [V, r] across every tenant's adapter is a "
                      "property of the set",
    "build": "the one freeze point: stacks every adapter, declares every "
             "SLO, builds every brownout",
    "names": "the documented name list (registration = tid order)",
    "n_tenants": "the set's size only",
}
_TENANT_MAPS = {"_tenants", "brownouts"}


def _scan_cross_tenant_reads(path: Path):
    """(violations, live): each iteration over a tenant map (or a
    `len`/`list`/... of one) outside the allowlisted methods, and the
    allowlisted methods that do iterate."""
    tree = ast.parse(path.read_text(), filename=str(path))
    violations, live = [], set()

    def names_tenant_map(node) -> bool:
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("values", "items", "keys")):
            node = node.func.value
        return isinstance(node, ast.Attribute) and node.attr in _TENANT_MAPS

    def walk(node, fn):
        for child in ast.iter_child_nodes(node):
            inner = (child.name if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else fn)
            sites = []
            if isinstance(child, (ast.For, ast.comprehension)):
                sites.append(child.iter)
            if (isinstance(child, ast.Call)
                    and isinstance(child.func, ast.Name)
                    and child.func.id in ("list", "sorted", "len", "dict",
                                          "set", "tuple", "any", "all",
                                          "next", "iter")):
                sites.extend(child.args)
            for site in sites:
                if names_tenant_map(site):
                    live.add(inner)
                    if inner not in CROSS_TENANT_ALLOWLIST:
                        violations.append((inner, getattr(
                            child, "lineno", getattr(site, "lineno", 0))))
            walk(child, inner)

    walk(tree, None)
    return violations, live


def test_no_cross_tenant_reads_in_the_port_tenancy(tmp_path):
    """Every accessor of the port's tenancy runtime reads ONE tenant: a
    read over the whole set outside the allowlist fails, and every
    allowlist entry still matches code."""
    path = Path(ttenancy.__file__)
    violations, live = _scan_cross_tenant_reads(path)
    assert not violations, violations
    assert set(CROSS_TENANT_ALLOWLIST) == live
    # the scan sees a planted cross-tenant read
    planted = path.read_text() + (
        "\n\ndef rollup(self):\n"
        "    return [t.quota for t in self._tenants.values()]\n")
    probe = tmp_path / "tenancy.py"
    probe.write_text(planted)
    assert [v[0] for v in _scan_cross_tenant_reads(probe)[0]] == ["rollup"]
