"""The port's zero-downtime weight rollout (idc_models_tpu_torch/
checkpoint/rollout.py, `SlotEngine.spot_check_params` and `swap_params`,
`LMServer.quiesce` and `canary_clone`, `ServingMetrics.on_rollout`, the
`serve` verb's rollout flags) on the CPU, against the JAX package's on
the same weights (seed-0 live, seed-1 candidate, both JAX-initialised
and carried across as host trees), the same requests and a fake clock
that stands still, so that TTFT and every verdict are deterministic.

The contracts are those of the JAX package's tests/test_rollout.py:
exactly one Result an id whichever way the rollout ends, a bad
candidate rolled back at staging before any request reaches it, the
promoted server equal to one built on the candidate, and the same
routing, stage trail and records as the JAX controller. Tokens are held
to JAX's under the f32 serving contract: equal up to the first step
whose serial top-2 margin is below 1e-5 of the largest |logit|."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idc_models_tpu import checkpoint as jckpt
from idc_models_tpu import serve as jserve
from idc_models_tpu.checkpoint import rollout as jrollout
from idc_models_tpu.models import lm as jlm
from idc_models_tpu.observe import metrics_registry as jreg
from idc_models_tpu.serve import metrics as jmetrics
from idc_models_tpu_torch import cli, convert
from idc_models_tpu_torch.checkpoint import (
    RolloutController, run_with_rollout, save_sharded,
)
from idc_models_tpu_torch.checkpoint.rollout import RolloutError
from idc_models_tpu_torch.models import lm as tlm
from idc_models_tpu_torch.observe import MetricsRegistry
from idc_models_tpu_torch.serve import (
    LMServer, Request, ServingMetrics, TenantRegistry,
)

VOCAB, SEQ, E, HEADS, MLP, BLOCKS = 11, 32, 32, 2, 64, 2
KW = dict(embed_dim=E, num_heads=HEADS, num_blocks=BLOCKS, t_max=SEQ)
CONTRACT = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share a few cores: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _params(seed: int):
    """The JAX LM's weights from `seed` as host arrays, the head
    sharpened so greedy picks win by more than the packages' rounding."""
    model = jlm.attention_lm(VOCAB, SEQ, embed_dim=E, num_heads=HEADS,
                             mlp_dim=MLP, num_blocks=BLOCKS)
    params = jax.tree.map(np.array, jax.device_get(
        model.init(jax.random.key(seed)).params))
    params["head"]["kernel"] = params["head"]["kernel"] * 8.0
    return params


def _still():
    return 0.0


class _Records:
    """A logger keeping its records."""

    def __init__(self):
        self.records = []

    def log(self, **rec):
        self.records.append(rec)

    def close(self):
        pass

    def rollout(self):
        return [(r["stage"], r["outcome"], r["canary_requests"])
                for r in self.records if r.get("event") == "serve_rollout"]


def _server(params=None, **kw):
    kw.setdefault("registry", MetricsRegistry())
    kw.setdefault("clock", _still)
    return LMServer(_params(0) if params is None else params, n_slots=2,
                    window=4, device="cpu", cache_dtype=torch.float32,
                    **KW, **kw)


def _jserver(params=None, **kw):
    kw.setdefault("registry", jreg.MetricsRegistry())
    kw.setdefault("clock", _still)
    return jserve.LMServer(_params(0) if params is None else params,
                           n_slots=2, window=4, mesh=None,
                           cache_dtype=jnp.float32, **KW, **kw)


def _trace(n, *, start=0, tenant=None, seed=7, cls=Request):
    rng = np.random.default_rng(seed)
    return [(0.0, cls(id=f"r{start + i}",
                      prompt=tuple(int(x) for x in
                                   rng.integers(1, VOCAB, 3 + i % 5)),
                      max_new_tokens=3 + i % 4, tenant=tenant))
            for i in range(n)]


def _one_each(results, trace):
    ids = [r.id for r in results]
    assert sorted(ids) == sorted(t[1].id for t in trace)
    assert len(set(ids)) == len(ids)


def _held(params, prompt, got, want) -> int:
    """`got` against `want` under the serving contract, along the serial
    run of `params`: equal up to the first step whose top-2 margin is
    below CONTRACT of the largest |logit|. Returns the steps held."""
    assert len(got) == len(want)
    gen = tlm.Generator(params, device="cpu", cache_dtype=torch.float32,
                        **KW)
    logits, caches = gen.prefill([list(prompt)])
    for j, (g, w) in enumerate(zip(got, want)):
        lw = logits[0]
        top2 = lw.topk(2).values
        if float(top2[0] - top2[1]) < CONTRACT * float(lw.abs().max()):
            return j
        assert g == w, (prompt, j, got, want)
        _, logits, caches = gen.decode(caches, logits, len(prompt) + j, 1)
    return len(want)


def _nan(params):
    return jax.tree.map(lambda a: np.full_like(a, np.nan), params)


def _blown(params):
    """The head scaled by 1e32: finite logits past the health bound."""
    out = jax.tree.map(np.array, params)
    out["head"]["kernel"] = out["head"]["kernel"] * np.float32(1e32)
    return out


def _rollout_run(make, trace, candidate, **kw):
    """`run_with_rollout` on a server `make` builds with a recording
    logger; the ids finished before the live weights were swapped."""
    rec = _Records()
    server = make(logger=rec)
    before = []
    swap = server.swap_params

    def recorded_swap(params):
        before.extend(r.id for r in server.results())
        swap(params)

    server.swap_params = recorded_swap
    run = (jrollout.run_with_rollout if isinstance(server, jserve.LMServer)
           else run_with_rollout)
    res, ctl = run(server, trace, candidate, **kw)
    return server, res, ctl, rec, set(before)


@functools.lru_cache(maxsize=None)
def _jax_promoted():
    """The JAX drill once a module: its results, stage, canary ids and
    serve_rollout records."""
    _, res, ctl, rec, _ = _rollout_run(
        _jserver, _trace(24, cls=jserve.Request), _params(1),
        canary_fraction=0.5, canary_requests=3)
    return ({r.id: (r.status, r.tokens) for r in res}, ctl.stage,
            {r.id for r in ctl.canary.results()}, rec.rollout())


# -- the drill: promote and rollback under traffic -----------------------


def test_rollout_promotes_like_the_jax_controller():
    """Zero drop or duplicate; the same canary ids, stage trail and
    serve_rollout records as JAX; tokens held to JAX's under the
    contract (a request that finished before the swap along its own
    weights' serial run; one straddling the swap equal to JAX's); the
    promoted server equal to one built on the candidate bit for bit."""
    tr = _trace(24)
    server, res, ctl, rec, before = _rollout_run(
        _server, tr, _params(1), canary_fraction=0.5, canary_requests=3)
    want, jstage, jcanary, jtrail = _jax_promoted()
    _one_each(res, tr)
    assert all(r.status == "ok" for r in res)
    assert ctl.stage == jstage == "promoted"
    canary = {r.id for r in ctl.canary.results()}
    assert canary == jcanary and 0 < len(canary) < 24
    assert rec.rollout() == jtrail
    assert [s for s, _, _ in jtrail] == ["staging", "canary", "promoted"]
    s = server.summary()
    assert (s["serve_rollouts"], s["serve_rollout_outcome"],
            s["serve_rollout_stage"]) == (1, "promoted", "promoted")
    prompts = {q.id: q.prompt for _, q in tr}
    held = 0
    for r in res:
        if r.id in canary or r.id in before:
            params = _params(1) if r.id in canary else _params(0)
            held += _held(params, prompts[r.id], r.tokens, want[r.id][1])
        else:
            assert r.tokens == want[r.id][1], r.id
    assert held > 0
    probe = _trace(3, start=100, seed=11)
    fresh = {r.id: r.tokens for r in _server(_params(1)).run(probe)}
    assert {r.id: r.tokens for r in server.run(probe)} == fresh


@pytest.mark.parametrize("bad,code,detail", [
    (_nan, 1, "non-finite"), (_blown, 2, "magnitude-blown")])
def test_bad_candidate_rolls_back_at_staging_like_jax(bad, code, detail):
    """A NaN candidate (code 1) and a head blown up by 1e32 (code 2):
    the spot-check's code equals JAX's and its max |logit| JAX's within
    1e-5 relative, the rollout ends rolled_back at staging with JAX's
    reason and no canary, every request is ok, and the live server
    still equals a fresh one."""
    cand = bad(_params(0))
    got = _server().engine.spot_check_params(cand)
    want = _jserver().engine.spot_check_params(cand)
    assert (got["ok"], got["code"]) == (want["ok"], want["code"]) == (
        False, code)
    np.testing.assert_allclose(got["max_abs"], want["max_abs"], rtol=1e-5)
    tr = _trace(12)
    server, res, ctl, rec, _ = _rollout_run(
        _server, tr, cand, canary_fraction=0.5, canary_requests=3)
    _, jres, jctl, jrec, _ = _rollout_run(
        _jserver, _trace(12, cls=jserve.Request), cand,
        canary_fraction=0.5, canary_requests=3)
    assert ctl.stage == jctl.stage == "rolled_back"
    assert ctl.reason == jctl.reason and detail in ctl.reason
    assert "spot-check" in ctl.reason
    assert ctl.canary is None and jctl.canary is None
    assert rec.rollout() == jrec.rollout()
    _one_each(res, tr)
    assert all(r.status == "ok" for r in res)
    assert server.summary()["serve_rollout_outcome"] == "rolled_back"
    probe = _trace(2, start=200, seed=13)
    fresh = {r.id: r.tokens for r in _server().run(probe)}
    assert {r.id: r.tokens for r in server.run(probe)} == fresh


def test_healthy_spot_check_matches_jax_and_touches_nothing():
    """A healthy candidate: code 0 in both packages, max |logit| within
    1e-5 relative of JAX's; the live engine's caches and logits stay
    bit-equal, and so do a chunked engine's."""
    for kw in ({}, {"prefill_chunk": 8}):
        server = _server(**kw)
        server.submit(Request(id="a", prompt=(1, 2, 3), max_new_tokens=6))
        server.step()
        eng = server.engine
        before = [t.clone() for pair in eng._caches for t in pair]
        logits = eng._logits.clone()
        got = eng.spot_check_params(_params(1))
        want = _jserver(**kw).engine.spot_check_params(_params(1))
        assert got["ok"] and got["code"] == want["code"] == 0
        np.testing.assert_allclose(got["max_abs"], want["max_abs"],
                                   rtol=1e-5)
        after = [t for pair in eng._caches for t in pair]
        assert all(torch.equal(a, b) for a, b in zip(before, after))
        assert torch.equal(logits, eng._logits)
        server.drain()
        assert server.poll("a").status == "ok"


def test_insufficient_evidence_and_error_burn_roll_back_like_jax():
    """A canary that cannot earn `canary_requests` finishes rolls back
    with JAX's reason; a canary request that errors (a poisoned slot on
    the canary, health checks armed, no retry) burns the zero error
    budget: rolled_back with JAX's reason, in both packages."""
    tr = _trace(6)
    _, res, ctl, _, _ = _rollout_run(_server, tr, _params(1),
                                     canary_fraction=0.01,
                                     canary_requests=50)
    _, _, jctl, _, _ = _rollout_run(_jserver, _trace(
        6, cls=jserve.Request), _params(1), canary_fraction=0.01,
        canary_requests=50)
    assert ctl.stage == jctl.stage == "rolled_back"
    assert "not enough evidence" in ctl.reason and ctl.reason == jctl.reason
    _one_each(res, tr)
    assert all(r.status == "ok" for r in res)

    reasons = []
    for make, cls, mod in ((_server, Request, None),
                           (_jserver, jserve.Request, jrollout)):
        server = make()
        ctl = (RolloutController if mod is None else
               mod.RolloutController)(server, _params(1),
                                      canary_fraction=1.0,
                                      canary_requests=2)
        assert ctl.start()
        ctl.canary.scheduler.health_checks = True
        # budgets that outlive the window in flight, so the poisoned
        # slot is still running at the next health pass
        for i in range(2):
            assert ctl.submit(cls(id=f"e{i}", prompt=(1 + i, 2, 3),
                                  max_new_tokens=12))
        ctl.step()
        ctl.canary.engine.inject_slot_fault(0, "nan_logits")
        while not ctl.idle() and ctl.stage == "canary":
            ctl.step()
        ctl.finish()
        assert ctl.stage == "rolled_back"
        reasons.append(ctl.reason)
    assert reasons[0] == reasons[1]
    assert reasons[0].startswith("canary error burn: 1/2 finishes errored")


class _Clock:
    """A clock that moves only when the test sets `t`."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("canary_ttft_s,verdict", [
    (0.1, "rolled_back"), (0.015, "promoted")])
def test_ttft_gate_judges_the_canary_on_an_injected_clock(canary_ttft_s,
                                                          verdict):
    """The TTFT gate on a clock the test moves: the live server's two
    requests reach their first token 10 ms after submit, the canary's
    two `canary_ttft_s` after. 100 ms is past `ttft_slack` (2.0) x 10 ms
    and rolls back with the canary-SLO reason; 15 ms is within it and
    promotes. Both packages' controllers give the same verdict and
    reason."""
    got = []
    for make, cls, mod in ((_server, Request, None),
                           (_jserver, jserve.Request, jrollout)):
        clock = _Clock()
        server = make(clock=clock)
        for _, r in _trace(2, cls=cls):
            assert server.submit(r)
        clock.t = 0.01
        server.drain()
        ctl = (RolloutController if mod is None else
               mod.RolloutController)(server, _params(1),
                                      canary_fraction=1.0,
                                      canary_requests=2)
        assert ctl.start()
        clock.t = 1.0
        for _, r in _trace(2, start=2, cls=cls):
            assert ctl.submit(r)
        clock.t = 1.0 + canary_ttft_s
        while ctl.stage == "canary":
            ctl.step()
        got.append((ctl.stage, ctl.reason))
    assert got[0] == got[1]
    assert got[0][0] == verdict
    if verdict == "rolled_back":
        assert got[0][1] == ("canary SLO burn: TTFT p95 "
                             f"{canary_ttft_s * 1e3:.1f} ms > 2.0x live "
                             f"10.0 ms")


def test_rollout_from_a_sharded_checkpoint_path(tmp_path):
    """The candidate arrives as a directory the port's `save_sharded`
    wrote; the controller restores it whole and promotes, and the
    promoted server equals one built on the candidate."""
    save_sharded(tmp_path / "cand", _params(1)).wait()
    server = _server()
    tr = _trace(20)
    res, ctl = run_with_rollout(server, tr, str(tmp_path / "cand"),
                                canary_fraction=0.5, canary_requests=2)
    assert ctl.stage == "promoted"
    _one_each(res, tr)
    probe = _trace(2, start=300, seed=17)
    want = {r.id: r.tokens for r in _server(_params(1)).run(probe)}
    assert {r.id: r.tokens for r in server.run(probe)} == want


def test_routing_equals_jax_over_ids_and_tenants():
    """Over 1,000 ids, untagged and under each of five tenants, the port
    routes every request to the side JAX's controller does; a tenant's
    requests all land on one side, and the split splits."""
    names = ("acme", "globex", "initech", "umbrella", "hooli")
    sides = []
    for make, cls, mod in ((_server, Request, None),
                           (_jserver, jserve.Request, jrollout)):
        ctl = (RolloutController if mod is None else
               mod.RolloutController)(make(), _params(1),
                                      canary_fraction=0.5)
        assert ctl.start()
        sides.append([ctl.routes_to_canary(cls(
            id=f"q{i}", prompt=(1, 2), max_new_tokens=2, tenant=t))
            for t in (None, *names) for i in range(1000)])
    assert sides[0] == sides[1]
    per = np.array(sides[0]).reshape(6, 1000)
    assert 400 < per[0].sum() < 600
    assert all(row.all() or not row.any() for row in per[1:])
    assert 0 < sum(bool(row[0]) for row in per[1:]) < 5


def test_tenant_affine_routing_on_a_tenanted_server():
    """A multi-tenant server: the canary shares the tenancy, and each
    tenant's requests land on one side."""
    reg = TenantRegistry()
    for name in ("acme", "globex", "initech", "umbrella"):
        reg.register(name)
    server = _server(tenancy=reg)
    ctl = RolloutController(server, _params(1), canary_fraction=0.5)
    assert ctl.start()
    assert ctl.canary.tenancy is server.tenancy
    sides = {}
    for name in ("acme", "globex", "initech", "umbrella"):
        routed = {ctl.routes_to_canary(Request(
            id=f"q{name}{i}", prompt=(1, 2), max_new_tokens=2,
            tenant=name)) for i in range(8)}
        assert len(routed) == 1
        sides[name] = routed.pop()
    assert len(set(sides.values())) == 2
    ctl._rollback("test over")


# -- the primitives ------------------------------------------------------


def test_swap_params_refuses_another_architecture():
    server = _server()
    with pytest.raises(ValueError, match="not architectures"):
        server.swap_params({"wrong": np.zeros((2, 2), np.float32)})
    grown = jax.tree.map(lambda a: np.zeros(tuple(d + 1 for d in a.shape),
                                            a.dtype), _params(0))
    with pytest.raises(ValueError, match="not architectures"):
        server.swap_params(grown)
    with pytest.raises(ValueError, match="not architectures"):
        server.engine.spot_check_params(grown)


def test_swap_params_leaves_the_window_in_flight_on_the_old_weights():
    """A swap while a window is in flight: that window's tokens are the
    old weights' and the next window's those of an engine swapped with
    nothing in flight."""
    prompt = (3, 1, 4, 1, 5)
    a, b = _server().engine, _server().engine
    for eng in (a, b):
        eng.admit(0, prompt, 10)
    a.begin_window(4)
    a.swap_params(_params(1))
    first = a.collect()[0]
    assert first == b.step_window(4)[0]
    b.swap_params(_params(1))
    assert a.step_window(4)[0] == b.step_window(4)[0]


def test_controller_is_single_use_and_checks_its_knobs():
    server = _server()
    ctl = RolloutController(server, _params(1), canary_requests=1)
    assert ctl.start()
    with pytest.raises(RolloutError, match="ONE rollout"):
        ctl.start()
    ctl._rollback("test over")
    with pytest.raises(RolloutError, match="ONE rollout"):
        ctl.start()
    with pytest.raises(ValueError, match="canary_fraction"):
        RolloutController(server, _params(1), canary_fraction=1.5)
    with pytest.raises(ValueError, match="canary_requests"):
        RolloutController(server, _params(1), canary_requests=0)
    with pytest.raises(ValueError, match="start_after"):
        run_with_rollout(server, _trace(2), _params(1), start_after=1.0)


def test_canary_clone_shares_nothing_but_the_tenancy(tmp_path):
    """The canary: every setting of the live server, a fresh registry,
    no prefix cache, journal, fault plan or brownout."""
    server = _server(prefill_chunk=8, prefix_cache_mb=1,
                     journal=tmp_path / "wal.jsonl")
    canary = server.canary_clone(_params(1))
    assert canary.engine.prefill_chunk == 8
    assert canary.engine.prefix_cache is None
    assert canary.journal is None and canary.brownout is None
    assert canary.metrics is not server.metrics
    assert canary.scheduler.clock is server.scheduler.clock


@pytest.mark.parametrize("paged", [False, True])
def test_quiesce_collects_without_dispatch(paged):
    """After quiesce() the engine has nothing in flight (the paged
    spot-check's precondition) and every request still finishes."""
    kw = (dict(prefill_chunk=8, kv_page_size=4, kv_pages=24) if paged
          else {})
    server = _server(**kw)
    for _, r in _trace(3, seed=43):
        server.submit(r)
    server.step()
    assert server.engine._pending is not None
    server.quiesce()
    assert server.engine._pending is None
    server.drain()
    assert server.scheduler.idle()
    assert len(server.results()) == 3
    assert all(r.status == "ok" for r in server.results())


def test_paged_spot_check_leaves_the_pool_and_table_bit_equal():
    """On a paged engine mid-burst: refused while a window is in flight,
    then after quiesce() every grantable page of every pool, the page
    table and the allocator's free count are unchanged by a spot-check
    (its writes land in the sink page only)."""
    server = _server(prefill_chunk=8, kv_page_size=4, kv_pages=24)
    for _, r in _trace(4, seed=5):
        server.submit(r)
    for _ in range(2):
        server.step()
    eng = server.engine
    with pytest.raises(RuntimeError, match="quiesce"):
        eng.spot_check_params(_params(1))
    server.quiesce()
    assert eng._slot_pages, "no slot holds pages mid-burst"
    pools = [t[:-1].clone() for pair in eng._caches for t in pair]
    table, free = eng._pt.clone(), eng._alloc.free_count()
    assert eng.spot_check_params(_params(1))["ok"]
    assert all(torch.equal(a, t[:-1]) for a, t in zip(
        pools, (t for pair in eng._caches for t in pair)))
    assert torch.equal(table, eng._pt)
    assert eng._alloc.free_count() == free
    server.drain()
    assert all(r.status == "ok" for r in server.results())


def test_rollout_metrics_match_the_jax_hooks():
    """on_rollout against JAX's: the summary's three keys, the two
    families' text in each registry, and the refusal of an unknown
    stage."""
    reg, jreg_ = MetricsRegistry(), jreg.MetricsRegistry()
    ours = ServingMetrics(registry=reg)
    theirs = jmetrics.ServingMetrics(registry=jreg_)
    assert ours.summary()["serve_rollout_stage"] is None
    for m in (ours, theirs):
        m.on_rollout(stage="staging")
        m.on_rollout(stage="canary", canary_requests=0)
        m.on_rollout(stage="promoted", outcome="promoted",
                     canary_requests=3)
    keys = ("serve_rollouts", "serve_rollout_outcome", "serve_rollout_stage")
    assert ({k: ours.summary()[k] for k in keys}
            == {k: theirs.summary()[k] for k in keys}
            == {"serve_rollouts": 1, "serve_rollout_outcome": "promoted",
                "serve_rollout_stage": "promoted"})

    def families(r):
        return [ln for ln in r.prometheus_text().splitlines()
                if "serve_rollout" in ln]

    assert families(reg) == families(jreg_)
    assert "serve_rollout_stage_code 3" in families(reg)
    with pytest.raises(ValueError, match="unknown rollout stage"):
        ours.on_rollout(stage="bogus")


# -- the verb -------------------------------------------------------------

_VERB = ["--slots", "2", "--window", "4", "--t-max", "32", "--vocab", "11",
         "--embed-dim", "16", "--num-heads", "2", "--mlp-dim", "32",
         "--num-blocks", "1"]


def test_serve_rollout_verb_prints_the_jax_verdict(tmp_path, capsys,
                                                  monkeypatch):
    """`serve --save-ckpt` mints a candidate; `serve --rollout` over it
    with --canary-fraction 0.5 --canary-requests 3 --rollout-at 0.0
    serves every request and prints the JAX verb's stage line, on both
    packages' verbs over the same checkpoint. The verbs time TTFT on the
    wall clock, where a loaded host can make either canary's p95 pass
    twice the live one's; so both controllers' TTFT slack is lifted here,
    and the gate itself is held on an injected clock
    (`test_ttft_gate_judges_the_canary_on_an_injected_clock`)."""
    from idc_models_tpu import cli as jcli
    from idc_models_tpu_torch.checkpoint import rollout as trollout

    for mod in (trollout, jrollout):
        monkeypatch.setattr(
            mod.RolloutController, "__init__", functools.partialmethod(
                mod.RolloutController.__init__, ttft_slack=float("inf")))
    ckpt = tmp_path / "candidate"
    assert cli.main(["serve", "--device", "cpu", "--requests", "4",
                     "--seed", "1", "--save-ckpt", str(ckpt),
                     *_VERB]) == 0
    assert "checkpoint: wrote" in capsys.readouterr().out
    argv = ["--requests", "24", "--rollout", str(ckpt),
            "--canary-fraction", "0.5", "--canary-requests", "3",
            "--rollout-at", "0.0", *_VERB]
    lines = {}
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, [])):
        assert main(["serve", *extra, *argv]) == 0
        out = capsys.readouterr().out
        assert "served: ok=24 timeout=0 rejected=0" in out, name
        lines[name] = [ln.split(" after ")[0] for ln in out.splitlines()
                       if ln.startswith("rollout: ")]
    assert lines["port"] == lines["jax"] == ["rollout: promoted"]


@pytest.mark.parametrize("argv,match", [
    (["--canary-fraction", "0.5"], "--canary-fraction needs --rollout"),
    (["--canary-requests", "3"], "--canary-requests needs --rollout"),
    (["--rollout-at", "0.5"], "--rollout-at needs --rollout"),
    (["--rollout", "CK", "--canary-fraction", "-0.5"],
     "promoting without evidence"),
    (["--rollout", "CK", "--canary-fraction", "1.5"],
     "promoting without evidence"),
    (["--rollout", "CK", "--canary-fraction", "0"],
     "promoting without evidence"),
    (["--rollout", "CK", "--canary-requests", "0"],
     "at least one canary finish"),
    (["--rollout", "CK", "--rollout-at", "1.0"], "drains before the rollout"),
    (["--rollout", "CK", "--rollout-at", "-0.1"],
     "drains before the rollout"),
    (["--rollout", "MISSING"], "MANIFEST.json"),
], ids=lambda v: v if isinstance(v, str) else None)
def test_serve_rollout_usage_errors(tmp_path, argv, match):
    """Every bad rollout knob exits with the JAX verb's message before
    anything is built; a fake but complete checkpoint lets the knob
    checks run."""
    ck = tmp_path / "ck"
    save_sharded(ck, {"w": np.zeros(3, np.float32)}).wait()
    argv = [str(ck) if a == "CK" else
            str(tmp_path / "nothing_here") if a == "MISSING" else a
            for a in argv]
    with pytest.raises(SystemExit, match=match):
        cli.main(["serve", "--device", "cpu", *argv])


def test_jax_checkpoint_candidate_is_restored_whole(tmp_path):
    """A candidate directory the JAX package's `save_sharded` wrote
    restores into the port's controller leaf for leaf."""
    jckpt.save_sharded(tmp_path / "j", _params(1)).wait()
    ctl = RolloutController(_server(), str(tmp_path / "j"))
    flat = convert.flatten(ctl.candidate)
    for k, v in convert.flatten(_params(1)).items():
        np.testing.assert_array_equal(np.asarray(flat[k]), v)
