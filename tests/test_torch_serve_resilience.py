"""The port's serving resilience (idc_models_tpu_torch/serve/faults.py,
journal.py, brownout.py; the scheduler's fault, journal and brownout
wiring; `LMServer.resubmit_pending`; the `serve` verb's drill flags) on
the CPU, against the JAX package on the same weights (carried across by
`convert.load_jax`, the head sharpened as in tests/test_torch_serve.py),
the same requests and the same fault plans.

The contracts are those of the JAX package's tests/test_serve_resilience.py:
a recovered request (a quarantined slot's retry, a crash's journal
re-admission) gives the tokens of a run where nothing went wrong; a
fault plan is a pure function of (plan, tick), so a faulted run replays
bit for bit; the journal's records are the JAX package's, key for key;
the brownout moves through its stages as the JAX controller does, and
every refusal is an explicit ``shed`` Result."""

from __future__ import annotations

import contextlib
import functools
import io
import json
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idc_models_tpu import serve as jserve
from idc_models_tpu.models import lm as jlm
from idc_models_tpu.observe import metrics_registry as jreg
from idc_models_tpu.serve import journal as jjournal
from idc_models_tpu_torch import cli
from idc_models_tpu_torch import serve as tserve
from idc_models_tpu_torch.models import lm as tlm
from idc_models_tpu_torch.observe import MetricsRegistry
from idc_models_tpu_torch.serve import (
    BrownoutController, InjectedEngineCrash, LMServer, PagedPrefixCache,
    PrefixCache, Request, RequestJournal, RetryPolicy, ServeFault,
    ServeFaultPlan, SlotEngine, load_journal, parse_serve_fault_spec,
    pending_requests,
)

VOCAB, E, HEADS, MLP, BLOCKS, T_MAX = 16, 32, 2, 64, 2, 64
KW = dict(embed_dim=E, num_heads=HEADS, num_blocks=BLOCKS, t_max=T_MAX)
RETRY = dict(max_retries=2, backoff_s=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share a few cores: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _params():
    """The JAX LM's weights (seed 0), its head sharpened so greedy picks
    win by more than the two packages' rounding."""
    model = jlm.attention_lm(VOCAB, T_MAX, embed_dim=E, num_heads=HEADS,
                             mlp_dim=MLP, num_blocks=BLOCKS)
    params = jax.tree.map(np.array, jax.device_get(
        model.init(jax.random.key(0)).params))
    params["head"]["kernel"] = params["head"]["kernel"] * 8.0
    return params


def _server(**kw):
    return LMServer(_params(), registry=MetricsRegistry(), device="cpu",
                    cache_dtype=torch.float32, **KW, **kw)


def _jserver(**kw):
    return jserve.LMServer(_params(), mesh=None, cache_dtype=jnp.float32,
                           registry=jreg.MetricsRegistry(), **KW, **kw)


def _reqs(n, seed, lo=3, hi=12, budget=8, cls=Request):
    rng = np.random.default_rng(seed)
    return [cls(id=f"r{i}", prompt=tuple(
        int(x) for x in rng.integers(0, VOCAB, int(p))),
        max_new_tokens=budget) for i, p in enumerate(
            rng.integers(lo, hi, n))]


def _both(n, seed, **kw):
    return (_reqs(n, seed, **kw), _reqs(n, seed, cls=jserve.Request, **kw))


def _serial(prompt, n):
    gen = tlm.Generator(_params(), device="cpu", cache_dtype=torch.float32,
                        **KW)
    logits, caches = gen.prefill([list(prompt)])
    toks, _, _ = gen.decode(caches, logits, len(prompt), n)
    return toks[0].tolist()


def _outcome(server, reqs):
    return {r.id: (server.poll(r.id).status, server.poll(r.id).tokens,
                   server.poll(r.id).attempts) for r in reqs}


class _FakeClock:
    def __init__(self, step=0.0):
        self.t, self.step = 0.0, step

    def __call__(self):
        t = self.t
        self.t += self.step
        return t


# ---------------------------------------------------------------------------
# fault plans and their grammar
# ---------------------------------------------------------------------------


def test_fault_plan_validation_and_bursts_equal_jax():
    for mod in (tserve, jserve):
        with pytest.raises(ValueError, match="unknown serve fault kind"):
            mod.ServeFault("meteor", 1)
        with pytest.raises(ValueError, match="tick"):
            mod.ServeFault("crash", -1)
        with pytest.raises(ValueError, match="seconds"):
            mod.ServeFault("stall", 1, seconds=0.0)
        with pytest.raises(TypeError, match="ServeFault"):
            mod.ServeFaultPlan(["crash:1"])
    plan = ServeFaultPlan([ServeFault("crash", 4),
                           ServeFault("burst", 2, n=3, prompt_len=5)],
                          seed=7)
    jplan = jserve.ServeFaultPlan(
        [jserve.ServeFault("crash", 4),
         jserve.ServeFault("burst", 2, n=3, prompt_len=5)], seed=7)
    assert [f.kind for f in plan.at(4)] == ["crash"] and plan.at(2) == []
    assert plan.max_tick == jplan.max_tick == 4
    assert repr(plan) == repr(jplan)
    ours = plan.burst_requests(plan.bursts_at(2)[0], vocab=VOCAB,
                               t_max=T_MAX)
    theirs = jplan.burst_requests(jplan.bursts_at(2)[0], vocab=VOCAB,
                                  t_max=T_MAX)
    assert [(r.id, r.prompt, r.max_new_tokens) for r in ours] == [
        (r.id, r.prompt, r.max_new_tokens) for r in theirs]
    assert all(r.id.startswith("!burst-2-") for r in ours)
    other = ServeFaultPlan([ServeFault("burst", 2, n=3)], seed=8)
    assert [r.prompt for r in other.burst_requests(
        other.faults[0], vocab=VOCAB, t_max=T_MAX)] != [
        r.prompt for r in ours]


@pytest.mark.parametrize("spec", [
    "nan_logits:3:1,stall:5-7:0.02,burst:2:16,crash:40",
    "crash:1+5", "garbage_logits:0-2:3", "prefill_error:4, stall:1",
    ",crash:2,",
])
def test_parse_serve_fault_spec_gives_the_jax_plans(spec):
    ours = parse_serve_fault_spec(spec, seed=3)
    theirs = jserve.parse_serve_fault_spec(spec, seed=3)
    assert repr(ours) == repr(theirs)


@pytest.mark.parametrize("bad", [
    "meteor:3", "nan_logits", "crash:2:7", "stall:2:fast",
    "nan_logits:one:0", "stall:2:0", "burst:2:0", "nan_logits:3:-2",
])
def test_parse_serve_fault_spec_errors_carry_the_jax_text(bad):
    with pytest.raises(ValueError) as ours:
        parse_serve_fault_spec(bad)
    with pytest.raises(ValueError) as theirs:
        jserve.parse_serve_fault_spec(bad)
    assert str(ours.value) == str(theirs.value)
    assert "kind:ticks[:param]" in str(ours.value)


# ---------------------------------------------------------------------------
# quarantine and retry
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_quarantine():
    """The JAX server's faulted run: two requests on two slots, slot 0
    poisoned at cycle 1, retries armed, a journal writing every progress
    record. (outcome by id, summary, journal records)."""
    path = Path(tempfile.mkdtemp()) / "wal.jsonl"
    _, reqs = _both(2, 23, budget=8)
    server = _jserver(
        n_slots=2, window=4,
        fault_plan=jserve.ServeFaultPlan(
            [jserve.ServeFault("nan_logits", 1, slot=0)]),
        retry=jserve.RetryPolicy(**RETRY),
        journal=jjournal.RequestJournal(path, progress_every=1))
    server.run([(0.0, r) for r in reqs])
    server.close()
    return (_outcome(server, reqs), server.summary(),
            [json.loads(line) for line in path.read_text().splitlines()])


def _quarantined(tmp_path):
    reqs, _ = _both(2, 23, budget=8)
    path = tmp_path / "wal.jsonl"
    server = _server(
        n_slots=2, window=4,
        fault_plan=ServeFaultPlan([ServeFault("nan_logits", 1, slot=0)]),
        retry=RetryPolicy(**RETRY),
        journal=RequestJournal(path, progress_every=1))
    server.run([(0.0, r) for r in reqs])
    server.close()
    return server, reqs, path


def test_quarantine_and_retry_equal_jax_and_the_unfaulted_run(tmp_path):
    """The poisoned request is retried once and ends with the tokens of
    the JAX server's faulted run and of the port's unfaulted run; the
    bystander never notices."""
    server, reqs, _ = _quarantined(tmp_path)
    want, jsummary, _ = _jax_quarantine()
    assert _outcome(server, reqs) == want
    clean = _server(n_slots=2, window=4)
    clean.run([(0.0, r) for r in reqs])
    for r in reqs:
        assert server.poll(r.id).tokens == clean.poll(r.id).tokens
    assert server.poll("r0").retried and not server.poll("r1").retried
    s = server.summary()
    for key in ("serve_slot_faults", "serve_retries",
                "serve_faults_injected", "serve_tokens"):
        assert s[key] == jsummary[key], key
    assert (s["serve_slot_faults"], s["serve_retries"]) == (1, 1)


def test_quarantine_without_retry_finishes_an_honest_error():
    """A plan with no retry policy still arms the health checks: the
    poisoned request ends error/slot_fault, the server serves on."""
    server = _server(n_slots=1, window=4, fault_plan=ServeFaultPlan(
        [ServeFault("garbage_logits", 1, slot=0)]))
    assert server.scheduler.health_checks
    server.run([(0.0, Request(id="a", prompt=(1, 2, 3),
                              max_new_tokens=8))])
    a = server.poll("a")
    assert (a.status, a.finish_reason, a.attempts) == (
        "error", "slot_fault", 1)
    assert "logit_magnitude" in a.error
    server.submit(Request(id="b", prompt=(4, 5), max_new_tokens=5))
    server.drain()
    assert server.poll("b").tokens == _serial((4, 5), 5)


def test_retry_exhaustion_counts_every_attempt():
    server = _server(n_slots=1, window=4, fault_plan=ServeFaultPlan(
        [ServeFault("nan_logits", t, slot=0) for t in range(1, 40)]),
        retry=RetryPolicy(**RETRY))
    server.run([(0.0, Request(id="doomed", prompt=(1, 2, 3),
                              max_new_tokens=6))])
    r = server.poll("doomed")
    assert (r.status, r.finish_reason, r.attempts) == (
        "error", "slot_fault", 3)
    assert "attempt 3" in r.error and r.retried
    assert server.summary()["serve_slot_faults"] == 3


def test_retry_past_the_original_deadline_times_out():
    now = [0.0]
    server = _server(n_slots=1, window=4, clock=lambda: now[0],
                     fault_plan=ServeFaultPlan(
                         [ServeFault("nan_logits", 1, slot=0)]),
                     retry=RetryPolicy(max_retries=3, backoff_s=10.0))
    server.submit(Request(id="late", prompt=(1, 2), max_new_tokens=8,
                          deadline_s=1.0))
    server.step()
    server.step()
    r = server.poll("late")
    assert (r.status, r.finish_reason, r.retried) == (
        "timeout", "deadline", False)


def test_prefill_error_fails_only_the_chunking_request():
    """An injected chunk failure on a chunked server quarantines the
    chunking request, which reruns to its serial tokens; the other
    request is untouched."""
    server = _server(n_slots=2, window=4, prefill_chunk=4,
                     fault_plan=ServeFaultPlan(
                         [ServeFault("prefill_error", 0)]),
                     retry=RetryPolicy(max_retries=1, backoff_s=0.0))
    prompt = tuple(range(1, 11))
    server.run([(0.0, Request(id="p", prompt=prompt, max_new_tokens=5)),
                (0.0, Request(id="q", prompt=(3, 4), max_new_tokens=5))])
    p, q = server.poll("p"), server.poll("q")
    assert (p.status, p.attempts, q.attempts) == ("ok", 2, 1)
    assert p.tokens == _serial(prompt, 5)
    assert q.tokens == _serial((3, 4), 5)
    assert server.summary()["serve_slot_faults"] == 1


def test_faulted_run_replays_bit_for_bit():
    def one_run():
        server = _server(n_slots=2, window=4, prefill_chunk=4,
                         fault_plan=parse_serve_fault_spec(
                             "nan_logits:1:0,stall:2:0.001,prefill_error:0"),
                         retry=RetryPolicy(**RETRY))
        reqs = _reqs(3, 31, lo=5, hi=14, budget=6)
        server.run([(0.0, r) for r in reqs])
        s = server.summary()
        return (_outcome(server, reqs),
                {k: s[k] for k in ("serve_slot_faults", "serve_retries",
                                   "serve_faults_injected",
                                   "serve_tokens")})
    assert one_run() == one_run()


# ---------------------------------------------------------------------------
# the journal and crash recovery
# ---------------------------------------------------------------------------


def test_journal_records_equal_the_jax_journal(tmp_path):
    """The faulted run's journal against the JAX server's: the same
    records in the same order, key for key, every value equal but the
    timestamp and the process-bound trace id."""
    _, _, path = _quarantined(tmp_path)
    ours = [json.loads(line) for line in path.read_text().splitlines()]
    theirs = _jax_quarantine()[2]
    assert [r["event"] for r in ours] == [r["event"] for r in theirs]
    assert {"journal_submit", "journal_progress",
            "journal_finish"} <= {r["event"] for r in ours}
    for a, b in zip(ours, theirs):
        assert list(a) == list(b)
        assert {k: v for k, v in a.items() if k not in ("ts", "trace_id")} \
            == {k: v for k, v in b.items() if k not in ("ts", "trace_id")}


def _cross_journal(path, journal_cls):
    """One journal with every case, through `journal_cls`'s own writer:
    a finished request, an engine-death finish (pending again), a
    slot_fault error (final), a numpy-integer seed, a shed, and a
    migration record."""
    class _E:
        def __init__(self, rid, seed=None, eos=None):
            self.rid, self.prompt, self.budget = rid, np.array([1, 2, 3]), 7
            self.eos_id, self.rng, self.trace_id = eos, seed, f"t-{rid}"

    with journal_cls(path) as j:
        j.record_submit(_E("a", seed=9, eos=4), deadline_s=2.5)
        j.record_finish("a", "ok", reason="eos")
        j.record_submit(_E("b"), deadline_s=None)
        j.record_finish("b", "error", reason="error")
        j.record_submit(_E("c"), deadline_s=1.0)
        j.record_finish("c", "error", reason="slot_fault")
        j.record_submit(_E("d", seed=np.int64(5)), deadline_s=None)
        j.record_submit(_E("e"), deadline_s=None)
        j.record_finish("e", "shed", reason="shed")
        j.record_migrate("d", "out", peer="p1")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_either_package_reads_the_others_journal(tmp_path, writer):
    """The same records written by either package's journal: the files
    equal but for the timestamps, and both `load_journal`s read either
    file to the same pending requests and finishes."""
    files = {}
    for name, cls in (("port", RequestJournal),
                      ("jax", jjournal.RequestJournal)):
        files[name] = tmp_path / f"{name}.jsonl"
        _cross_journal(files[name], cls)
    assert [{k: v for k, v in json.loads(line).items() if k != "ts"}
            for line in files["port"].read_text().splitlines()] == [
        {k: v for k, v in json.loads(line).items() if k != "ts"}
        for line in files["jax"].read_text().splitlines()]
    path = files[writer]
    ours, theirs = load_journal(path), jjournal.load_journal(path)
    assert ours["finished"] == theirs["finished"] == {
        "a": "ok", "c": "error", "e": "shed"}
    assert ours["pending"] == [
        Request(**vars(r)) for r in theirs["pending"]]
    assert [(r.id, r.seed, r.deadline_s, r.trace_id)
            for r in ours["pending"]] == [("b", None, None, "t-b"),
                                          ("d", 5, None, "t-d")]


def test_journal_load_semantics_and_torn_lines(tmp_path):
    p = tmp_path / "wal.jsonl"

    class _E:
        rid, prompt, budget = "x", np.array([1, 2, 3]), 7
        eos_id, rng, trace_id = 4, 9, "t-1"

    with RequestJournal(p, progress_every=1) as j:
        j.record_submit(_E(), deadline_s=2.5)
        j.record_progress({"x": 3})
        j.record_progress({})
        j.record_finish("x", "ok", reason="eos")
    loaded = load_journal(p)
    assert (loaded["pending"], loaded["finished"], loaded["progress"]) == (
        [], {"x": "ok"}, {"x": 3})
    with RequestJournal(p) as j:
        j.record_submit(_E(), deadline_s=None)
        j.record_finish("x", "error", reason="error")
    assert [(r.id, r.prompt, r.max_new_tokens, r.eos_id, r.seed)
            for r in pending_requests(p)] == [("x", (1, 2, 3), 7, 4, 9)]
    bad = tmp_path / "torn.jsonl"
    bad.write_text('{"event": "journal_submit", "id": "a"}\n{oops\n')
    for load in (load_journal, jjournal.load_journal):
        with pytest.raises(ValueError, match="line 2"):
            load(bad)
    with pytest.raises(ValueError, match="progress_every"):
        RequestJournal(tmp_path / "x.jsonl", progress_every=0)
    with pytest.raises(ValueError, match="'out' or 'in'"):
        RequestJournal(tmp_path / "y.jsonl").record_migrate(
            "x", "sideways", peer="p")


def test_journal_progress_batches_and_strides(tmp_path):
    ours, theirs = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    for cls, p in ((RequestJournal, ours), (jjournal.RequestJournal, theirs)):
        with cls(p, progress_every=3) as j:
            for k in range(7):
                j.record_progress({"a": k + 1, "b": 2 * (k + 1)})
    recs = [json.loads(line) for line in ours.read_text().splitlines()]
    assert [r["event"] for r in recs] == ["journal_progress"] * 2
    assert recs[-1]["tokens"] == {"a": 6, "b": 12}
    assert [{k: v for k, v in r.items() if k != "ts"} for r in recs] == [
        {k: v for k, v in json.loads(line).items() if k != "ts"}
        for line in theirs.read_text().splitlines()]


@functools.lru_cache(maxsize=None)
def _jax_crash():
    """The JAX drill: a crash at cycle 4 over four requests with a
    journal, then a new server re-admitting the pending ones: (pending
    ids, tokens by id)."""
    wal = Path(tempfile.mkdtemp()) / "wal.jsonl"
    _, reqs = _both(4, 41, lo=3, hi=7, budget=16)
    a = _jserver(n_slots=2, window=4, journal=wal,
                 fault_plan=jserve.ServeFaultPlan(
                     [jserve.ServeFault("crash", 4)]))
    with pytest.raises(jserve.InjectedEngineCrash):
        a.run([(0.0, r) for r in reqs])
    a.close()
    pending = [r.id for r in jjournal.pending_requests(wal)]
    b = _jserver(n_slots=2, window=4, journal=wal)
    b.resubmit_pending(wal)
    b.drain()
    b.close()
    return pending, {r.id: (b.poll(r.id) or a.poll(r.id)).tokens
                     for r in reqs}


def test_crash_and_journal_recovery_equal_the_uncrashed_run(tmp_path):
    """A crash at cycle 4 fails the in-flight requests; a new server on
    the same journal re-admits exactly the JAX drill's pending ids, and
    every request ends with the uncrashed run's tokens (and the JAX
    drill's); a second recovery finds nothing."""
    wal = tmp_path / "wal.jsonl"
    reqs, _ = _both(4, 41, lo=3, hi=7, budget=16)
    a = _server(n_slots=2, window=4, journal=wal,
                fault_plan=ServeFaultPlan([ServeFault("crash", 4)]))
    with pytest.raises(InjectedEngineCrash, match="cycle 4"):
        a.run([(0.0, r) for r in reqs])
    a.close()
    crashed = [r for r in a.results() if r.status == "error"]
    assert crashed and all("injected engine crash" in r.error
                           for r in crashed)
    pending = [r.id for r in pending_requests(wal)]
    want_pending, want_tokens = _jax_crash()
    assert pending == want_pending
    b = _server(n_slots=2, window=4, journal=wal)
    assert b.resubmit_pending(wal) == pending
    b.drain()
    b.close()
    clean = _server(n_slots=2, window=4)
    clean.run([(0.0, r) for r in reqs])
    for r in reqs:
        got = b.poll(r.id) if r.id in pending else a.poll(r.id)
        assert got.status == "ok"
        assert got.tokens == clean.poll(r.id).tokens == want_tokens[r.id]
    assert pending_requests(wal) == []
    submits = [json.loads(line)["id"] for line in wal.read_text().splitlines()
               if json.loads(line)["event"] == "journal_submit"]
    assert sorted(submits) == sorted([r.id for r in reqs] + pending)


def test_resubmit_pending_skips_what_the_new_server_cannot_serve(tmp_path):
    wal = tmp_path / "wal.jsonl"
    with RequestJournal(wal) as j:
        class _E:
            rid, prompt, budget = "long", np.arange(60) % VOCAB, 30
            eos_id, rng, trace_id = None, None, "t"
        j.record_submit(_E(), deadline_s=None)
    server = _server(n_slots=1, window=4)
    with pytest.warns(UserWarning, match="skipped request 'long'"):
        assert server.resubmit_pending(wal) == []


def test_warm_restart_around_the_prefix_cache(tmp_path):
    """A server rebuilt after a crash around the dead engine's prefix
    cache: the recovered requests hit it, and their tokens equal the
    uncrashed run's."""
    wal = tmp_path / "wal.jsonl"
    system = tuple(int(x) for x in
                   np.random.default_rng(43).integers(0, VOCAB, 8))
    reqs = [Request(id=f"w{i}", prompt=system + (i,), max_new_tokens=4)
            for i in range(3)]
    a = _server(n_slots=1, window=4, prefill_chunk=8, prefix_cache_mb=16.0,
                journal=wal,
                fault_plan=ServeFaultPlan([ServeFault("crash", 3)]))
    with pytest.raises(InjectedEngineCrash):
        a.run([(0.0, r) for r in reqs])
    a.close()
    cache = a.engine.prefix_cache
    assert cache.nbytes > 0
    hits = cache.hits
    with pytest.raises(ValueError, match="prefix_cache OR"):
        _server(prefill_chunk=8, prefix_cache=cache, prefix_cache_mb=1.0)
    b = _server(n_slots=1, window=4, prefill_chunk=8, prefix_cache=cache,
                journal=wal)
    b.resubmit_pending(wal)
    b.drain()
    b.close()
    assert cache.hits > hits
    clean = _server(n_slots=1, window=4, prefill_chunk=8)
    clean.run([(0.0, r) for r in reqs])
    for r in reqs:
        got = b.poll(r.id) or a.poll(r.id)
        assert got.status == "ok" and got.tokens == clean.poll(r.id).tokens


# ---------------------------------------------------------------------------
# the brownout controller
# ---------------------------------------------------------------------------

# (advance the clock to, queue depth, page pressure) at each evaluation
_SIGNALS = [(0.0, 10, False), (0.5, 10, False), (1.0, 10, False),
            (2.0, 10, False), (3.0, 10, False), (4.0, 5, False),
            (20.0, 5, False), (21.0, 1, False), (26.0, 1, False),
            (27.0, 1, False), (31.0, 1, False), (32.0, 9, False),
            (33.0, 0, True), (34.5, 0, True), (40.0, 0, False),
            (46.0, 0, False), (52.0, 0, False), (58.0, 0, False)]


def test_brownout_stages_and_transitions_equal_jax():
    clocks = [_FakeClock(), _FakeClock()]
    ours = BrownoutController(queue_high=8, queue_low=2, clamp_tokens=4,
                              escalate_dwell_s=1.0, clear_after_s=5.0,
                              clock=clocks[0], registry=MetricsRegistry())
    theirs = jserve.BrownoutController(
        queue_high=8, queue_low=2, clamp_tokens=4, escalate_dwell_s=1.0,
        clear_after_s=5.0, clock=clocks[1],
        registry=jreg.MetricsRegistry())
    stages = []
    for t, depth, pressure in _SIGNALS:
        for c in clocks:
            c.t = t
        got = ours.evaluate(queue_depth=depth, pressure=pressure)
        assert got == theirs.evaluate(queue_depth=depth, pressure=pressure)
        assert (ours.shedding, ours.token_clamp) == (
            theirs.shedding, theirs.token_clamp)
        stages.append(got)
    assert stages[:5] == [1, 1, 2, 3, 3] and stages[-1] == 0
    assert ours.transitions == theirs.transitions
    assert {"pages", "recovered"} <= {t["reason"].split("+")[0]
                                      for t in ours.transitions}
    assert ours.max_stage_seen == 3
    assert ours.force_stage(3) == theirs.force_stage(3) == 3
    assert ours.transitions[-1] == theirs.transitions[-1]


@pytest.mark.parametrize("kw", [
    {}, dict(queue_high=0), dict(queue_high=4, queue_low=4),
    dict(queue_high=4, clamp_tokens=0), dict(queue_high=4,
                                             escalate_dwell_s=-1.0),
])
def test_brownout_validation_carries_the_jax_messages(kw):
    with pytest.raises(ValueError) as ours:
        BrownoutController(registry=MetricsRegistry(), **kw)
    with pytest.raises(ValueError) as theirs:
        jserve.BrownoutController(registry=jreg.MetricsRegistry(), **kw)
    assert str(ours.value) == str(theirs.value)


def test_brownout_gauge_records_and_refusals(tmp_path):
    from idc_models_tpu_torch.observe import JsonlLogger

    reg = MetricsRegistry()
    logger = JsonlLogger(tmp_path / "b.jsonl")
    b = BrownoutController(queue_high=2, escalate_dwell_s=0.0,
                           logger=logger, registry=reg, clock=_FakeClock())
    b.evaluate(queue_depth=3)
    logger.close()
    assert b"serve_brownout_stage 1" in reg.prometheus_text().encode()
    rec = json.loads((tmp_path / "b.jsonl").read_text())
    assert {k: v for k, v in rec.items() if k != "ts"} == {
        "event": "serve_brownout", "stage": 1,
        "stage_name": "pause_cache_writes", "direction": "escalate",
        "reason": "queue:3"}
    with pytest.raises(ValueError, match="stage must be in"):
        b.force_stage(4)
    # a tenant's controller: its own labelled gauge and event, the
    # untenanted ones untouched, and no hold on the shared prefix cache
    treg = MetricsRegistry()
    tlog = JsonlLogger(tmp_path / "t.jsonl")
    tb = BrownoutController(queue_high=2, tenant="acme", registry=treg,
                            logger=tlog, escalate_dwell_s=0.0)
    tb.evaluate(queue_depth=2)
    tlog.close()
    text = treg.prometheus_text()
    assert 'serve_tenant_brownout_stage{tenant="acme"} 1' in text
    assert "serve_brownout_stage" not in text.replace(
        "serve_tenant_brownout_stage", "")
    rec = json.loads((tmp_path / "t.jsonl").read_text())
    assert {k: v for k, v in rec.items() if k != "ts"} == {
        "event": "serve_tenant_brownout", "stage": 1,
        "stage_name": "pause_cache_writes", "direction": "escalate",
        "reason": "queue:2", "tenant": "acme"}
    with pytest.raises(ValueError, match="SHARED prefix"):
        BrownoutController(queue_high=2, tenant="acme",
                           prefix_cache=PrefixCache(4, 1 << 20,
                                                    registry=MetricsRegistry()),
                           registry=MetricsRegistry())


@pytest.mark.parametrize("flavour", ["contiguous", "paged"])
def test_stage_one_pauses_prefix_cache_writes(flavour):
    """Stage 1 stops snapshot storage while lookups go on; the restore
    resumes it; `clear()` drops every snapshot (and, paged, gives every
    page back)."""
    if flavour == "paged":
        cache = PagedPrefixCache(8, max_pages=16,
                                 registry=MetricsRegistry())
        extra = dict(kv_page_size=4, kv_pages=24)
    else:
        cache = PrefixCache(8, 1 << 20, registry=MetricsRegistry())
        extra = {}
    eng = SlotEngine(_params(), n_slots=1, prefill_chunk=8,
                     prefix_cache=cache, device="cpu",
                     cache_dtype=torch.float32, **KW, **extra)
    clk = _FakeClock()
    b = BrownoutController(queue_high=2, queue_low=0, clock=clk,
                           escalate_dwell_s=0.0, clear_after_s=1.0,
                           prefix_cache=cache, registry=MetricsRegistry())

    def prefill(prompt):
        eng.start_prefill(0, np.asarray(prompt), 2)
        while not eng.prefill_step(0):
            pass
        eng.release(0)

    prompt = tuple(range(VOCAB))
    b.evaluate(queue_depth=5)
    assert cache.writes_paused
    prefill(prompt)
    assert cache.n_snapshots == 0 and cache.misses == 1
    clk.t = 10.0
    b.evaluate(queue_depth=0)
    clk.t = 12.0
    b.evaluate(queue_depth=0)
    assert b.stage == 0 and not cache.writes_paused
    prefill(prompt)
    assert cache.n_snapshots == 2
    cache.clear()
    assert (cache.n_snapshots, cache.nbytes) == (0, 0)
    if flavour == "paged":
        assert eng._alloc.used_count() == 0


@functools.lru_cache(maxsize=None)
def _jax_shed_and_clamp():
    clk = _FakeClock()
    b = jserve.BrownoutController(queue_high=3, queue_low=0, clamp_tokens=2,
                                  escalate_dwell_s=0.0, clear_after_s=1e9,
                                  clock=clk,
                                  registry=jreg.MetricsRegistry())
    server = _jserver(n_slots=1, window=4, brownout=b, clock=clk)
    return _shed_and_clamp(server, b, clk, jserve.Request)


def _shed_and_clamp(server, b, clk, cls):
    """The JAX test's drive: shed by hand, a shed submit and a shed
    run() arrival, then the clamp stage, then normal again with the shed
    id resubmitted. (statuses and tokens by id, summary counts)."""
    for _ in range(3):
        b.evaluate(queue_depth=10)
    assert not server.submit(cls(id="s0", prompt=(1, 2), max_new_tokens=4))
    out = server.run([(0.0, cls(id="s1", prompt=(3,), max_new_tokens=4))])
    assert [r.status for r in out] == ["shed"]
    shed = server.poll("s0")
    s = server.summary()
    b._transition(2, clk(), "test")
    server.submit(cls(id="s2", prompt=(1, 2, 3), max_new_tokens=9))
    server.drain()
    clamped = server.poll("s2")
    b._transition(0, clk(), "test")
    assert server.submit(cls(id="s0", prompt=(1, 2), max_new_tokens=3))
    assert server.poll("s0") is None
    server.drain()
    with pytest.raises(ValueError, match="already used"):
        server.submit(cls(id="s2", prompt=(1,), max_new_tokens=2))
    final = server.summary()
    return ((shed.status, shed.finish_reason, shed.tokens), s["serve_shed"],
            (clamped.status, clamped.tokens), final["serve_clamped"],
            {rid: (server.poll(rid).status, server.poll(rid).tokens)
             for rid in ("s0", "s1", "s2")})


def test_server_sheds_and_clamps_as_the_jax_server_does():
    clk = _FakeClock()
    b = BrownoutController(queue_high=3, queue_low=0, clamp_tokens=2,
                           escalate_dwell_s=0.0, clear_after_s=1e9,
                           clock=clk, registry=MetricsRegistry())
    server = _server(n_slots=1, window=4, brownout=b, clock=clk)
    got = _shed_and_clamp(server, b, clk, Request)
    assert got == _jax_shed_and_clamp()
    assert got[0] == ("shed", "shed", []) and got[1] == 2
    assert got[2] == ("ok", _serial((1, 2, 3), 2)) and got[3] == 1
    assert server.poll("s2").clamped and not server.poll("s0").clamped


def _flood(server_fn, plan_cls, fault_cls, bc_cls, req_cls, reg):
    plan = plan_cls([fault_cls("burst", t, n=6, prompt_len=3, budget=12)
                     for t in range(1, 5)])
    b = bc_cls(queue_high=6, queue_low=1, clamp_tokens=4,
               escalate_dwell_s=0.0, clear_after_s=2.0,
               clock=_FakeClock(step=1.0), registry=reg)
    server = server_fn(n_slots=2, window=4, fault_plan=plan, brownout=b,
                       max_queue_depth=64)
    server.run([(0.0, req_cls(id=f"b{i}", prompt=(1 + i, 2),
                              max_new_tokens=6)) for i in range(4)])
    s = server.summary()
    return ({r.id: (r.status, r.tokens) for r in server.results()},
            {k: s[k] for k in ("serve_shed", "serve_clamped",
                               "serve_faults_injected", "serve_tokens")},
            b.transitions, b.max_stage_seen)


def test_burst_floods_and_the_brownout_sheds_as_in_jax():
    """Burst faults flood the queue, the watermark brownout (on a clock
    that moves one second a reading) escalates to shed, and every
    refusal is a shed Result: the same Results, counts and transitions
    as the JAX server's."""
    ours = _flood(_server, ServeFaultPlan, ServeFault, BrownoutController,
                  Request, MetricsRegistry())
    theirs = _flood(_jserver, jserve.ServeFaultPlan, jserve.ServeFault,
                    jserve.BrownoutController, jserve.Request,
                    jreg.MetricsRegistry())
    assert ours == theirs
    results, counts, _, top = ours
    assert counts["serve_faults_injected"] == 4 and counts["serve_shed"]
    assert top == 3
    assert any(k.startswith("!burst") and v[0] == "shed"
               for k, v in results.items())
    assert all(results[f"b{i}"][0] in ("ok", "shed") for i in range(4))


def test_page_pressure_escalates_the_brownout_with_reason_pages():
    """A pool that fits one request at a time (16 pages of 4, each
    request 9 pages at its full budget): the head waits on pages,
    the brownout escalates for `pages` as the JAX one does, and every
    request ends with its serial tokens at its served length."""
    def run(server_fn, bc_cls, req_cls, reg):
        bo = bc_cls(queue_high=10_000, clamp_tokens=4, escalate_dwell_s=0.0,
                    clear_after_s=60.0, registry=reg)
        srv = server_fn(n_slots=2, window=4, prefill_chunk=8,
                        kv_page_size=4, kv_pages=16, brownout=bo)
        rng = np.random.default_rng(19)
        reqs = [req_cls(id=f"w{i}", prompt=tuple(
            int(x) for x in rng.integers(0, VOCAB, 20)), max_new_tokens=16)
            for i in range(3)]
        srv.run([(0.0, r) for r in reqs])
        return srv, reqs, bo

    srv, reqs, bo = run(_server, BrownoutController, Request,
                        MetricsRegistry())
    jsrv, _, jbo = run(_jserver, jserve.BrownoutController, jserve.Request,
                       jreg.MetricsRegistry())
    assert srv.summary()["serve_page_exhaustions"] > 0
    assert [t["reason"] for t in bo.transitions] == [
        t["reason"] for t in jbo.transitions]
    assert any("pages" in t["reason"] for t in bo.transitions)
    for r in reqs:
        got = srv.poll(r.id)
        assert got.status == "ok" and got.tokens == jsrv.poll(r.id).tokens
        assert got.tokens == _serial(r.prompt, 16)[:len(got.tokens)]
    assert srv.engine._alloc.used_count() == 0


# ---------------------------------------------------------------------------
# the server's close, the metrics and the exports
# ---------------------------------------------------------------------------


def test_submit_after_close_raises_and_close_flushes_the_journal(tmp_path):
    server = _server(n_slots=1, window=4, journal=tmp_path / "wal.jsonl")
    assert isinstance(server.journal, RequestJournal)
    server.submit(Request(id="a", prompt=(1, 2), max_new_tokens=3))
    server.drain()
    server.close()
    with pytest.raises(RuntimeError, match="close"):
        server.submit(Request(id="b", prompt=(3,), max_new_tokens=3))
    assert load_journal(tmp_path / "wal.jsonl")["finished"] == {"a": "ok"}


def test_resilience_metrics_equal_the_jax_metrics():
    """The shed, clamp and fault hooks beside the others, at fixed times,
    into both packages' ServingMetrics: summary() equal, key for key;
    the counters render under the JAX names."""
    from idc_models_tpu.serve import metrics as jmetrics
    from idc_models_tpu_torch.serve import ServingMetrics

    def feed(m):
        m.on_submit("a", 1.0)
        m.on_shed("b")
        m.on_fault_injected("stall", tick=2)
        m.on_fault_injected("burst", tick=3)
        m.on_admit("a", 0.25)
        m.on_clamp("a", asked=9, clamp=4)
        m.on_first_token("a", 0.5)
        m.on_finish("a", n_tokens=4, ttft_s=0.5, decode_s=0.5,
                    reason="budget", t=2.0)

    reg = MetricsRegistry()
    ours = ServingMetrics(registry=reg)
    theirs = jmetrics.ServingMetrics(registry=jreg.MetricsRegistry())
    feed(ours)
    feed(theirs)
    assert ours.summary() == theirs.summary()
    assert (ours.shed, ours.clamped, ours.faults_injected) == (1, 1, 2)
    text = reg.prometheus_text()
    for line in ('serve_shed_total 1', 'serve_clamped_total 1',
                 'serve_faults_injected_total{kind="stall"} 1',
                 'serve_requests_total{status="shed"} 1'):
        assert line in text, line


def test_the_serve_package_exports_the_jax_resilience_names():
    names = ("BrownoutController", "InjectedEngineCrash",
             "InjectedPrefillError", "ServeFault", "ServeFaultPlan",
             "parse_serve_fault_spec", "RequestJournal", "load_journal",
             "pending_requests", "AdapterBank", "Tenancy", "TenantQuota",
             "TenantRegistry")
    assert all(hasattr(jserve, n) and hasattr(tserve, n) for n in names)
    reg = tserve.TenantRegistry()
    reg.register("acme")
    server = _server(tenancy=reg, warmup=False)
    assert server.summary()["serve_tenants"] == {"acme": {
        "requests": 0, "tokens": 0, "ttft_ms_p50": None,
        "ttft_ms_p95": None, "shed": 0, "quota_rejections": 0,
        "slo_breached": False}}


# ---------------------------------------------------------------------------
# the serve verb
# ---------------------------------------------------------------------------

_VERB = ["--vocab", str(VOCAB), "--embed-dim", str(E), "--num-heads",
         str(HEADS), "--mlp-dim", str(MLP), "--num-blocks", str(BLOCKS),
         "--t-max", str(T_MAX), "--slots", "2", "--window", "4"]
_DRILL = "nan_logits:2:0,stall:3:0.001,burst:2:4,crash:9"


def _verb(argv, module=cli):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = module.main(["serve", *argv])
    return rc, out.getvalue().splitlines()


def _drill_lines(lines):
    return [ln for ln in lines
            if ln.startswith(("engine crashed", "served:", "resilience:",
                              "journal:"))]


@functools.lru_cache(maxsize=None)
def _jax_verb():
    """The JAX verb's drill and recovery lines over the same flags."""
    from idc_models_tpu import cli as jcli

    wal = Path(tempfile.mkdtemp()) / "wal.jsonl"
    empty = wal.parent / "empty.jsonl"
    empty.write_text("")
    first = _verb(_VERB + ["--requests", "8", "--serve-faults", _DRILL,
                           "--max-retries", "2", "--journal", str(wal),
                           "--brownout", "--brownout-dwell-ms", "0",
                           "--brownout-clear-ms", "50"], jcli)[1]
    second = _verb(_VERB + ["--trace", str(empty), "--journal", str(wal),
                            "--max-retries", "2"], jcli)[1]
    return str(wal), _drill_lines(first), _drill_lines(second)


def test_serve_verb_drill_and_recovery_print_the_jax_lines(tmp_path):
    """`serve --serve-faults ... --journal ... --brownout`: the crash
    line with its hint and the resilience line; then the rerun on the
    same journal re-admits what was pending and serves it all. The lines
    are the JAX verb's for the same flags."""
    wal = tmp_path / "wal.jsonl"
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    rc, first = _verb(_VERB + ["--device", "cpu", "--requests", "8",
                               "--serve-faults", _DRILL, "--max-retries",
                               "2", "--journal", str(wal), "--brownout",
                               "--brownout-dwell-ms", "0",
                               "--brownout-clear-ms", "50"])
    assert rc == 0
    pending = len(pending_requests(wal))
    rc, second = _verb(_VERB + ["--device", "cpu", "--trace", str(empty),
                                "--journal", str(wal), "--max-retries",
                                "2"])
    assert rc == 0
    jwal, jfirst, jsecond = _jax_verb()
    assert _drill_lines(first) == [ln.replace(jwal, str(wal))
                                   for ln in jfirst]
    assert _drill_lines(second) == jsecond
    assert any(ln.startswith("engine crashed mid-run (injected): injected "
                             "engine crash at cycle 9; rerun with "
                             f"--journal {wal}") for ln in first)
    assert any(ln.startswith("resilience: injected=") and
               "brownout_max_stage=" in ln for ln in first)
    assert f"journal: re-admitted {pending} in-flight request(s) from a " \
           f"previous run" in second and pending
    assert any(ln.startswith(f"served: ok={pending} ") for ln in second)
    assert pending_requests(wal) == []


@pytest.mark.parametrize("argv,match", [
    (["--brownout-queue-high", "0"], "--brownout-queue-high 0 must be >= 1"),
    (["--brownout-clamp-tokens", "0"],
     "--brownout-clamp-tokens 0 must be >= 1"),
    (["--brownout-dwell-ms", "-1"],
     "--brownout-dwell-ms/--brownout-clear-ms must be >= 0"),
    (["--brownout-clear-ms", "-5"],
     "--brownout-dwell-ms/--brownout-clear-ms must be >= 0"),
    (["--serve-faults", "meteor:1"], "--serve-faults: bad fault group"),
    (["--serve-faults", "crash:2:7"], "takes no parameter"),
])
def test_serve_verb_resilience_usage_errors_carry_the_jax_messages(
        argv, match):
    from idc_models_tpu import cli as jcli

    with pytest.raises(SystemExit) as ours:
        _verb(["--device", "cpu", *argv])
    with pytest.raises(SystemExit) as theirs:
        _verb(list(argv), jcli)
    assert str(ours.value) == str(theirs.value)
    assert match in str(ours.value)
