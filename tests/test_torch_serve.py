"""The port's serving stack (idc_models_tpu_torch/serve/: SlotEngine,
Scheduler, ServingMetrics, LMServer, the trace files; the `serve` verb)
on the CPU: the engine against the serial port `Generator` under the
engine-against-serial contract, the scheduler's policies, and the
server against the JAX package's `LMServer` on the same weights (carried
across by `convert.load_jax`) and the same trace.

The contract: the engine's per-token products are [S, E] @ W where the
serial Generator's are [1, E] @ W, and the CPU's BLAS rounds the two
differently (the tests report whether any bit differed). So every
step's logits are held within the cache dtype's rounding of the serial
run's (f32: 1e-5 of the largest |logit|; int8: 2^-7), and the tokens
equal the serial tokens up to the first step where the serial run's
top-2 margin falls below that tolerance; the tests report how many steps
were held."""

from __future__ import annotations

import contextlib
import functools
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idc_models_tpu import mesh as jmeshlib
from idc_models_tpu import serve as jserve
from idc_models_tpu.models import lm as jlm
from idc_models_tpu_torch import cli
from idc_models_tpu_torch.models import lm as tlm
from idc_models_tpu_torch.observe import JsonlLogger, MetricsRegistry
from idc_models_tpu_torch.serve import (
    HEALTH_KINDS, LMServer, Request, RetryPolicy, SlotEngine, poisson_trace,
    save_trace,
)

VOCAB, E, HEADS, MLP, BLOCKS, T_MAX = 16, 32, 2, 64, 2, 64
KW = dict(embed_dim=E, num_heads=HEADS, num_blocks=BLOCKS, t_max=T_MAX)
F32_TOL = 1e-5            # of the largest |logit|
INT8_TOL = 2.0 ** -7      # one int8 level of the row's absmax


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
    win by more than the two packages' rounding (checked where tokens
    are compared across packages)."""
    model = jlm.attention_lm(VOCAB, T_MAX, embed_dim=E, num_heads=HEADS,
                             mlp_dim=MLP, num_blocks=BLOCKS)
    params = jax.tree.map(np.array, jax.device_get(
        model.init(jax.random.key(0)).params))
    params["head"]["kernel"] = params["head"]["kernel"] * 8.0
    return params


def _port_kw(**kw):
    return dict(KW, device="cpu", cache_dtype=torch.float32, **kw)


def _gen(**kw):
    return tlm.Generator(_params(), **_port_kw(**kw))


def _engine(**kw):
    return SlotEngine(_params(), **_port_kw(**kw))


def _server(**kw):
    return LMServer(_params(), registry=MetricsRegistry(), **_port_kw(**kw))


def _prompts(n, seed, lo=3, hi=20):
    rng = np.random.default_rng(seed)
    return [tuple(int(x) for x in rng.integers(0, VOCAB, int(p)))
            for p in rng.integers(lo, hi, n)]


def _serial(gen, prompt, steps, rng=None):
    """A serial run's tokens and, per step, the logits its pick read."""
    logits, caches = gen.prefill([list(prompt)])
    toks, seen = [], []
    for i in range(steps):
        seen.append(logits[0].clone())
        tok, logits, caches = gen.decode(caches, logits, len(prompt) + i, 1,
                                         rng=rng)
        toks.append(int(tok[0, 0]))
    return toks, seen


def _drive(eng, prompts, budgets, seeds=None):
    """Requests through the engine in windows of one step, refilling
    freed slots (recycling): each request's tokens and, per step, the
    logits row its pick read."""
    queue, slot_of = list(range(len(prompts))), {}
    toks = {i: [] for i in queue}
    seen = {i: [] for i in queue}
    while queue or slot_of:
        for s in eng.free_slots():
            if not queue:
                break
            i = queue.pop(0)
            eng.admit(s, prompts[i], budgets[i],
                      rng=None if seeds is None else seeds[i])
            slot_of[s] = i
        for s, i in slot_of.items():
            seen[i].append(eng._logits[s].clone())
        for s, row in eng.step_window(1).items():
            toks[slot_of[s]] += row
        for s in [s for s in slot_of if eng.finished(s)]:
            eng.release(s)
            del slot_of[s]
    return toks, seen


def _held(got, got_seen, want, want_seen, tol):
    """The contract for one request: (steps held, steps, bits equal)."""
    bits = True
    for i, (w, lw) in enumerate(zip(want, want_seen)):
        scale = float(lw.abs().max())
        diff = float((got_seen[i] - lw).abs().max())
        bits &= diff == 0.0
        assert diff <= tol * scale, (i, diff, scale)
        top2 = lw.topk(2).values
        if float(top2[0] - top2[1]) < tol * scale:
            return i, len(want), bits        # a near tie: free from here
        assert got[i] == w, (i, got, want)
    return len(want), len(want), bits


@pytest.mark.parametrize("mode", ["greedy", "sampled", "chunked", "int8"])
def test_engine_meets_the_contract_against_the_serial_generator(mode):
    """Five requests through a 2-slot engine, recycling slots, against
    each request run alone: the serial Generator (greedy; sampled at
    temperature 0.8, top-k 5, each request's seed; chunked prefill of 8),
    or for int8 caches a one-slot int8 engine (the serial int8 path).
    The first step's logits come from the same prefill: equal bit for
    bit."""
    prompts = _prompts(5, 21)
    budgets = [int(b) for b in np.random.default_rng(22).integers(4, 12, 5)]
    seeds = [100 + i for i in range(5)] if mode == "sampled" else None
    kw = {"sampled": dict(temperature=0.8, top_k=5),
          "chunked": dict(prefill_chunk=8),
          "int8": dict(kv_dtype="int8")}.get(mode, {})
    got, got_seen = _drive(_engine(n_slots=2, **kw), prompts, budgets,
                           seeds)
    tol = INT8_TOL if mode == "int8" else F32_TOL
    report = []
    for i, (p, n) in enumerate(zip(prompts, budgets)):
        if mode == "int8":
            want, want_seen = _drive(_engine(n_slots=1, **kw), [p], [n])
            want, want_seen = want[0], want_seen[0]
        else:
            gen = _gen(**{k: v for k, v in kw.items() if k != "kv_dtype"})
            rng = (torch.Generator().manual_seed(seeds[i]) if seeds
                   else None)
            want, want_seen = _serial(gen, p, n, rng)
        assert torch.equal(got_seen[i][0], want_seen[0])
        report.append(_held(got[i], got_seen[i], want, want_seen, tol))
        if mode == "sampled":
            assert got[i] == want           # every draw, f32 on the CPU
    held = sum(r[0] for r in report)
    total = sum(r[1] for r in report)
    print(f"{mode}: tokens held {held} of {total} steps; logits bit-equal "
          f"in {sum(r[2] for r in report)} of 5 requests")


def test_int8_capacity_and_tokens_against_the_float_generator():
    """What the JAX int8 test holds: cache bytes a slot drop at least
    1.5x against the bf16 engine, and every request of an int8 server is
    ok with the serial float Generator's greedy tokens on this model."""
    ratio = (SlotEngine(_params(), **dict(_port_kw(n_slots=2),
                                          cache_dtype=torch.bfloat16))
             .kv_bytes_per_slot()
             / _engine(n_slots=2, kv_dtype="int8").kv_bytes_per_slot())
    assert ratio >= 1.5, ratio
    server = _server(n_slots=2, window=4, kv_dtype="int8")
    gen = _gen()
    reqs = [Request(id=f"i{k}", prompt=p, max_new_tokens=6)
            for k, p in enumerate(_prompts(3, 17))]
    server.run([(0.0, r) for r in reqs])
    for r in reqs:
        got = server.poll(r.id)
        assert got.status == "ok"
        assert got.tokens == gen([list(r.prompt)], 6)[0, len(r.prompt):
                                                        ].tolist(), r.id


def test_eos_retires_the_request_mid_window():
    """A stop token the request emits at its third step ends it there,
    mid-window: tokens cut at the EOS (inclusive), reason "eos", and the
    slot recycled for the next request."""
    prompt = _prompts(1, 31)[0]
    serial = _gen()([list(prompt)], 8)[0, len(prompt):].tolist()
    eos = serial[2]
    cut = serial[:serial.index(eos) + 1]
    server = _server(n_slots=1, window=8, eos_id=eos)
    server.run([(0.0, Request(id="a", prompt=prompt, max_new_tokens=8)),
                (0.0, Request(id="b", prompt=prompt, max_new_tokens=8,
                              eos_id=-1))])
    a, b = server.poll("a"), server.poll("b")
    assert (a.status, a.finish_reason, a.tokens) == ("ok", "eos", cut)
    assert (b.status, b.finish_reason, b.tokens) == ("ok", "budget", serial)


def test_dead_slot_cache_untouched():
    """Windows decoded while a slot is dead leave its cache rows bit
    for bit as they were."""
    eng = _engine(n_slots=2)
    eng.warmup(4)
    eng.admit(0, (1, 2, 3), 4)
    eng.admit(1, (4, 5), 20)
    while not eng.finished(0):
        eng.step_window(4)
    eng.release(0)
    before = [(kc[0].clone(), vc[0].clone()) for kc, vc in eng._caches]
    eng.step_window(4)                   # slot 0 dead, slot 1 decoding
    for (k0, v0), (kc, vc) in zip(before, eng._caches):
        assert torch.equal(k0, kc[0]) and torch.equal(v0, vc[0])


def test_admit_rejections_and_later_items():
    eng = _engine(n_slots=1)
    with pytest.raises(ValueError, match="exceeds t_max"):
        eng.admit(0, list(range(T_MAX - 2)), 3)
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.admit(0, (1, 2), 0)
    with pytest.raises(ValueError, match="non-empty"):
        eng.admit(0, np.zeros((1, 0), np.int64), 2)
    eng.admit(0, (1, 2), 2)
    with pytest.raises(ValueError, match="occupied"):
        eng.admit(0, (1, 2), 2)
    with pytest.raises(ValueError, match="kv_dtype"):
        _engine(kv_dtype="fp8")
    server = _server(n_slots=1, temperature=1.0, warmup=False)
    with pytest.raises(ValueError, match="rng"):
        server.submit(Request(id="x", prompt=(1,), max_new_tokens=2))
    for kw, label in ((dict(kv_page_size=8, kv_pages=16), "A9.2"),
                      (dict(prefix_cache=object()), "A9.2"),
                      (dict(draft_k=4), "A9.3"),
                      (dict(adapter_bank=object()), "A9.4"),
                      (dict(partition_rules=object()), "A9-dist")):
        with pytest.raises(NotImplementedError, match=label):
            _engine(**kw)
    with pytest.raises(NotImplementedError, match="A10"):
        eng.export_slot(0)
    with pytest.raises(NotImplementedError, match="A9.3"):
        _server(spec_decode=True, warmup=False)
    with pytest.raises(NotImplementedError, match="A9.4"):
        _server(journal="wal.jsonl", warmup=False)


def test_slot_health_codes_and_quarantine_with_retry():
    """NaN and blown-up logits read as their health codes; a slot
    poisoned mid-run is quarantined and, with a RetryPolicy, its request
    reruns from the prompt to the unfaulted tokens (attempts 2), while
    without retries it finishes as an error; the neighbour is unharmed."""
    eng = _engine(n_slots=3)
    eng.admit(0, (1, 2), 4)
    eng.admit(1, (3, 4), 4)
    eng.inject_slot_fault(0, "nan_logits")
    eng.inject_slot_fault(1, "garbage_logits")
    codes = eng.slot_health()
    assert [HEALTH_KINDS.get(int(c)) for c in codes] == [
        "nonfinite_logits", "logit_magnitude", None]
    with pytest.raises(ValueError, match="kind must be"):
        eng.inject_slot_fault(0, "bitflip")
    reqs = [Request(id=f"q{i}", prompt=p, max_new_tokens=6)
            for i, p in enumerate(_prompts(2, 41))]
    clean = _server(n_slots=2, window=2)
    clean.run([(0.0, r) for r in reqs])
    for retry, want_status in ((RetryPolicy(max_retries=1, backoff_s=0.0),
                                "ok"), (None, "error")):
        server = _server(n_slots=2, window=2, retry=retry,
                         health_checks=True)
        for r in reqs:
            server.submit(r)
        server.step()
        server.step()                # both running, a window in flight
        server.engine.inject_slot_fault(0, "nan_logits")
        server.drain()
        hit, other = server.poll("q0"), server.poll("q1")
        assert hit.status == want_status
        assert other.status == "ok"
        assert other.tokens == clean.poll("q1").tokens
        if retry is not None:
            assert (hit.attempts, hit.retried) == (2, True)
            assert hit.tokens == clean.poll("q0").tokens
        else:
            assert hit.finish_reason == "slot_fault"
        assert server.summary()["serve_slot_faults"] == 1


def test_backpressure_and_deadlines():
    """A full queue refuses (False, no Result); a queued request past
    its deadline times out with no tokens, a running one with its
    partial tokens, and a chunked prefill past it frees its slot."""
    now = [0.0]
    server = _server(n_slots=1, window=2, max_queue_depth=1,
                     clock=lambda: now[0])
    assert server.submit(Request(id="run", prompt=(1, 2),
                                 max_new_tokens=12, deadline_s=1.0))
    server.step()                            # admitted, window issued
    assert server.submit(Request(id="queued", prompt=(3,),
                                 max_new_tokens=2, deadline_s=0.5))
    assert not server.submit(Request(id="full", prompt=(3,),
                                     max_new_tokens=2))
    assert server.poll("full") is None
    server.step()
    now[0] = 1.5
    server.drain()
    run, queued = server.poll("run"), server.poll("queued")
    assert (run.status, run.finish_reason) == ("timeout", "deadline")
    assert 0 < len(run.tokens) < 12
    assert (queued.status, queued.tokens) == ("timeout", [])
    s = server.summary()
    assert (s["serve_timed_out"], s["serve_rejected"]) == (2, 1)
    now[0] = 0.0
    chunked = _server(n_slots=1, window=4, prefill_chunk=4,
                      clock=lambda: now[0])
    chunked.submit(Request(id="long", prompt=tuple(range(1, 16)),
                           max_new_tokens=4, deadline_s=1.0))
    chunked.step()                           # reserve + first chunk
    now[0] = 1.5
    chunked.step()
    assert (chunked.poll("long").status, chunked.poll("long").tokens) == (
        "timeout", [])
    chunked.submit(Request(id="next", prompt=(1, 2), max_new_tokens=3))
    chunked.drain()
    assert chunked.poll("next").status == "ok"


def test_engine_failure_releases_slots_and_surfaces_the_error(monkeypatch):
    """A collect that raises: step() re-raises, every in-flight request
    is an error Result with the detail, the slots are free, and a fresh
    request then completes."""
    server = _server(n_slots=2, window=2)
    server.submit(Request(id="a", prompt=(1, 2), max_new_tokens=6))
    server.submit(Request(id="b", prompt=(3,), max_new_tokens=6))
    server.step()

    def broken():
        raise RuntimeError("device lost")

    monkeypatch.setattr(server.engine, "collect", broken)
    with pytest.raises(RuntimeError, match="device lost"):
        server.step()
    monkeypatch.undo()
    for rid in ("a", "b"):
        r = server.poll(rid)
        assert r.status == "error" and "device lost" in r.error
    assert server.engine.free_slots() == [0, 1]
    server.submit(Request(id="c", prompt=(4, 5), max_new_tokens=3))
    server.drain()
    assert server.poll("c").status == "ok"


def test_pallas_prefill_of_a_short_prompt_fails_that_request_only():
    """With block_impl="pallas" a prompt of 64 tokens or fewer buckets
    under the kernel's 128: its admission raises, as in the JAX package,
    the request is an error and the server goes on."""
    from idc_models_tpu_torch.models.core import init_params

    model = init_params(tlm.AttentionLM(VOCAB, 128, embed_dim=E,
                                        num_heads=HEADS, mlp_dim=MLP,
                                        num_blocks=BLOCKS), 0)
    server = LMServer(model, registry=MetricsRegistry(),
                      **dict(_port_kw(n_slots=1, window=2,
                                      block_impl="pallas"), t_max=128))
    server.submit(Request(id="short", prompt=tuple(range(10)),
                          max_new_tokens=2))
    with pytest.raises(ValueError, match="multiples of 128"):
        server.step()
    assert server.poll("short").status == "error"
    server.submit(Request(id="long", prompt=tuple(i % VOCAB
                                                  for i in range(70)),
                          max_new_tokens=2))
    server.drain()
    assert server.poll("long").status == "ok"


def _trace():
    return poisson_trace(6, rate_per_s=50.0, vocab=VOCAB, t_max=T_MAX,
                         prompt_lens=(2, 16), budgets=(2, 16), seed=3)


@functools.lru_cache(maxsize=None)
def _jax_served():
    """The JAX LMServer's (summary, {id: tokens}) on the 6-request
    trace: 3 slots, window 4, f32 caches, one-device mesh."""
    server = jserve.LMServer(_params(), n_slots=3, window=4,
                             mesh=jmeshlib.seq_mesh(1),
                             cache_dtype=jnp.float32, **KW)
    trace = jserve.poisson_trace(6, rate_per_s=50.0, vocab=VOCAB,
                                 t_max=T_MAX, prompt_lens=(2, 16),
                                 budgets=(2, 16), seed=3)
    server.run(trace)
    return server.summary(), {r.id: server.poll(r.id).tokens
                              for _, r in trace}


def test_lmserver_matches_the_jax_lmserver(tmp_path):
    """The same trace through both servers: greedy tokens equal request
    for request (each pick's margin far above the rounding, checked on
    the serial logits), the summary's key set equal, and the serve.jsonl
    records in the JAX event shape."""
    want_summary, want = _jax_served()
    logger = JsonlLogger(tmp_path / "serve.jsonl")
    server = _server(n_slots=3, window=4, logger=logger)
    results = server.run(_trace())
    logger.close()
    gen = _gen()
    for _, r in _trace():
        assert server.poll(r.id).status == "ok"
        assert server.poll(r.id).tokens == want[r.id], r.id
        _, seen = _serial(gen, r.prompt, r.max_new_tokens)
        for lw in seen:
            top2 = lw.topk(2).values
            assert float(top2[0] - top2[1]) > 1e-3
    assert len(results) == 6
    got_summary = server.summary()
    assert set(got_summary) == set(want_summary)
    assert got_summary["serve_requests"] == want_summary["serve_requests"]
    assert got_summary["serve_tokens"] == want_summary["serve_tokens"]
    events = [json.loads(line)["event"] for line in
              (tmp_path / "serve.jsonl").read_text().splitlines()]
    for ev in ("serve_submit", "serve_admit", "serve_first_token",
               "serve_finish"):
        assert events.count(ev) == 6, ev


def test_traces_match_the_jax_files(tmp_path):
    """poisson_trace draws the JAX trace; save_trace writes its bytes
    (sampled and untagged, deadlines and EOS), and load_trace reads
    either file back."""
    kw = dict(rate_per_s=7.5, vocab=VOCAB, t_max=T_MAX, eos_id=3,
              deadline_s=2.5, seed=9, sampled=True)
    ours, theirs = poisson_trace(8, **kw), jserve.poisson_trace(8, **kw)
    save_trace(tmp_path / "t.jsonl", ours)
    jserve.save_trace(tmp_path / "j.jsonl", theirs)
    assert (tmp_path / "t.jsonl").read_bytes() == \
        (tmp_path / "j.jsonl").read_bytes()
    from idc_models_tpu_torch.serve import load_trace
    back = load_trace(tmp_path / "j.jsonl")
    assert [(t, r.id, r.prompt, r.max_new_tokens, r.seed) for t, r in back] \
        == [(t, r.id, r.prompt, r.max_new_tokens, r.seed) for t, r in ours]


def _verb(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["serve", "--device", "cpu", *argv])
    return rc, out.getvalue().splitlines()


def test_serve_verb_prints_the_jax_lines_on_the_cpu(tmp_path):
    rc, lines = _verb(["--requests", "5", "--slots", "2", "--window", "4",
                       "--t-max", "32", "--path", str(tmp_path),
                       "--prefill-chunk", "8", "--kv-dtype", "int8",
                       "--max-retries", "1", "--slo-ttft-p95-ms", "60000",
                       "--trace-out", str(tmp_path / "t.json")])
    assert rc == 0
    spans = [e for e in json.loads((tmp_path / "t.json").read_text())[
        "traceEvents"] if e["ph"] == "X"]
    names = {e["name"] for e in spans}
    assert {"serve.tick", "serve.admit", "serve.prefill_chunk",
            "serve.window", "serve.collect", "device.sync",
            "serve.request", "serve.queued"} <= names
    assert sum(e["name"] == "serve.request" for e in spans) == 5
    assert "serving 5 requests on 2 slots (window 4, t_max 32, ring 1)" \
        in lines
    served = [ln for ln in lines if ln.startswith("served: ")]
    assert served and served[0].startswith("served: ok=5 timeout=0 "
                                           "rejected=0")
    assert any(ln.startswith("ttft p95 ") and "= queue-wait " in ln
               for ln in lines)
    assert "slo: 0 alert(s)" in lines
    assert any(ln.startswith("resilience: injected=0 slot_faults=0")
               for ln in lines)
    summary = json.loads(next(ln for ln in lines
                              if ln.startswith("serve summary: "))[15:])
    assert summary["serve_requests"] == 5
    records = [json.loads(line) for line in
               (tmp_path / "logs" / "serve.jsonl").read_text().splitlines()]
    assert records[-1]["event"] == "metrics_snapshot"
    assert any(r["event"] == "serve_summary" for r in records)


@pytest.mark.parametrize("flag,label", [
    (flag, label) for flag, _, label in cli._LATER] + [
    ("--seq-parallel 2", "A9-dist"), ("--tp 2", "A9-dist"),
    ("--host-devices 2", "A9-dist")],
    ids=lambda v: v if isinstance(v, str) else None)
def test_serve_verb_refuses_later_flags_naming_their_item(flag, label):
    kw = dict(next((kw for f, kw, _ in cli._LATER if f == flag), {}))
    argv = flag.split()
    if kw.get("action") == "append":
        argv.append("x=1")
    elif kw.get("action") != "store_true" and len(argv) == 1:
        argv.append("7" if kw.get("type") in (int, float) else "x")
    with pytest.raises(SystemExit, match=label.replace(".", "\\.")):
        _verb(argv)


@pytest.mark.parametrize("argv,match", [
    (["--prefill-chunk", "5"], "must be >= 1 and divide --t-max"),
    (["--fsdp", "2"], "FSDP shards"),
    (["--temperature", "-1"], "must be >= 0"),
    (["--slo-error-rate", "1.5"], "fraction in"),
    (["--metrics-port", "70000"], "must be in"),
    (["--max-retries", "-1"], "must be >= 0"),
])
def test_serve_verb_checks_carry_the_jax_messages(argv, match):
    with pytest.raises(SystemExit, match=match):
        _verb(argv)


def test_serving_metrics_summary_and_rollup_equal_jax():
    """The same hook calls, at fixed times, into the port's and the JAX
    package's ServingMetrics: summary() and aggregate_summaries() equal,
    key for key and value for value."""
    from idc_models_tpu.observe import metrics_registry as jreg
    from idc_models_tpu.serve import metrics as jmetrics
    from idc_models_tpu_torch.serve import ServingMetrics, aggregate_summaries

    def feed(m, shift):
        m.on_submit("a", 1.0 + shift)
        m.on_submit("b", 1.5 + shift)
        m.on_reject("c", 1.6 + shift)
        m.on_admit("a", 0.25)
        m.on_cycle(queue_depth=1, occupancy=0.5, tokens=0, prefill_s=0.01)
        m.on_dispatch("window")
        m.on_first_token("a", 0.75)
        m.on_slot_fault("b", kind="nonfinite_logits", slot=1)
        m.on_retry("b", attempt=2, delay_s=0.05)
        m.on_admit("b", 0.5)
        m.on_cycle(queue_depth=0, occupancy=1.0, tokens=7, prefill_s=0.02)
        m.on_dispatch("window")
        m.on_finish("a", n_tokens=6, ttft_s=0.75, decode_s=0.5,
                    reason="budget", t=3.0 + shift)
        m.on_finish("b", n_tokens=0, ttft_s=None, decode_s=0.0,
                    reason="deadline", t=3.5 + shift)

    ours = [ServingMetrics(registry=MetricsRegistry()) for _ in range(2)]
    theirs = [jmetrics.ServingMetrics(registry=jreg.MetricsRegistry())
              for _ in range(2)]
    for i, (a, b) in enumerate(zip(ours, theirs)):
        feed(a, i)
        feed(b, i)
        assert a.summary() == b.summary()
    assert aggregate_summaries(ours) == jmetrics.aggregate_summaries(theirs)


def test_swap_params_and_residency():
    """swap_params refuses a tree of another shape and takes one of the
    same shape in place (the next window decodes under it, the caches
    kept); the residency figures follow the slots."""
    eng = _engine(n_slots=3)
    eng.admit(0, (1, 2, 3), 6)
    assert eng.tokens_resident() == 3
    assert eng.kv_bytes_resident() == 3 * eng.kv_bytes_per_slot() == \
        3 * BLOCKS * 2 * T_MAX * E * 4
    bad = jax.tree.map(np.array, _params())
    bad["head"]["kernel"] = bad["head"]["kernel"][:, :4]
    with pytest.raises(ValueError, match="does not match the serving"):
        eng.swap_params(bad)
    swapped = jax.tree.map(np.array, _params())
    swapped["head"]["kernel"] = -swapped["head"]["kernel"]
    eng.swap_params(swapped)
    assert torch.equal(eng._model.head.kernel,
                       torch.from_numpy(swapped["head"]["kernel"]))
    eng.step_window(2)
    assert eng.tokens_resident() == 5
