"""The port's one-server drain (idc_models_tpu_torch/serve/engine.py
`export_slot` / `import_slot`, the scheduler's `begin_drain`,
`export_running`, `import_running` and `drain_pending`, the `serve`
verb's SIGTERM drain) on the CPU, against the JAX package's on the same
weights and requests.

The contracts are the JAX package's (tests/test_draft_lm.py:225-270,
tests/test_elastic.py:257-297 and :511), taken without a router: a
request moved mid-decode finishes as if it never moved -- bit for bit
between two port engines, greedy, sampled (its generator's state moves
with it) and with the learned drafter's rows; under the f32 serving
contract (1e-5 of the largest |logit|) when the snapshot is the JAX
engine's. The journals of the two servers carry JAX's migration
protocol record for record, and SIGTERM drains the verb with every
submit finished."""

from __future__ import annotations

import functools
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idc_models_tpu import serve as jserve
from idc_models_tpu.models import lm as jlm
from idc_models_tpu.observe import metrics_registry as jreg
from idc_models_tpu_torch import cli, convert
from idc_models_tpu_torch.models import draft_lm as tdlm
from idc_models_tpu_torch.models import lm as tlm
from idc_models_tpu_torch.models.core import init_params
from idc_models_tpu_torch.observe import MetricsRegistry
from idc_models_tpu_torch.serve import LMServer, Request, SlotEngine

VOCAB, SEQ, E, HEADS, MLP, BLOCKS = 11, 32, 32, 2, 64, 2
KW = dict(embed_dim=E, num_heads=HEADS, num_blocks=BLOCKS, t_max=SEQ)
K = 3
CONTRACT = 1e-5
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share a few cores: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _params():
    """The JAX LM's seed-0 weights as host arrays, the head sharpened so
    greedy picks win by more than the packages' rounding."""
    model = jlm.attention_lm(VOCAB, SEQ, embed_dim=E, num_heads=HEADS,
                             mlp_dim=MLP, num_blocks=BLOCKS)
    params = jax.tree.map(np.array, jax.device_get(
        model.init(jax.random.key(0)).params))
    params["head"]["kernel"] = params["head"]["kernel"] * 8.0
    return params


@functools.lru_cache(maxsize=None)
def _drafter():
    cfg = tdlm.draft_config(VOCAB, SEQ)
    return tdlm.DraftLM(K, convert.to_jax(init_params(tdlm.draft_lm(cfg),
                                                      2))[0], cfg,
                        device="cpu")


def _engine(**kw):
    return SlotEngine(_params(), n_slots=2, device="cpu",
                      cache_dtype=torch.float32, **KW, **kw)


def _jengine(**kw):
    eng = jserve.SlotEngine(_params(), n_slots=2, mesh=None,
                            cache_dtype=jnp.float32, **KW, **kw)
    eng.warmup(4)
    return eng


PROMPT = (3, 1, 4, 1, 5, 9, 2)


def _finish(eng, slot, spec=False) -> list:
    """Decode `slot` to its end, by verify when `spec` and the learned
    drafter proposes, else by windows of 4; its tokens."""
    out = []
    while eng._occupied[slot] and eng._rem_h[slot] > 0:
        r = eng.propose_all() if spec else None
        if r is None:
            out += eng.step_window(4).get(slot, [])
        else:
            eng.begin_verify(*r)
            out += eng.collect()[slot]
    eng.release(slot)
    return out


def _moved(make, admit, spec=False):
    """The request admitted into slot 1 of one engine, one window there,
    exported and imported into slot 0 of another: its tokens; and the
    same request unmigrated on a third engine."""
    src, dst, ref = make(), make(), make()
    admit(src, 1)
    admit(ref, 1)
    mid = src.step_window(4)[1]
    snap = src.export_slot(1)
    src.release(1)
    dst.import_slot(0, snap)
    return mid + _finish(dst, 0, spec), _finish(ref, 1, spec), snap


@pytest.mark.parametrize("sampled", [False, True])
def test_migrated_slot_equals_the_unmigrated_run_bit_for_bit(sampled):
    """Greedy, and sampled (its generator's state in the snapshot):
    exported after one window, imported into another engine's other
    slot, the request's tokens equal the unmigrated run's bit for bit."""
    kw = dict(temperature=0.9, top_k=5) if sampled else {}
    got, want, snap = _moved(
        lambda: _engine(**kw),
        lambda eng, s: eng.admit(s, PROMPT, 14, rng=7 if sampled else None))
    assert got == want and len(got) == 14
    assert (snap["rng_state"] is None) != sampled
    assert snap["pos"] == len(PROMPT) + 4
    assert snap["caches"][0][0].shape == (1, snap["pos"], HEADS, E // HEADS)


def test_migration_carries_the_learned_drafter_state():
    """A spec-armed engine with the learned drafter: the snapshot carries
    the drafter's rows up to its frontier and its pending tokens, and the
    migrated request, proposing and verifying on the other engine,
    equals the unmigrated one bit for bit."""
    def make():
        return _engine(draft_k=K, draft_model=_drafter())

    got, want, snap = _moved(
        make, lambda eng, s: eng.admit(s, PROMPT, 14), spec=True)
    assert got == want and len(got) == 14
    assert snap["draft"]["front"] > 0 and snap["draft"]["pend"]


def test_a_jax_snapshot_resumes_in_the_port_under_the_contract():
    """The JAX engine's export_slot (greedy, its key data dropped) into
    the port's engine: the request finishes with the JAX engine's
    unmigrated tokens under the serving contract, along the port's
    serial run."""
    jsrc, jref = _jengine(), _jengine()
    for eng in (jsrc, jref):
        eng.admit(1, np.asarray(PROMPT, np.int32), 14)
    mid = jsrc.step_window(4)[1]
    snap = jsrc.export_slot(1)
    del snap["kd"]
    dst = _engine()
    dst.import_slot(0, snap)
    got = mid + _finish(dst, 0)
    want = []
    while jref._occupied[1] and jref._rem_h[1] > 0:
        want += jref.step_window(4).get(1, [])
    assert len(got) == len(want) == 14
    gen = tlm.Generator(_params(), device="cpu", cache_dtype=torch.float32,
                        **KW)
    logits, caches = gen.prefill([list(PROMPT)])
    held = 0
    for j, (g, w) in enumerate(zip(got, want)):
        top2 = logits[0].topk(2).values
        if float(top2[0] - top2[1]) < CONTRACT * float(logits[0].abs().max()):
            break
        assert g == w, (j, got, want)
        held += 1
        _, logits, caches = gen.decode(caches, logits, len(PROMPT) + j, 1)
    assert held >= 4


def _errors(make) -> list[str]:
    """The teaching errors of import_slot and export_slot, in order."""
    out = []

    def catch(fn):
        with pytest.raises((ValueError, RuntimeError)) as e:
            fn()
        out.append(str(e.value))

    prompt = np.asarray(PROMPT, np.int32)
    src = make()
    src.admit(0, prompt, 9)
    src.step_window(4)
    snap = src.export_slot(0)
    dst = make()
    dst.admit(1, prompt, 9)
    catch(lambda: dst.import_slot(1, snap))                   # not free
    catch(lambda: dst.import_slot(0, {**snap, "rem": 0}))     # no budget
    catch(lambda: dst.import_slot(0, {**snap, "rem": SEQ}))   # past t_max
    catch(lambda: dst.import_slot(0, {**snap, "num_heads": 4}))
    catch(lambda: dst.import_slot(0, {**snap, "caches": snap["caches"][:1]}))
    catch(lambda: make().export_slot(1))                      # not occupied
    return out


def test_teaching_errors_match_jax():
    """Not free, no budget, past t_max, a geometry mismatch, not occupied:
    the JAX engine's messages; the learned drafter present on one side
    only, both ways: JAX's messages too."""
    assert _errors(_engine) == _errors(_jengine)
    drafted = _engine(draft_k=K, draft_model=_drafter())
    plain = _engine()
    for eng in (drafted, plain):
        eng.admit(0, PROMPT, 9)
        eng.step_window(4)
    with pytest.raises(ValueError, match="no learned-drafter state"):
        _engine(draft_k=K, draft_model=_drafter()).import_slot(
            0, plain.export_slot(0))
    with pytest.raises(ValueError, match="no draft_model"):
        _engine().import_slot(0, drafted.export_slot(0))
    sampled = _engine(temperature=1.0)
    with pytest.raises(ValueError, match="no generator state"):
        sampled.import_slot(0, plain.export_slot(0))
    plain.begin_window(4)
    with pytest.raises(RuntimeError, match="quiesce"):
        plain.export_slot(0)
    with pytest.raises(RuntimeError, match="window in flight"):
        plain.import_slot(1, drafted.export_slot(0))
    plain.collect()


# -- the scheduler's drain API -------------------------------------------


def _journal_events(path):
    return [(r.get("event"), r.get("id"), r.get("status"),
             r.get("direction"))
            for r in map(json.loads, path.read_text().splitlines())]


def _protocol(make, cls, tmp: Path):
    """Two servers with journals; two requests mid-decode on the first,
    which quiesces and hands its running slots to the second (the
    router's part: the source's migrate-out and migrated finish once the
    import lands, the target's migrate-in). Returns the results and both
    journals' events."""
    src, dst = make(tmp / "src.jsonl"), make(tmp / "dst.jsonl")
    reqs = [cls(id=f"m{i}", prompt=PROMPT[:4 + i], max_new_tokens=12)
            for i in range(2)]
    for q in reqs:
        assert src.submit(q)
    src.step()                       # both admitted, a window in flight
    src.quiesce()
    moved = list(src.scheduler.running_ids())
    assert moved
    for rid in moved:
        entry, snap = src.scheduler.export_running(rid)
        dst.quiesce()
        assert dst.scheduler.import_running(entry, snap)
        src.journal.record_migrate(rid, "out", peer="dst")
        src.journal.record_finish(rid, "migrated")
        dst.journal.record_migrate(rid, "in", peer="src")
    src.drain()
    dst.drain()
    results = {r.id: (r.status, r.tokens)
               for r in src.results() + dst.results()}
    src.close()
    dst.close()
    return (results, moved, _journal_events(tmp / "src.jsonl"),
            _journal_events(tmp / "dst.jsonl"))


def test_export_and_import_running_hold_the_jax_journal_protocol(tmp_path):
    """The source's WAL keeps the submit open across the gap and closes
    it `migrated`; the target journals a normal submit, the migrate-in
    and the ok finish -- the JAX schedulers' records, event for event --
    and every moved request equals one that stayed, bit for bit."""
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    got, moved, src, dst = _protocol(
        lambda j: LMServer(_params(), n_slots=2, window=4, device="cpu",
                           cache_dtype=torch.float32, journal=j,
                           registry=MetricsRegistry(), **KW),
        Request, tmp_path / "p")
    want, jmoved, jsrc, jdst = _protocol(
        lambda j: jserve.LMServer(_params(), n_slots=2, window=4, mesh=None,
                                  cache_dtype=jnp.float32, journal=j,
                                  registry=jreg.MetricsRegistry(), **KW),
        jserve.Request, tmp_path / "j")
    assert moved == jmoved
    assert (src, dst) == (jsrc, jdst)
    for rid in moved:
        assert ("journal_migrate", rid, None, "out") in src
        assert ("journal_finish", rid, "migrated", None) in src
        assert ("journal_submit", rid, None, None) in dst
        assert ("journal_finish", rid, "ok", None) in dst
    stay = LMServer(_params(), n_slots=2, window=4, device="cpu",
                    cache_dtype=torch.float32, registry=MetricsRegistry(),
                    **KW)
    ref = stay.run([(0.0, Request(id=f"m{i}", prompt=PROMPT[:4 + i],
                                  max_new_tokens=12)) for i in range(2)])
    assert {r.id: (r.status, r.tokens) for r in ref} == got
    assert {k: v[0] for k, v in got.items()} == {
        k: v[0] for k, v in want.items()}


def test_drain_mode_pending_work_and_refusals():
    """begin_drain: a submit sheds (a terminal `shed` Result) and a peer
    import is refused without consuming anything; drain_pending hands
    back the queue and the chunked prefills in flight, each pending with
    no slot; a full scheduler refuses an import."""
    server = LMServer(_params(), n_slots=1, window=4, device="cpu",
                      cache_dtype=torch.float32, prefill_chunk=4,
                      registry=MetricsRegistry(), **KW)
    for i in range(3):
        assert server.submit(Request(id=f"d{i}", prompt=PROMPT,
                                     max_new_tokens=6))
    server.step()                    # d0 prefilling, d1 and d2 queued
    sch = server.scheduler
    assert sch.running_ids() == [] and sch._prefilling
    sch.begin_drain()
    assert sch.draining
    assert not server.submit(Request(id="late", prompt=(1, 2),
                                     max_new_tokens=2))
    assert server.poll("late").status == "shed"
    out = sch.drain_pending()
    assert [e.rid for e in out] == ["d1", "d2", "d0"]
    assert all(e.status == "pending" and e.slot is None for e in out)
    assert sch.idle() and server.engine.free_slots() == [0]
    other = LMServer(_params(), n_slots=1, window=4, device="cpu",
                     cache_dtype=torch.float32, registry=MetricsRegistry(),
                     **KW)
    assert other.submit(Request(id="x", prompt=PROMPT, max_new_tokens=9))
    other.step()
    other.quiesce()
    entry, snap = other.scheduler.export_running("x")
    assert not sch.import_running(entry, snap)          # draining
    full = LMServer(_params(), n_slots=1, window=4, device="cpu",
                    cache_dtype=torch.float32, registry=MetricsRegistry(),
                    **KW)
    assert full.submit(Request(id="y", prompt=PROMPT, max_new_tokens=9))
    full.step()
    full.quiesce()
    assert not full.scheduler.import_running(entry, snap)   # no free slot
    assert other.scheduler.import_running(entry, snap)      # back home
    other.drain()
    assert other.poll("x").status == "ok"
    with pytest.raises(ValueError, match="not running here"):
        other.scheduler.export_running("nobody")


# -- SIGTERM ---------------------------------------------------------------


def test_sigterm_handler_unwinds_to_drain():
    """The armed handler only marks the drain requested (the replay loop
    reads it between ticks, so the signal never lands inside one), and
    disarming restores the previous disposition."""
    drain = cli._DrainRequested()
    prev = cli._arm_sigterm(drain)
    try:
        assert not drain()
        os.kill(os.getpid(), signal.SIGTERM)
        assert drain()
    finally:
        cli._disarm_sigterm(prev)
    assert signal.getsignal(signal.SIGTERM) == (
        prev if prev is not None else signal.SIG_DFL)


def test_stop_drains_every_accepted_request_ok():
    """`run(stop=...)` set between ticks with a window in flight: nothing
    more is offered, later submits are shed, and every request accepted
    before the stop finishes ok (a queue of one keeps the burst from
    being accepted whole before the first tick)."""
    server = LMServer(_params(), n_slots=2, window=4, device="cpu",
                      cache_dtype=torch.float32, registry=MetricsRegistry(),
                      max_queue_depth=1, **KW)
    trace = [(0.0, Request(id=f"r{i}", prompt=PROMPT, max_new_tokens=9))
             for i in range(6)]
    ticks = []
    orig = server.step

    def step():
        ticks.append(1)
        return orig()

    server.step = step
    res = server.run(trace, stop=lambda: len(ticks) >= 2)
    accepted = {r.id for r in res}
    assert accepted and len(accepted) < 6
    assert all(r.status == "ok" and len(r.tokens) == 9 for r in res)
    assert server.idle() and server.scheduler.draining
    assert not server.submit(Request(id="late", prompt=PROMPT,
                                     max_new_tokens=2))
    assert server.poll("late").status == "shed"


def _sigterm_verb(argv, wal, ready):
    """Run `serve --realtime --journal wal *argv` in a subprocess, send it
    SIGTERM once `ready(journal text)` holds, and return (rc, stdout,
    stderr, the journal's records)."""
    env = {**os.environ, "PYTHONUNBUFFERED": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "idc_models_tpu_torch", "serve", "--device",
         "cpu", "--requests", "200", "--rate", "20", "--realtime",
         "--journal", str(wal), *_VERB, *argv],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and proc.poll() is None:
            if wal.exists() and ready(wal.read_text()):
                break
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-2000:]
    assert f"SIGTERM: drained gracefully — admissions stopped, in-flight " \
           f"requests finished, journal flushed ({wal})" in out
    return out, [json.loads(ln) for ln in wal.read_text().splitlines()]


def _served_ok(out) -> int:
    line = next(ln for ln in out.splitlines() if ln.startswith("served: "))
    return int(line.split()[1].removeprefix("ok="))


_VERB = ["--slots", "2", "--window", "4", "--t-max", "32", "--vocab", "11",
         "--embed-dim", "16", "--num-heads", "2", "--mlp-dim", "32",
         "--num-blocks", "1"]


def test_serve_verb_drains_gracefully_on_sigterm(tmp_path):
    """`serve --realtime --journal` in a subprocess, sent SIGTERM once its
    journal holds progress: exit 0, the drain line naming the journal, and
    every submit the journal holds finished ok, as many as the verb's
    served ok count."""
    out, events = _sigterm_verb([], tmp_path / "wal.jsonl",
                                lambda text: '"journal_progress"' in text)
    submits = [r["id"] for r in events if r["event"] == "journal_submit"]
    finishes = {r["id"]: r["status"] for r in events
                if r["event"] == "journal_finish"}
    assert 0 < len(submits) < 200
    assert finishes == {rid: "ok" for rid in submits}
    assert _served_ok(out) == len(submits)


def test_serve_verb_drains_both_sides_of_an_open_canary(tmp_path, capsys):
    """SIGTERM while a rollout's canary is open: the live server's and
    the canary's accepted requests all finish ok, and the rollout settles
    (rolled back for want of evidence) and prints its verdict line. r5
    and r6 hash onto the canary at fraction 0.5 and r7 onto the live
    side, so the signal waits for r7's journaled submit."""
    ckpt = tmp_path / "candidate"
    assert cli.main(["serve", "--device", "cpu", "--requests", "2",
                     "--seed", "1", "--save-ckpt", str(ckpt),
                     *_VERB]) == 0
    assert "checkpoint: wrote" in capsys.readouterr().out
    out, events = _sigterm_verb(
        ["--rollout", str(ckpt), "--canary-fraction", "0.5",
         "--canary-requests", "1000", "--rollout-at", "0.0"],
        tmp_path / "wal.jsonl", lambda text: '"id": "r7"' in text)
    submits = [r["id"] for r in events if r["event"] == "journal_submit"]
    finishes = {r["id"]: r["status"] for r in events
                if r["event"] == "journal_finish"}
    assert "r7" in submits and not {"r5", "r6"} & set(submits)
    assert finishes == {rid: "ok" for rid in submits}
    verdict = [ln for ln in out.splitlines() if ln.startswith("rollout: ")]
    assert len(verdict) == 1 and verdict[0].startswith(
        "rollout: rolled_back after "), verdict
    canary = int(verdict[0].split()[3])
    assert canary >= 2 and "not enough evidence" in verdict[0]
    assert _served_ok(out) == len(submits) + canary
