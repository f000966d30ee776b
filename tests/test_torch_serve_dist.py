"""Serving over several ranks (``ring_decode``'s folds over a "seq" group,
`SlotEngine` and `LMServer` on a mesh and under partition rules, and the
`serve` and `profile --model serve` verbs over a CPU pod) against the
JAX package on the CPU. Four gloo ranks start once for the module from
`tests/_torch_serve_dist_worker.py` (torch and the port only), given the
JAX LM's weights (head sharpened, as ``tests/test_torch_serve.py`` does,
so greedy picks win by far more than the packages' rounding). The JAX
side runs here, on the conftest's virtual devices.

- The folds over rings of 2 and 4 ranks against JAX's on
  ``seq_mesh(2)`` / ``seq_mesh(4)``: outputs within 1e-5 of the largest
  |value| (one bf16 step, 2^-7, for the bf16 cache), caches equal; the
  same against the port's fold without a ring; and over a ring of one
  rank bit for bit what no ring gives.
- The servers on ``seq_mesh(4)``: greedy and paged tokens equal JAX's
  `LMServer` on ``seq_mesh(4)``; speculative servers (n-gram on the
  paged cache, the learned drafter, and the drafter under the
  "draft_lm" rules) keep the greedy tokens; sampled streams keep to the
  top-k support.
- Under the "lm" rules at tp 2 x seq 1 and tp 2 x seq 2: tokens equal
  the unsharded run's, the cache keeps every head (no "model" axis), and
  each rank holds fewer parameter bytes than the whole tree.
- Every rank makes rank 0's engine calls and emits its tokens, a run
  with rank 1's clock an hour off included.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idc_models_tpu import cli as jcli
from idc_models_tpu import mesh as jmeshlib
from idc_models_tpu import ring_decode as jrd
from idc_models_tpu import serve as jserve
from idc_models_tpu.models import lm as jlm
from idc_models_tpu.models.draft_lm import draft_config, draft_lm
from idc_models_tpu.serve.engine import SlotEngine as JSlotEngine
from idc_models_tpu_torch import cli, convert
from idc_models_tpu_torch import ring_decode as trd
from idc_models_tpu_torch.models import lm as tlm
from idc_models_tpu_torch.observe import MetricsRegistry
from idc_models_tpu_torch.serve import LMServer

import _torch_serve_dist_worker as worker

WORKER = Path(worker.__file__)
WORLD = worker.WORLD
DEADLINE_S = 240.0
KW = worker.KW
F32_TOL, BF16_TOL = 1e-5, 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _params():
    model = jlm.attention_lm(worker.VOCAB, worker.T_MAX,
                             embed_dim=worker.E, num_heads=worker.HEADS,
                             mlp_dim=worker.MLP, num_blocks=worker.BLOCKS)
    params = jax.tree.map(np.array, jax.device_get(
        model.init(jax.random.key(0)).params))
    params["head"]["kernel"] = params["head"]["kernel"] * 8.0
    return params


@functools.lru_cache(maxsize=None)
def _draft_params():
    cfg = draft_config(worker.VOCAB, worker.T_MAX, **worker.DRAFT)
    return jax.tree.map(np.array, jax.device_get(
        draft_lm(cfg).init(jax.random.key(1)).params))


class _Ranks:
    """The worker processes: started with the inputs written, waited
    for (all killed past the deadline or when one fails)."""

    def __init__(self, out: Path):
        self.out = out
        flat = {f"params/{k}": v
                for k, v in convert.flatten(_params()).items()}
        flat.update({f"draft/{k}": v
                     for k, v in convert.flatten(_draft_params()).items()})
        np.savez(out / "inputs.npz", **flat)
        env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
        self.logs = [open(out / f"log.{r}", "w") for r in range(WORLD)]
        self.procs = [subprocess.Popen(
            [sys.executable, str(WORKER), str(out / "store"), str(WORLD),
             str(r), str(out)], stdout=log, stderr=subprocess.STDOUT,
            env=env) for r, log in enumerate(self.logs)]
        self.started = time.monotonic()

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait(timeout=30)
        for log in self.logs:
            if not log.closed:
                log.close()

    def wait(self):
        while any(p.poll() is None for p in self.procs):
            failed = any(p.poll() not in (None, 0) for p in self.procs)
            if failed or time.monotonic() - self.started > DEADLINE_S:
                break
            time.sleep(0.1)
        self.kill()
        codes = [p.returncode for p in self.procs]
        if codes != [0] * WORLD:
            logs = "\n".join(f"--- rank {r}:\n"
                             + (self.out / f"log.{r}").read_text()[-3000:]
                             for r in range(WORLD))
            pytest.fail(f"serving ranks ended with {codes}\n{logs}")
        return (dict(np.load(self.out / "results.npz")),
                [json.loads((self.out / f"rank{r}.json").read_text())
                 for r in range(WORLD)])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    run = _Ranks(tmp_path_factory.mktemp("serve_ranks"))
    try:
        yield run.wait()
    finally:
        run.kill()


# ---------------------------------------------------------------------------
# the folds
# ---------------------------------------------------------------------------

FOLDS = list(worker.fold_cases(worker.fold_inputs()))


@functools.lru_cache(maxsize=None)
def _jax_fold(name: str, n: int):
    """JAX's fold `name` on seq_mesh(n) over the worker's inputs: the
    output, then the whole caches (pools) and any scales."""
    x = worker.fold_inputs()
    mesh = jmeshlib.seq_mesh(n)
    np_pages = worker.N_PAGES
    j = {k: jnp.asarray(v) for k, v in x.items()}
    if name.startswith("decode"):
        dtype = jnp.bfloat16 if name.endswith("bf16") else jnp.float32
        kc, vc = jrd.init_cache(mesh, worker.FB, worker.FT, worker.FH,
                                worker.FD, dtype=dtype)
        step = jrd.make_ring_decode(mesh)
        outs = []
        for p in range(6):
            sl = slice(p, p + 1)
            o, kc, vc = step(kc, vc, j["q6"][:, sl].astype(dtype),
                             j["k6"][:, sl].astype(dtype),
                             j["v6"][:, sl].astype(dtype), p)
            outs.append(o)
        return [jnp.concatenate(outs, 1), kc, vc]
    q8 = name.endswith("int8")
    if name.startswith("batched_chunk"):
        kc, vc = (j["kc8"], j["vc8"]) if q8 else (j["kc"], j["vc"])
        sc = (j["ks"], j["vs"]) if q8 else ()
        return list(jrd.make_batched_chunk_ring_decode(
            mesh, quantized=q8, jit=True)(
            kc, vc, j["q3"], j["k3"], j["v3"], j["cpos"], j["live"], *sc))
    if name.startswith("batched"):
        kc, vc = (j["kc8"], j["vc8"]) if q8 else (j["kc"], j["vc"])
        sc = (j["ks"], j["vs"]) if q8 else ()
        return list(jrd.make_batched_ring_decode(
            mesh, quantized=q8, jit=True)(
            kc, vc, j["q1"], j["k1"], j["v1"], j["pos"], j["live"], *sc))
    if name == "chunk":
        b = (worker.FB,) + x["q8"].shape[1:]
        return list(jrd.make_chunk_ring_decode(mesh, jit=True)(
            j["kc"], j["vc"], jnp.broadcast_to(j["q8"], b),
            jnp.broadcast_to(j["k8"], b), jnp.broadcast_to(j["v8"], b),
            4, 10))
    kp, vp = (j["kp8"], j["vp8"]) if q8 else (j["kp"], j["vp"])
    kp, vp = kp[:np_pages], vp[:np_pages]
    sc = (j["pks"][:np_pages], j["pvs"][:np_pages]) if q8 else ()
    if name.startswith("paged_batched_chunk"):
        return list(jrd.make_paged_batched_chunk_ring_decode(
            mesh, page_size=worker.PAGE, jit=True)(
            kp, vp, j["pt"], j["q3"][:, :2], j["k3"][:, :2],
            j["v3"][:, :2], j["ppos"], j["plive"]))
    if name.startswith("paged_batched"):
        return list(jrd.make_paged_batched_ring_decode(
            mesh, page_size=worker.PAGE, quantized=q8, jit=True)(
            kp, vp, j["pt"], j["q1"], j["k1"], j["v1"], j["ppos"],
            j["plive"], *sc))
    return list(jrd.make_paged_chunk_ring_decode(
        mesh, page_size=worker.PAGE, quantized=q8, jit=True)(
        kp, vp, j["pt"][1:2], j["q8"], j["k8"], j["v8"], 0, 6, *sc))


@functools.lru_cache(maxsize=None)
def _port_fold(name: str):
    """The port's fold `name` without a ring, whole caches, here."""
    x = worker.fold_inputs()
    outs = worker._sharded(
        lambda s, p: worker.fold_cases(x)[name](s, p, None), x, 1, 0)
    if name in worker.PAGED:
        outs = [outs[0], outs[1][:-1], outs[2][:-1], *outs[3:]]
    return [a.float().numpy() for a in outs]


def _close(got, want, name):
    tol = BF16_TOL if name.endswith("bf16") else F32_TOL
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got[0], want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


@pytest.mark.parametrize("n", worker.FOLD_RINGS)
@pytest.mark.parametrize("name", FOLDS)
def test_fold_over_a_ring_matches_jax(ranks, name, n):
    results = ranks[0]
    got = [results[f"fold{n}/{name}/{j}"]
           for j in range(len(_port_fold(name)))]
    want = [np.asarray(jnp.asarray(a, jnp.float32))
            for a in _jax_fold(name, n)]
    _close(got, want[0], name)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g[:len(w)], w)


@pytest.mark.parametrize("n", worker.FOLD_RINGS)
@pytest.mark.parametrize("name", FOLDS)
def test_fold_over_a_ring_matches_the_port_fold_without_one(ranks, name, n):
    results = ranks[0]
    want = _port_fold(name)
    got = [results[f"fold{n}/{name}/{j}"] for j in range(len(want))]
    _close(got, want[0], name)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", FOLDS)
def test_fold_over_a_ring_of_one_rank_is_bit_equal(ranks, name):
    assert float(ranks[0][f"ws1/{name}"]) == 1.0


def test_cache_takes_the_ring_and_refuses_an_uneven_one():
    with pytest.raises(ValueError, match="not divisible by the ring"):
        trd._check_ring(30, 4)
    spec = trd.cache_sharding(_FakeMesh()).spec
    assert "model" not in [a for e in spec if e for a in
                           (e if isinstance(e, tuple) else (e,))]


class _FakeMesh:
    """A ("model", "seq") layout's names, for the spec alone."""

    axis_names = ("model", "seq")


# ---------------------------------------------------------------------------
# the servers
# ---------------------------------------------------------------------------

CASES = ["seq4", "seq4_sampled", "seq4_paged", "seq4_int8", "seq4_prefix",
         "seq4_spec", "seq4_learned",
         "tp2", "tp2seq2", "tp2seq2_paged", "tp2seq2_learned", "skew"]
PAGED = worker.PAGED_KW


@functools.lru_cache(maxsize=None)
def _jax_served(paged: bool):
    server = jserve.LMServer(_params(), n_slots=3, window=4,
                             mesh=jmeshlib.seq_mesh(4),
                             cache_dtype=jnp.float32,
                             **(PAGED if paged else {}), **KW)
    trace = jserve.poisson_trace(6, rate_per_s=50.0, vocab=worker.VOCAB,
                                 t_max=worker.T_MAX, prompt_lens=(2, 16),
                                 budgets=(2, 16), seed=3)
    server.run(trace)
    return {r.id: server.poll(r.id).tokens for _, r in trace}


@functools.lru_cache(maxsize=None)
def _port_served(paged: bool):
    """The port's server without a mesh: the unsharded run."""
    server = LMServer(_params(), n_slots=3, window=4, device="cpu",
                      cache_dtype=torch.float32,
                      registry=MetricsRegistry(),
                      **(PAGED if paged else {}), **KW)
    server.run(worker.trace())
    return {r.id: server.poll(r.id).tokens for _, r in worker.trace()}


@functools.lru_cache(maxsize=None)
def _serial_margins_hold():
    """Every serial greedy pick of the trace wins by more than 1e-3."""
    gen = tlm.Generator(_params(), device="cpu", cache_dtype=torch.float32,
                        **KW)
    for _, r in worker.trace():
        logits, caches = gen.prefill([list(r.prompt)])
        for i in range(r.max_new_tokens):
            top2 = logits[0].topk(2).values
            if float(top2[0] - top2[1]) <= 1e-3:
                return False
            _, logits, caches = gen.decode(caches, logits,
                                           len(r.prompt) + i, 1)
    return True


@pytest.mark.parametrize("case,paged", [("seq4", False),
                                        ("seq4_paged", True)])
def test_ring_server_matches_the_jax_lmserver_on_seq_mesh_4(ranks, case,
                                                           paged):
    assert _serial_margins_hold()
    got = ranks[1][0][case]
    assert set(got["status"].values()) == {"ok"}
    assert got["tokens"] == _jax_served(paged)


@pytest.mark.parametrize("case", ["seq4_spec", "seq4_learned",
                                  "tp2seq2_learned"])
def test_speculation_on_the_ring_keeps_the_greedy_tokens(ranks, case):
    got = ranks[1][0][case]
    assert set(got["status"].values()) == {"ok"}
    assert got["tokens"] == _jax_served(False)
    # the verify really ran: each admission's chain went through it
    assert any("begin_verify" in c for c in got["calls"])


def test_sampled_streams_keep_the_top_k_support(ranks):
    """Only the support is held (the draws' stream is torch's): each
    emitted token is among the serial run's top 4 at its step, fed the
    same stream."""
    gen = tlm.Generator(_params(), device="cpu", cache_dtype=torch.float32,
                        **KW)
    got = ranks[1][0]["seq4_sampled"]
    for r in worker.sampled_requests():
        toks = got["tokens"][r.id]
        assert got["status"][r.id] == "ok" and len(toks) == 6
        logits, caches = gen.prefill([list(r.prompt)])
        for i, t in enumerate(toks):
            assert t in logits[0].topk(4).indices.tolist(), (r.id, i)
            _, logits, caches = gen.decode(
                caches, torch.nn.functional.one_hot(
                    torch.tensor([t]), worker.VOCAB).float() * 1e9,
                len(r.prompt) + i, 1)


@functools.lru_cache(maxsize=None)
def _port_alone(case: str):
    """The port's server without a mesh on a worker case's requests and
    knobs: the unsharded run of that case."""
    kw = {"seq4_int8": dict(n_slots=3, kv_dtype="int8"),
          "seq4_prefix": dict(n_slots=2, prefill_chunk=8,
                              prefix_cache_mb=1.0)}[case]
    reqs = (worker.prefix_requests() if case == "seq4_prefix"
            else [r for _, r in worker.trace()])
    server = LMServer(_params(), window=4, device="cpu",
                      cache_dtype=torch.float32, registry=MetricsRegistry(),
                      **kw, **KW)
    server.run([(0.0, r) for r in reqs])
    return ({r.id: server.poll(r.id).tokens for r in reqs},
            server.summary().get("serve_prefix_hits"))


@pytest.mark.parametrize("case", ["seq4_int8", "seq4_prefix"])
def test_int8_and_prefix_cache_on_the_ring_equal_one_rank(ranks, case):
    """The int8 engine (one scale a row and head across the shards) and
    the chunked engine's prefix cache (snapshots of each shard, every
    rank budgeting one size) on seq 4: the one-rank server's tokens, and
    the same prefix hits."""
    got = ranks[1][0][case]
    want, hits = _port_alone(case)
    assert set(got["status"].values()) == {"ok"}
    assert got["tokens"] == want
    assert got["prefix_hits"] == hits
    if case == "seq4_prefix":
        assert hits > 0


@functools.lru_cache(maxsize=None)
def _jax_alone(case: str):
    """The JAX `LMServer` on seq_mesh(4) on a worker case's requests and
    knobs."""
    kw = {"seq4_int8": dict(n_slots=3, kv_dtype="int8"),
          "seq4_prefix": dict(n_slots=2, prefill_chunk=8,
                              prefix_cache_mb=1.0)}[case]
    reqs = (worker.prefix_requests() if case == "seq4_prefix"
            else [r for _, r in worker.trace()])
    server = jserve.LMServer(_params(), window=4, mesh=jmeshlib.seq_mesh(4),
                             cache_dtype=jnp.float32, **kw, **KW)
    server.run([(0.0, jserve.Request(id=r.id, prompt=r.prompt,
                                     max_new_tokens=r.max_new_tokens))
                for r in reqs])
    return ({r.id: server.poll(r.id).tokens for r in reqs},
            server.summary().get("serve_prefix_hits"))


@pytest.mark.parametrize("case", ["seq4_int8", "seq4_prefix"])
def test_int8_and_prefix_cache_on_the_ring_match_the_jax_lmserver(ranks,
                                                                 case):
    """The int8 engine's scales stamped across the shards and the prefix
    snapshots cut per shard, against the JAX `LMServer` on seq_mesh(4)
    with the same knobs: the same greedy tokens and prefix hits."""
    got = ranks[1][0][case]
    want, hits = _jax_alone(case)
    assert set(got["status"].values()) == {"ok"}
    assert got["tokens"] == want
    assert got["prefix_hits"] == hits


@pytest.mark.parametrize("case,paged", [("tp2", False), ("tp2seq2", False),
                                        ("tp2seq2_paged", True)])
def test_tensor_parallel_tokens_equal_the_unsharded_run(ranks, case, paged):
    got = ranks[1][0][case]
    assert got["tokens"] == _port_served(paged)
    assert got["tokens"] == _jax_served(paged)


@pytest.mark.parametrize("case,seq", [("tp2", 1), ("tp2seq2", 2),
                                      ("tp2seq2_learned", 2)])
def test_tensor_parallel_cache_keeps_every_head(ranks, case, seq):
    """The cache never takes the "model" axis: every rank holds all the
    heads of its ring shard."""
    for r in ranks[1]:
        if case in r:
            assert r[case]["layout"]["kv_shape"] == [
                3, worker.T_MAX // seq, worker.HEADS,
                worker.E // worker.HEADS]


@pytest.mark.parametrize("case", ["tp2", "tp2seq2", "tp2seq2_paged"])
def test_tensor_parallel_rank_holds_fewer_parameter_bytes(ranks, case):
    for r in ranks[1]:
        if case in r:
            lay = r[case]["layout"]
            assert lay["param_bytes"] < lay["whole_param_bytes"]


@pytest.mark.parametrize("case", [c for c in CASES if c != "skew"])
def test_spot_check_and_swap_run_on_every_layout(ranks, case):
    """The rollout's hooks on a sharded engine: the whole candidate tree
    cut to each rank's blocks, a spot-check of it healthy (code 0) and a
    swap in place, every rank alike."""
    assert {r[case]["spot_check"] for r in ranks[1] if case in r} == {0}


def test_seq_ring_rank_holds_a_quarter_of_the_cache(ranks):
    lay = ranks[1][0]["seq4"]["layout"]
    assert lay["kv_shape"] == [3, worker.T_MAX // 4, worker.HEADS,
                               worker.E // worker.HEADS]
    assert lay["param_bytes"] == lay["whole_param_bytes"]


def test_distillation_under_rules_stores_blocks_and_keeps_the_losses(
        ranks):
    """`distill_draft_lm(rules=)` data-parallel over 4 ranks: the
    "draft_lm" rules store each rank's block of the student (FSDP over
    "data"), the losses equal the unruled run's and fall, every rank
    alike."""
    got = [r["distill"] for r in ranks[1]]
    assert all(g == got[0] for g in got)
    ruled, plain = got[0]["rules"], got[0]["plain"]
    np.testing.assert_allclose(ruled["loss"], plain["loss"], rtol=1e-5)
    assert ruled["loss"][-1] < ruled["loss"][0]
    assert ruled["param_bytes"] < ruled["whole_param_bytes"]


@pytest.mark.parametrize("case", ["model", "data", "pages"])
def test_a_refused_serving_mesh_teaches_as_jax_does(ranks, case):
    """A "model" axis without partition rules, a "data" axis (requests
    prefill one at a time) and a page pool the ring does not divide are
    refused with the JAX engine's messages."""
    mesh, kw = {"model": (jmeshlib.fsdp_tp_mesh(1, 2, 1), {}),
                "data": (jmeshlib.data_seq_mesh(2, 2), {}),
                "pages": (jmeshlib.seq_mesh(4), dict(
                    prefill_chunk=8, kv_page_size=8, kv_pages=18))}[case]
    with pytest.raises(ValueError) as e:
        JSlotEngine(_params(), mesh=mesh, **kw, **KW)
    assert ranks[1][0]["teaching"][case] == str(e.value)


@pytest.mark.parametrize("case", CASES)
def test_every_rank_makes_rank_zeros_calls(ranks, case):
    """The lockstep contract: each rank's engine saw rank 0's calls, in
    rank 0's order, and emitted rank 0's tokens and statuses."""
    served = [r[case] for r in ranks[1] if case in r]
    assert len(served) == (2 if case == "tp2" else WORLD)
    assert served[0]["calls"]
    for other in served[1:]:
        assert other["calls"] == served[0]["calls"]
        assert other["tokens"] == served[0]["tokens"]
        assert other["status"] == served[0]["status"]


def test_skewed_clock_run_decides_deadlines_and_sheds_on_rank_zeros_clock(
        ranks):
    """Rank 1's clock reads an hour ahead: were it deciding, every
    deadline there would have passed at submit. The run timed requests
    out and shed under the brownout, and every rank agrees on which."""
    got = [r["skew"] for r in ranks[1]]
    statuses = set(got[0]["status"].values())
    assert "ok" in statuses and statuses & {"timeout", "shed"}
    assert got[0]["brownout_max_stage"] >= 1
    assert all(g["status"] == got[0]["status"] for g in got)


# ---------------------------------------------------------------------------
# the verbs
# ---------------------------------------------------------------------------


def _lines(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue().splitlines()


SERVE = ["serve", "--requests", "5", "--slots", "2", "--window", "4",
         "--t-max", "32"]


@pytest.mark.parametrize("mesh_argv", [
    ["--seq-parallel", "4"], ["--tp", "2", "--seq-parallel", "2"]],
    ids=["seq4", "tp2seq2"])
def test_serve_verb_over_a_pod_prints_the_jax_lines(mesh_argv,
                                                    monkeypatch):
    # a thread a rank: the pod shares the host with the other workers
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rc, lines = _lines(cli.main, [*SERVE, "--device", "cpu",
                                  "--host-devices", "4", *mesh_argv])
    assert rc == 0
    _, jlines = _lines(jcli.main, [*SERVE, "--host-devices", "4",
                                   *mesh_argv])
    for prefix in ("serving 5 requests", "serving mesh: "):
        assert ([ln for ln in lines if ln.startswith(prefix)]
                == [ln for ln in jlines if ln.startswith(prefix)]), prefix
    served = [ln for ln in lines if ln.startswith("served: ")]
    want = [ln for ln in jlines if ln.startswith("served: ")]
    assert served and served[0].split(" tokens=")[0] == \
        want[0].split(" tokens=")[0]


def test_profile_serve_over_two_ranks_runs(capsys, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    assert cli.main(["profile", "--model", "serve", "--device", "cpu",
                     "--host-devices", "2", "--steps", "2"]) == 0
    out = capsys.readouterr().out
    assert "profile: serve decode loop" in out
    assert "paged:" in out


@pytest.mark.parametrize("argv,match", [
    (["--seq-parallel", "2"], "--seq-parallel 2 needs at least that many "
                              "devices \\(1 available\\)"),
    (["--host-devices", "2", "--seq-parallel", "2", "--t-max", "33"],
     "--t-max 33 must divide by --seq-parallel 2"),
    (["--tp", "2"], "--tp 2 x --seq-parallel 1 needs 2 devices, have 1"),
])
def test_serve_verb_refusals_carry_the_jax_messages(argv, match,
                                                    monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    with pytest.raises(SystemExit, match=match):
        cli.main(["serve", "--device", "cpu", *argv])
