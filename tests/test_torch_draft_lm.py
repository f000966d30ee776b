"""The port's learned drafter (idc_models_tpu_torch/models/draft_lm.py)
across its arc, on the CPU, against the JAX package's
(idc_models_tpu/models/draft_lm.py) on the same numpy inputs and
weights: the KL loss, the target's greedy streams and teacher logits,
distillation through ``train/loop.fit``, the sidecar checkpoint in both
directions (a JAX-saved drafter proposes the JAX drafter's tokens in the
port), the host `propose` against the engine's batched `propose_all`,
learned and chained drafters serving under the engine-against-serial
contract, the teaching errors, and `serve --spec-decode --drafter
chained --draft-ckpt` through `cli.main` with its usage gates, as
tests/test_draft_lm.py and tests/test_cli_e2e.py:378 hold them."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idc_models_tpu.models import draft_lm as jdlm
from idc_models_tpu.models import lm as jlm
from idc_models_tpu_torch import cli, convert
from idc_models_tpu_torch.checkpoint import restore_sharded
from idc_models_tpu_torch.models import draft_lm as tdlm
from idc_models_tpu_torch.models import lm as tlm
from idc_models_tpu_torch.models.core import init_params
from idc_models_tpu_torch.models.draft import ChainedDrafter, NGramDrafter
from idc_models_tpu_torch.observe import MetricsRegistry
from idc_models_tpu_torch.serve import (
    AdapterBank, LMServer, Request, SlotEngine,
)

VOCAB, SEQ, E, HEADS, MLP, BLOCKS = 11, 32, 32, 2, 64, 2
K = 3
KW = dict(embed_dim=E, num_heads=HEADS, num_blocks=BLOCKS, t_max=SEQ,
          device="cpu", cache_dtype=torch.float32)
F32_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share a few cores: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(module, seed):
    """A JAX-shaped weight tree (the port's seeded init: quicker than the
    JAX package's on the CPU), the head sharpened so greedy picks win by
    more than the two packages' rounding."""
    params = convert.to_jax(init_params(module, seed))[0]
    params["head"]["kernel"] = params["head"]["kernel"] * 8.0
    return params


@functools.lru_cache(maxsize=None)
def _target():
    """The JAX target LM and its weights (seed 0)."""
    model = jlm.attention_lm(VOCAB, SEQ, embed_dim=E, num_heads=HEADS,
                             mlp_dim=MLP, num_blocks=BLOCKS)
    return model, _tree(tlm.AttentionLM(VOCAB, SEQ, embed_dim=E,
                                        num_heads=HEADS, mlp_dim=MLP,
                                        num_blocks=BLOCKS), 0)


@functools.lru_cache(maxsize=None)
def _jdrafter():
    """A JAX DraftLM (untrained, seed 1)."""
    cfg = jdlm.draft_config(VOCAB, SEQ)
    return jdlm.DraftLM(K, _tree(tdlm.draft_lm(cfg), 1), cfg)


def _port_target():
    _, params = _target()
    model = tlm.AttentionLM(VOCAB, SEQ, embed_dim=E, num_heads=HEADS,
                            mlp_dim=MLP, num_blocks=BLOCKS)
    return convert.load_jax(model, params)


def test_distill_kl_loss_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 7, VOCAB)).astype(np.float32) * 3
    labels = rng.normal(size=(3, 7, VOCAB)).astype(np.float32) * 3
    got = float(tdlm.distill_kl_loss(torch.from_numpy(logits),
                                     torch.from_numpy(labels)))
    want = float(jdlm.distill_kl_loss(jnp.asarray(logits),
                                      jnp.asarray(labels)))
    assert abs(got - want) <= 1e-6 * max(abs(want), 1.0)
    assert float(tdlm.distill_kl_loss(torch.from_numpy(labels),
                                      torch.from_numpy(labels))) < 1e-6


def test_streams_logits_and_distillation_through_fit():
    """The target's greedy streams equal the JAX package's, its teacher
    logits within f32 rounding; distillation starts at the KL the JAX
    package computes for the student's initial weights (the first
    epoch's one step scores them) and the KL falls over the epochs."""
    jmodel, params = _target()
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, VOCAB, (8, 3))
    variables = type("V", (), {"params": params, "state": {}})
    want = jdlm.greedy_streams(jmodel, variables, prompts, SEQ)
    target = _port_target()
    streams = tdlm.greedy_streams(target, prompts, SEQ)
    assert streams.shape == (8, SEQ) and np.array_equal(streams, want)
    jlabels = jdlm.teacher_logits(jmodel, variables, streams, batch_size=4)
    labels = tdlm.teacher_logits(target, streams, batch_size=4)
    assert np.abs(labels - jlabels).max() <= F32_TOL * np.abs(
        jlabels).max()
    cfg = jdlm.draft_config(VOCAB, SEQ, embed_dim=16, mlp_dim=32,
                            num_blocks=1)
    student0 = jdlm.draft_lm(cfg)
    init = convert.to_jax(init_params(tdlm.draft_lm(cfg), 4))[0]
    jlogits = jax.jit(lambda p, x: student0.apply(p, {}, x, train=False)[0])(
        init, jnp.asarray(streams))
    kl0 = float(jdlm.distill_kl_loss(jlogits, jnp.asarray(jlabels)))
    student, state, history = tdlm.distill_draft_lm(
        target, streams, config=cfg, epochs=3, batch_size=8, lr=1e-2,
        seed=4)
    assert abs(history["loss"][0] - kl0) <= 1e-5 * kl0
    assert history["loss"][-1] < history["loss"][0]
    assert state.step == 3
    assert isinstance(student, tlm.AttentionLM)


def test_jax_saved_drafter_restores_and_proposes_the_same_tokens(tmp_path):
    """A drafter saved by the JAX package restores in the port bit for bit
    with its config, and the port's DraftLM proposes the JAX DraftLM's
    tokens on every history; the port's save of it restores in the JAX
    package bit-equal; a bare sharded tree without the sidecar is
    refused."""
    jd = _jdrafter()
    jdlm.save_draft_lm(tmp_path / "j", jd.params, config=jd.config).wait()
    params, cfg = tdlm.load_draft_lm(tmp_path / "j")
    assert cfg == jd.config
    got, want = convert.flatten(params), convert.flatten(jd.params)
    assert sorted(got) == sorted(want)
    for name in want:
        assert np.array_equal(got[name], want[name]), name
    ours = tdlm.DraftLM(K, params, cfg, device="cpu")
    rng = np.random.default_rng(8)
    for n in (1, 2, 5, 9, 17, SEQ - 1, SEQ + 6):
        hist = rng.integers(0, VOCAB, n)
        assert np.array_equal(ours.propose(hist), jd.propose(hist)), n
    assert ours.propose([]) is None
    tdlm.save_draft_lm(tmp_path / "t", ours.params, config=cfg).wait()
    back, bcfg = jdlm.load_draft_lm(tmp_path / "t")
    assert bcfg == cfg
    back = convert.flatten(jax.device_get(back))
    for name in want:
        assert np.array_equal(np.asarray(back[name]), want[name]), name
    from idc_models_tpu_torch.checkpoint import save_sharded

    save_sharded(tmp_path / "bare", params)
    with pytest.raises(FileNotFoundError, match="draft_config.json"):
        tdlm.load_draft_lm(tmp_path / "bare")


def _engine(drafter, n_slots=2, **kw):
    return SlotEngine(_target()[1], n_slots=n_slots, draft_k=K,
                      draft_model=drafter, **KW, **kw)


def test_host_propose_equals_propose_all_across_a_restore(tmp_path):
    """On the same streams the engine's batched `propose_all` (the
    drafter's prefill, chunk ingests of the backlog and K greedy steps
    over its caches) gives the host `propose`'s drafts, for a fresh
    admission, after a window of 6 tokens (a backlog wider than C = 4:
    one ingest round first), after a release and re-admission into the
    same slot, and through a port save / load of the drafter."""
    jd = _jdrafter()
    tdlm.save_draft_lm(tmp_path / "d", jd.params, config=jd.config)
    for drafter in (tdlm.DraftLM(K, jd.params, jd.config, device="cpu"),
                    tdlm.DraftLM(K, *tdlm.load_draft_lm(tmp_path / "d"),
                                 device="cpu")):
        eng = _engine(drafter)
        prompts = [(1, 2, 3, 4, 5), (7, 3)]
        hist = {}
        for s, p in enumerate(prompts):
            eng.admit(s, p, 12)
            hist[s] = list(p)
        for step in range(3):
            drafts, live = eng.propose_all()
            assert live.all()
            for s in hist:
                assert np.array_equal(drafts[s], drafter.propose(
                    np.asarray(hist[s]))), (step, s)
            for s, row in eng.step_window(6 if step == 0 else 2).items():
                hist[s] += row
        eng.release(1)
        eng.admit(1, (4, 4, 9), 5)
        hist[1] = [4, 4, 9]
        drafts, live = eng.propose_all()
        assert np.array_equal(drafts[1], drafter.propose(np.asarray(hist[1])))
        assert np.array_equal(drafts[0], drafter.propose(np.asarray(hist[0])))


def _serial(prompt, steps):
    gen = tlm.Generator(_target()[1], **KW)
    logits, caches = gen.prefill([list(prompt)])
    toks, seen = [], []
    for i in range(steps):
        seen.append(logits[0].clone())
        tok, logits, caches = gen.decode(caches, logits, len(prompt) + i, 1)
        toks.append(int(tok[0, 0]))
    return toks, seen


@pytest.mark.parametrize("chained", [False, True], ids=["learned",
                                                         "chained"])
def test_learned_and_chained_drafters_serve_under_the_contract(chained):
    """An untrained learned drafter, alone and behind an n-gram lookup,
    serves 6 requests through 2 slots with recycling: every stream held
    to the serial Generator (tokens equal up to a near tie), speculation
    really verifying, and one `propose_all` a verify cycle."""
    learned = tdlm.DraftLM(K, _jdrafter().params, _jdrafter().config,
                           device="cpu")
    drafter = (ChainedDrafter(NGramDrafter(K, order=2), learned)
               if chained else learned)
    server = LMServer(_target()[1], n_slots=2, window=4, spec_decode=True,
                      draft_k=K, drafter=drafter,
                      registry=MetricsRegistry(), **KW)
    calls = []
    propose_all = server.engine.propose_all
    server.engine.propose_all = lambda: calls.append(1) or propose_all()
    rng = np.random.default_rng(11)
    reqs = [Request(id=f"l{i}", prompt=tuple(
        int(x) for x in rng.integers(0, VOCAB, 2 + 2 * i)),
        max_new_tokens=6 + i) for i in range(6)]
    server.run([(0.0, r) for r in reqs])
    for r in reqs:
        got = server.poll(r.id)
        assert got.status == "ok"
        want, seen = _serial(r.prompt, r.max_new_tokens)
        for j, (g, w) in enumerate(zip(got.tokens, want)):
            top2 = seen[j].topk(2).values
            if float(top2[0] - top2[1]) < F32_TOL * float(
                    seen[j].abs().max()):
                break
            assert g == w, (r.id, j)
    s = server.summary()
    assert s["serve_spec_verify_dispatches"] > 0
    assert len(calls) == s["serve_decode_dispatches"]
    assert s["serve_spec_propose_s"] is not None


def test_engine_and_drafter_construction_errors():
    """The teaching errors: a drafter of another vocab, a position table
    shorter than t_max, a draft model without draft_k, drafter partition
    rules without a drafter, drafter adapters (a later item),
    propose_all without a drafter, and a chain of two engine-backed
    drafters."""
    params = _target()[1]

    def drafter(vocab=VOCAB, seq=SEQ):
        cfg = tdlm.draft_config(vocab, seq)
        tree = convert.to_jax(init_params(tdlm.draft_lm(cfg), 2))[0]
        return tdlm.DraftLM(K, tree, cfg)

    with pytest.raises(ValueError, match="vocab 13 != target vocab 11"):
        _engine(drafter(vocab=13))
    with pytest.raises(ValueError, match="position table 16 < engine"):
        _engine(drafter(seq=16))
    with pytest.raises(ValueError, match="needs draft_k"):
        SlotEngine(params, draft_model=drafter(), **KW)
    with pytest.raises(ValueError, match="without draft_model"):
        SlotEngine(params, draft_k=K, draft_partition_rules=object(), **KW)
    # drafter heads: u [T, V, r] / v [T, r, V], and one T with the
    # engine's own tenant bank (both are gathered by the same ids)
    with pytest.raises(ValueError, match="drafter adapters must be"):
        tdlm.DraftLM(K, drafter().params, drafter().config,
                     adapters=(np.zeros((1, VOCAB, 2)),) * 2)
    heads = tdlm.DraftLM(K, drafter().params, drafter().config,
                         adapters=(np.zeros((1, VOCAB, 2)),
                                   np.zeros((1, 2, VOCAB))))
    bank = AdapterBank(u=np.zeros((2, VOCAB, 2), np.float32),
                       v=np.zeros((2, 2, VOCAB), np.float32), rank=2,
                       vocab=VOCAB)
    with pytest.raises(ValueError, match="2 tenants"):
        _engine(heads, adapter_bank=bank)
    with pytest.raises(RuntimeError, match="requires a learned drafter"):
        SlotEngine(params, draft_k=K, **KW).propose_all()
    with pytest.raises(ValueError, match="engine-backed"):
        ChainedDrafter(drafter(), drafter())
    with pytest.raises(ValueError, match="non-array leaf"):
        tdlm.save_draft_lm("unused", {"embed": "x"},
                           config=tdlm.draft_config(VOCAB, SEQ))
    with pytest.raises(ValueError, match="unknown draft_config"):
        tdlm.draft_config(VOCAB, SEQ, width=3)


DIMS = ["--device", "cpu", "--requests", "4", "--slots", "2", "--window",
        "4", "--t-max", "32", "--vocab", "11", "--embed-dim", "16",
        "--num-heads", "2", "--mlp-dim", "32", "--num-blocks", "1"]


@pytest.fixture(scope="module")
def draft_ckpt(tmp_path_factory):
    cfg = jdlm.draft_config(11, 32)
    ckpt = tmp_path_factory.mktemp("draft") / "draft_ckpt"
    jdlm.save_draft_lm(ckpt, convert.to_jax(init_params(
        tdlm.draft_lm(cfg), 5))[0], config=cfg).wait()
    return str(ckpt)


def test_serve_verb_chained_drafter_and_save_ckpt(draft_ckpt, tmp_path,
                                                  capsys):
    """`serve --spec-decode --drafter chained --draft-ckpt DIR --save-ckpt
    DIR2` from the product surface: the JAX-saved drafter loads, every
    request is ok, the speculative line names the drafter and its
    propose seconds, and DIR2 restores the served parameters bit for
    bit."""
    out = tmp_path / "served"
    assert cli.main(["serve", *DIMS, "--spec-decode", "--draft-k", "3",
                     "--drafter", "chained", "--draft-ckpt", draft_ckpt,
                     "--save-ckpt", str(out)]) == 0
    text = capsys.readouterr().out
    assert "served: ok=4" in text
    assert "speculative (chained): drafted=" in text and "propose_s=" in text
    served = init_params(tlm.AttentionLM(11, 32, embed_dim=16, num_heads=2,
                                         mlp_dim=32, num_blocks=1), 0)
    want = convert.flatten(convert.to_jax(served)[0])
    assert (f"checkpoint: wrote {len(want)} shard(s) / {len(want)} leaves "
            f"to {out}") in text
    got = convert.flatten(restore_sharded(out))
    assert sorted(got) == sorted(want)
    for name in want:
        assert np.array_equal(got[name], want[name]), name


@pytest.mark.parametrize("argv,match", [
    (["--spec-decode", "--draft-k", "3", "--drafter", "learned"],
     "needs --draft-ckpt"),
    (["--drafter", "learned", "--draft-ckpt", "CKPT"],
     "without --spec-decode"),
    (["--spec-decode", "--draft-k", "3", "--draft-ckpt", "CKPT"],
     "without a learned drafter"),
    (["--spec-decode", "--draft-k", "31"], "must be in \\[1, t_max - 2\\]"),
    (["--spec-decode", "--ngram-order", "0"], "must be >= 1"),
    (["--spec-decode", "--draft-k", "3", "--drafter", "learned",
      "--draft-ckpt", "CKPT", "--vocab", "13"], "13"),
], ids=["no-ckpt", "no-spec", "ckpt-with-ngram", "draft-k", "ngram-order",
        "vocab"])
def test_serve_verb_usage_gates(draft_ckpt, argv, match):
    """Each misfit dies as a teaching error before any device work; a
    vocab mismatch names both vocabs."""
    dims = list(DIMS)
    if "--vocab" in argv:
        dims[dims.index("--vocab") + 1] = argv[argv.index("--vocab") + 1]
        argv = argv[:argv.index("--vocab")]
    argv = [draft_ckpt if a == "CKPT" else a for a in argv]
    with pytest.raises(SystemExit, match=match) as err:
        cli.main(["serve", *dims, *argv])
    if "--vocab" in " ".join(dims) and dims[dims.index("--vocab") + 1] == \
            "13":
        assert "11-token vocab" in str(err.value)
