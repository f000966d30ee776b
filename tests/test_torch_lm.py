"""The port's causal LM (idc_models_tpu_torch/models/{attention,lm}.py,
ring_decode.py, the `lm` verb) against the JAX package's, on the CPU:
weights carried from JAX with `convert.load_jax`, the same numpy
batches through both, the JAX ring on a one-device "seq" mesh (its
pallas blocks interpret on the CPU) and the port's plain versions."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idc_models_tpu import mesh as meshlib
from idc_models_tpu import ring_decode as jdecode
from idc_models_tpu.models import lm as jlm
from idc_models_tpu.train import metrics as jmetrics
from idc_models_tpu.train import state as jstate
from idc_models_tpu.train import step as jstep
from idc_models_tpu_torch import cli, convert
from idc_models_tpu_torch import ring_decode as tdecode
from idc_models_tpu_torch.models import lm as tlm
from idc_models_tpu_torch.train import metrics as tmetrics
from idc_models_tpu_torch.train import state as tstate
from idc_models_tpu_torch.train import step as tstep

REPO = Path(__file__).resolve().parent.parent
VOCAB, SEQ, E, HEADS, MLP, BLOCKS = 16, 128, 32, 2, 64, 2
KW = dict(embed_dim=E, num_heads=HEADS, num_blocks=BLOCKS)


def _jax_params(seed, seq=SEQ):
    model = jlm.attention_lm(VOCAB, seq, embed_dim=E, num_heads=HEADS,
                             mlp_dim=MLP, num_blocks=BLOCKS)
    return jax.device_get(model.init(jax.random.key(seed)).params)


def _port_model(params, block_impl="jnp", seq=SEQ):
    model = tlm.AttentionLM(VOCAB, seq, embed_dim=E, num_heads=HEADS,
                            mlp_dim=MLP, num_blocks=BLOCKS,
                            block_impl=block_impl)
    return convert.load_jax(model, params)


def _tokens(n, seed, seq=SEQ):
    return np.random.default_rng(seed).integers(0, VOCAB, (n, seq))


def _flat(tree):
    return {k: np.asarray(v) for k, v in convert.flatten(tree).items()}


def test_load_jax_and_to_jax_round_trip_bit_for_bit():
    """An attention_lm tree loads into AttentionLM and into the Generator
    and comes back out of both with every leaf's bits and dtype."""
    params = _jax_params(0)
    model = _port_model(params)
    assert set(dict(model.named_parameters())) == {
        k.replace("/", ".") for k in _flat(params)}
    gen = tlm.Generator(params, t_max=SEQ, device="cpu", **KW)
    for back in (convert.to_jax(model)[0], convert.to_jax(gen._model)[0]):
        got, want = _flat(back), _flat(params)
        assert got.keys() == want.keys()
        for k, w in want.items():
            assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k


@pytest.mark.parametrize("block_impl", ["jnp", "pallas"])
def test_logits_loss_and_gradients_match_attention_lm(block_impl):
    """Logits (1e-5), next_token_loss and every parameter's gradient
    (1e-4) against attention_lm on the same weights, both block impls."""
    params = _jax_params(1)
    toks = _tokens(2, 2)
    jmodel = jlm.attention_lm(VOCAB, SEQ, embed_dim=E, num_heads=HEADS,
                              mlp_dim=MLP, num_blocks=BLOCKS,
                              mesh=meshlib.seq_mesh(1),
                              block_impl=block_impl)
    jt = jnp.asarray(toks, jnp.int32)

    def jloss(p):
        logits, _ = jmodel.apply(p, {}, jt)
        return jlm.next_token_loss(logits, jt), logits

    (want_loss, want_logits), want_grads = jax.value_and_grad(
        jloss, has_aux=True)(params)
    model = _port_model(params, block_impl)
    logits = model(torch.from_numpy(toks))
    loss = tlm.next_token_loss(logits, torch.from_numpy(toks))
    loss.backward()
    np.testing.assert_allclose(logits.detach(), want_logits, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got_grads = {k: p.grad for k, p in model.named_parameters()}
    for k, w in _flat(want_grads).items():
        np.testing.assert_allclose(got_grads[k.replace("/", ".")], w,
                                   rtol=1e-4, atol=1e-4, err_msg=k)


def test_three_rmsprop_steps_match_jax():
    """Three Keras-RMSprop train steps (lr 3e-3) of the counting task from
    the same weights and batches give the same parameters within 1e-4."""
    params = _jax_params(3)
    jmodel = jlm.attention_lm(VOCAB, SEQ, embed_dim=E, num_heads=HEADS,
                              mlp_dim=MLP, num_blocks=BLOCKS,
                              mesh=meshlib.seq_mesh(1))
    opt = jstate.rmsprop(3e-3)
    state = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                              model_state={}, opt_state=opt.init(params))
    jstep_fn = jax.jit(jstep.make_train_step(jmodel, opt,
                                             jlm.next_token_loss))
    model = _port_model(params)
    tstep_fn = tstep.make_train_step(
        tstate.TrainState(model, tstate.rmsprop(model, 3e-3)),
        tlm.next_token_loss)
    rng = np.random.default_rng(4)
    for _ in range(3):
        seqs = (rng.integers(0, VOCAB, (4, 1)) + np.arange(SEQ)) % VOCAB
        state, jm = jstep_fn(state, jnp.asarray(seqs, jnp.int32),
                             jnp.asarray(seqs, jnp.int32), jax.random.key(0))
        tm = tstep_fn(torch.from_numpy(seqs), torch.from_numpy(seqs))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        assert float(tm["accuracy"]) == float(jm["accuracy"])
    got = _flat(convert.to_jax(model)[0])
    for k, w in _flat(jax.device_get(state.params)).items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_auto_accuracy_sequence_branches_match_jax():
    """[B, T, V] logits: shifted next-token accuracy against int labels,
    unshifted greedy agreement against soft labels; the classifier
    branches unchanged."""
    rng = np.random.default_rng(5)
    logits = rng.normal(0, 1, (3, 9, 6)).astype(np.float32)
    labels = rng.integers(0, 6, (3, 9))
    soft = rng.normal(0, 1, (3, 9, 6)).astype(np.float32)
    # make a few predictions right so the count is not trivially 0
    labels[:, 1:] = np.where(rng.random((3, 8)) < 0.5,
                             logits[:, :-1].argmax(-1), labels[:, 1:])
    for lab in (labels, soft):
        got = tmetrics.auto_accuracy(torch.from_numpy(logits),
                                     torch.from_numpy(lab))
        want = jmetrics.auto_accuracy(jnp.asarray(logits), jnp.asarray(lab))
        assert float(got) == pytest.approx(float(want), abs=1e-7)
        assert 0.0 < float(got) < 1.0
    two = rng.normal(0, 1, (5, 3)).astype(np.float32)
    lab2 = rng.integers(0, 3, 5)
    assert float(tmetrics.auto_accuracy(torch.from_numpy(two),
                                        torch.from_numpy(lab2))) == \
        pytest.approx(float(jmetrics.auto_accuracy(jnp.asarray(two),
                                                   jnp.asarray(lab2))))


def test_prefill_buckets_match_jax():
    for n_ring, t_max in ((1, 32), (1, 128), (4, 32), (4, 24), (3, 24),
                          (1, 32768)):
        assert tlm.prefill_buckets(t_max, n_ring) == \
            jlm.prefill_buckets(t_max, n_ring)
        for p in list(range(1, min(t_max, 300) + 1)) + [t_max]:
            assert tlm.prefill_bucket(p, t_max, n_ring) == \
                jlm.prefill_bucket(p, t_max, n_ring)
    for bad in (0, 33):
        with pytest.raises(ValueError, match="outside"):
            tlm.prefill_bucket(bad, 32, 1)


@pytest.mark.parametrize("pos", [0, 37, 63])
def test_decode_fold_matches_make_ring_decode(pos):
    """The one-token fold against make_ring_decode on a one-device mesh:
    the appended caches and the attention output, with slots past pos
    holding garbage that must stay invisible."""
    rng = np.random.default_rng(pos)
    b, t_max, h, d = 2, 64, 2, 16
    kc, vc = (rng.normal(0, 1, (b, t_max, h, d)).astype(np.float32)
              for _ in range(2))
    q, k, v = (rng.normal(0, 1, (b, 1, h, d)).astype(np.float32)
               for _ in range(3))
    jfold = jdecode.make_ring_decode(meshlib.seq_mesh(1))
    want = jfold(jnp.asarray(kc), jnp.asarray(vc), *map(jnp.asarray,
                                                         (q, k, v)), pos)
    kt, vt = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got = tdecode.make_ring_decode()(kt, vt, *map(torch.from_numpy,
                                                  (q, k, v)), pos)
    assert got[1] is kt and got[2] is vt        # appended in place
    for g, w, name in zip(got, want, ("out", "k cache", "v cache")):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    with pytest.raises(ValueError, match="outside the cache"):
        tdecode.make_ring_decode()(kt, vt, *map(torch.from_numpy, (q, k, v)),
                                   t_max)
    with pytest.raises(ValueError, match="ONE token"):
        tdecode.make_ring_decode()(kt, vt, *(torch.zeros(b, 2, h, d),) * 3,
                                   0)
    zk, zv = tdecode.init_cache(b, t_max, h, d, dtype=torch.float32)
    assert zk.shape == (b, t_max, h, d) and not zk.any() and not zv.any()


def _head_scaled(params, factor):
    out = jax.tree.map(np.array, params)
    out["head"]["kernel"] = out["head"]["kernel"] * factor
    return out


@pytest.mark.parametrize("block_impl,p_len", [("jnp", 5), ("pallas", 100)])
def test_generator_matches_jax_generator(block_impl, p_len):
    """Prefill logits and caches (f32 cache) and greedy tokens against the
    JAX Generator with the same block impl. The head is scaled so the
    top-2 logit gap along the generated path (checked below) is far
    above the numerical error: equal tokens are then a real check."""
    t_max, steps = 256, 12
    params = _head_scaled(_jax_params(6, seq=t_max), 8.0)
    prompt = _tokens(2, 7, seq=p_len)
    kw = dict(t_max=t_max, block_impl=block_impl, **KW)
    jgen = jlm.Generator(params, cache_dtype=jnp.float32, **kw)
    tgen = tlm.Generator(params, cache_dtype=torch.float32, device="cpu",
                         **kw)
    j_logits, j_caches = jgen.prefill(jnp.asarray(prompt, jnp.int32))
    t_logits, t_caches = tgen.prefill(prompt)
    np.testing.assert_allclose(t_logits, np.asarray(j_logits), rtol=1e-5,
                               atol=1e-4)
    for (tk, tv), (jk, jv) in zip(t_caches, j_caches):
        np.testing.assert_allclose(tk, np.asarray(jk), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tv, np.asarray(jv), rtol=1e-5, atol=1e-5)
    want = np.asarray(jgen(jnp.asarray(prompt, jnp.int32), steps))
    got = tgen(prompt, steps).numpy()
    # the check's own premise: every greedy pick had a clear winner
    model = _port_model(params, seq=t_max)
    with torch.no_grad():
        seq = torch.from_numpy(np.pad(want, ((0, 0), (0, t_max - want.shape[1]))))
        lg = model(seq)[:, p_len - 1:p_len - 1 + steps]
    top2 = lg.topk(2, dim=-1).values
    assert float((top2[..., 0] - top2[..., 1]).min()) > 1e-3
    np.testing.assert_array_equal(got, want)


def test_pallas_prefill_of_a_short_prompt_raises_as_in_jax():
    """A prompt of 64 tokens or fewer buckets under 128, which the flash
    kernel refuses: the pallas prefill raises in both packages."""
    params = _jax_params(8)
    kw = dict(t_max=SEQ, block_impl="pallas", **KW)
    prompt = _tokens(1, 9, seq=64)
    with pytest.raises(ValueError, match="multiples of 128"):
        jlm.Generator(params, cache_dtype=jnp.float32, **kw).prefill(
            jnp.asarray(prompt, jnp.int32))
    gen = tlm.Generator(params, cache_dtype=torch.float32, device="cpu",
                        **kw)
    with pytest.raises(ValueError, match="multiples of 128"):
        gen.prefill(prompt)
    logits, _ = gen.prefill(_tokens(1, 9, seq=65))     # bucket 128
    assert logits.shape == (1, VOCAB)


def test_generator_checks_and_top_k_support():
    """The JAX Generator's pre-dispatch checks, and sampling: with top_k,
    every drawn token is one of the k most likely."""
    params = _jax_params(10)
    with pytest.raises(ValueError, match="position table"):
        tlm.Generator(params, t_max=2 * SEQ, device="cpu", **KW)
    with pytest.raises(ValueError, match="not divisible"):
        tlm.Generator(params, t_max=SEQ, embed_dim=30, num_heads=4,
                      num_blocks=BLOCKS, device="cpu")
    gen = tlm.Generator(params, t_max=SEQ, temperature=5.0, top_k=2,
                        cache_dtype=torch.float32, device="cpu", **KW)
    prompt = _tokens(4, 11, seq=6)
    with pytest.raises(ValueError, match="needs an rng"):
        gen(prompt, 2)
    with pytest.raises(ValueError, match="exceeds"):
        gen(_tokens(1, 11, seq=SEQ), 1)
    with pytest.raises(ValueError, match="steps >= 1"):
        gen(prompt, 0)
    g = torch.Generator().manual_seed(0)
    logits, caches = gen.prefill(prompt)
    drawn = set()
    for pos in range(6, 30):
        allowed = logits.topk(2, dim=-1).indices
        tok, logits, caches = gen.decode(caches, logits, pos, 1, rng=g)
        assert (tok == allowed).any(-1).all()
        drawn |= set(tok[:, 0].tolist())
    assert len(drawn) > 1
    with pytest.raises(ValueError, match="exceeds t_max"):
        gen.decode(caches, logits, SEQ, 1, rng=g)
    assert gen.cache_sizes() == {"step": 0, "prefill": 0,
                                 "prefill_chunk": 0, "decode_loop": 0}


def test_lm_verb_runs_on_the_cpu_through_the_pallas_ring(tmp_path):
    """`python -m idc_models_tpu_torch lm --device cpu ... --block-impl
    pallas` trains, prints the step and generate lines, and logs them."""
    out = subprocess.run(
        [sys.executable, "-m", "idc_models_tpu_torch", "lm", "--device",
         "cpu", "--steps", "3", "--seq-len", "128", "--block-impl", "pallas",
         "--batch-size", "4", "--path", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=300, check=True)
    lines = out.stdout.splitlines()
    assert any(line.startswith("step 0, loss=") for line in lines)
    assert any(line.startswith("step 2, loss=") and
               "next-token accuracy=" in line for line in lines)
    assert any(line.startswith("generate: [0, 1, 2] -> ") for line in lines)
    records = [json.loads(line) for line in
               (tmp_path / "logs" / "run.jsonl").read_text().splitlines()]
    assert [r["event"] for r in records] == ["step", "step", "timer",
                                             "generate", "metrics_snapshot"]
    assert len(records[-2]["tokens"]) == 15


def test_lm_verb_refuses_what_is_not_ported(monkeypatch, capsys):
    """`--layout zigzag` and `--remat` train (the stripe rule of the JAX
    verb holds), and the sharding flags refuse what the JAX verb
    refuses: a mesh larger than the world, a ring that does not divide
    it."""
    assert cli.main(["lm", "--device", "cpu", "--steps", "2", "--seq-len",
                     "16", "--layout", "zigzag", "--remat", "--dropout",
                     "0.1", "--generate", "0"]) == 0
    assert "step 1, loss=" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="--seq-len 15 must divide into 2 "
                                         "equal stripes for --layout "
                                         "zigzag at ring size 1"):
        cli.main(["lm", "--device", "cpu", "--seq-len", "15", "--layout",
                  "zigzag"])
    for argv, match in (
            (["--fsdp", "2"], "--fsdp 2 x --tp 1 x --seq-parallel 1 needs "
                              "2 devices, have 1 \\(use --host-devices"),
            (["--tp", "2"], "--fsdp 1 x --tp 2 x --seq-parallel 1 needs 2 "
                            "devices, have 1"),
            (["--seq-parallel", "2"], "--seq-parallel 2 must be a "
                                      "positive divisor of the device "
                                      "count \\(1\\)"),
            (["--fsdp", "-1"], "--fsdp/--tp must be >= 0")):
        with pytest.raises(SystemExit, match=match):
            cli.main(["lm", "--device", "cpu", *argv])
    # without --device cpu the verb runs on CUDA or raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["lm", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlm.Generator(_jax_params(0), t_max=SEQ, **KW)


def test_lm_verb_shards_over_a_cpu_pod(tmp_path, capsys,
                                   monkeypatch):
    """`lm --host-devices 4 --fsdp 2 --tp 2`: four gloo ranks train the
    LM under the rule set 'lm' and generate from the gathered weights;
    rank 0 prints and writes the records. Over a pod the JAX verb's
    refusals read as from one process: --fsdp 3 x --tp 2 on 4 ranks, a
    batch --fsdp does not divide."""
    # one thread a rank: the pod shares the test run's cores
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    assert cli.main(["lm", "--device", "cpu", "--host-devices", "4",
                     "--fsdp", "2", "--tp", "2", "--steps", "3",
                     "--batch-size", "4", "--seq-len", "16",
                     "--generate", "3", "--path", str(tmp_path)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == ("Device: cpu (ring size 1) over 4 ranks (data=2, "
                        "model=2, seq=1); params + optimizer state sharded "
                        "by rule set 'lm'")
    assert any(line.startswith("step 2, loss=") for line in lines)
    assert any(line.startswith("generate: [0, 1, 2] -> ") for line in lines)
    records = [json.loads(line) for line in
               (tmp_path / "logs" / "run.jsonl").read_text().splitlines()]
    assert [r["event"] for r in records] == ["step", "step", "timer",
                                             "generate", "metrics_snapshot"]
    assert all(np.isfinite(r["loss"]) for r in records if "loss" in r)
    for argv, match in (
            (["--host-devices", "4", "--fsdp", "3", "--tp", "2"],
             "--fsdp 3 x --tp 2 x --seq-parallel 1 needs 6 devices, have "
             "4"),
            (["--host-devices", "2", "--fsdp", "2", "--batch-size", "3"],
             "--batch-size 3 must divide by --fsdp 2")):
        with pytest.raises(SystemExit, match=match):
            cli.main(["lm", "--device", "cpu", *argv])
