"""The port's attention classifier and the rest of the trainable sequence
stack (idc_models_tpu_torch/models/attention.py, models/lm.py's layout
and remat, data/sequences.py, synthetic.make_sequence_task, the
`attention` verb) against the JAX package's, on the CPU: weights carried
from JAX with `convert.load_jax`, the same numpy batches through both,
the JAX models on a one-device "seq" mesh (their pallas blocks
interpret on the CPU) and the port on a ring of one (the kernels' plain
versions)."""

from __future__ import annotations

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from idc_models_tpu import mesh as meshlib
from idc_models_tpu.data import sequences as jseq
from idc_models_tpu.data import synthetic as jsyn
from idc_models_tpu.models import attention as jattn
from idc_models_tpu.models import lm as jlm
from idc_models_tpu.train import losses as jlosses
from idc_models_tpu.train import state as jstate
from idc_models_tpu.train import step as jstep
from idc_models_tpu_torch import cli, convert
from idc_models_tpu_torch.data import sequences as tseq
from idc_models_tpu_torch.data import synthetic as tsyn
from idc_models_tpu_torch.models import attention as tattn
from idc_models_tpu_torch.models import core as tcore
from idc_models_tpu_torch.models import lm as tlm
from idc_models_tpu_torch.train import losses as tlosses
from idc_models_tpu_torch.train import state as tstate
from idc_models_tpu_torch.train import step as tstep

# T = 256: the least the pallas zigzag schedule takes (quarters of 128)
T, F, E, HEADS, MLP, BLOCKS = 256, 8, 32, 2, 64, 2
SIZES = dict(embed_dim=E, num_heads=HEADS, mlp_dim=MLP, num_blocks=BLOCKS)
VOCAB = 16
ENGINES = [(layout, impl) for layout in ("contiguous", "zigzag")
           for impl in ("jnp", "pallas")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share a few cores: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_classifier(layout="contiguous", impl="jnp", **kw):
    return jattn.attention_classifier(
        T, F, mesh=meshlib.seq_mesh(1), layout=layout, block_impl=impl,
        **SIZES, **kw)


@functools.cache
def _params(seed=0):
    return jax.device_get(_jax_classifier().init(jax.random.key(seed))
                          .params)


def _port_classifier(params, layout="contiguous", impl="jnp", **kw):
    model = tattn.AttentionClassifier(T, F, layout=layout, block_impl=impl,
                                      **SIZES, **kw)
    return convert.load_jax(model, params)


def _flat(tree):
    return {k: np.asarray(v) for k, v in convert.flatten(tree).items()}


def _batch(seed, n=2):
    x, y = jsyn.make_sequence_task(n, T, F, seed=seed)
    return x, y


def test_convert_round_trips_the_classifier_bit_for_bit():
    """An attention_classifier tree loads into AttentionClassifier (the
    JAX names: embed, pos, block{i}, ln_f, head) and comes back with
    every leaf's bits and dtype."""
    params = _params()
    model = _port_classifier(params)
    assert set(dict(model.named_parameters())) == {
        k.replace("/", ".") for k in _flat(params)}
    got, want = _flat(convert.to_jax(model)[0]), _flat(params)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k


@pytest.mark.parametrize("layout,impl", ENGINES)
def test_logits_loss_and_gradients_match_attention_classifier(layout, impl):
    """Logits (1e-5), the BCE loss and every parameter's gradient (1e-4)
    against attention_classifier on the same weights and batch, each
    layout on each block engine."""
    params = _params()
    x, y = _batch(1)
    jmodel = _jax_classifier(layout, impl)

    def jloss(p):
        logits, _ = jmodel.apply(p, {}, jnp.asarray(x))
        return jlosses.binary_cross_entropy(logits, jnp.asarray(y)), logits

    (want_loss, want_logits), want_grads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params)
    model = _port_classifier(params, layout, impl)
    logits = model(torch.from_numpy(x))
    loss = tlosses.binary_cross_entropy(logits, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(logits.detach(), want_logits, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got_grads = {k: p.grad for k, p in model.named_parameters()}
    for k, w in _flat(want_grads).items():
        np.testing.assert_allclose(got_grads[k.replace("/", ".")], w,
                                   rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("layout,impl", [("contiguous", "jnp"),
                                         ("zigzag", "pallas")])
def test_three_rmsprop_steps_match_jax(layout, impl):
    """Three Keras-RMSprop steps (lr 1e-3, BCE) from the same weights on
    the same batches: the same losses (1e-5) and parameters (1e-4)."""
    params = _params(2)
    jmodel = _jax_classifier(layout, impl)
    opt = jstate.rmsprop(1e-3)
    state = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                              model_state={}, opt_state=opt.init(params))
    jstep_fn = jax.jit(jstep.make_train_step(
        jmodel, opt, jlosses.binary_cross_entropy))
    model = _port_classifier(params, layout, impl)
    tstep_fn = tstep.make_train_step(
        tstate.TrainState(model, tstate.rmsprop(model, 1e-3)),
        tlosses.binary_cross_entropy)
    for i in range(3):
        x, y = _batch(10 + i, n=4)
        state, jm = jstep_fn(state, jnp.asarray(x), jnp.asarray(y),
                             jax.random.key(0))
        tm = tstep_fn(torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        assert float(tm["accuracy"]) == float(jm["accuracy"])
    got = _flat(convert.to_jax(model)[0])
    for k, w in _flat(jax.device_get(state.params)).items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def _loss_and_grads(model, x, y, seed=None):
    """BCE loss and gradients of one train-mode forward; with `seed`,
    the dropout masks come from a generator seeded with it."""
    model.train()
    if seed is not None:
        tcore.use_generator(model, torch.Generator().manual_seed(seed))
    model.zero_grad(set_to_none=True)
    logits = model(torch.from_numpy(x))
    loss = tlosses.binary_cross_entropy(logits, torch.from_numpy(y))
    loss.backward()
    return logits.detach(), {k: p.grad for k, p in model.named_parameters()}


def _saved_bytes(model, x, y) -> int:
    """Bytes autograd keeps for the backward of one forward."""
    total = []

    def pack(t):
        total.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        logits = model(torch.from_numpy(x))
        loss = tlosses.binary_cross_entropy(logits, torch.from_numpy(y))
    loss.backward()
    return sum(total)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_remat_changes_memory_only(impl, dropout):
    """remat=True gives the same logits and gradients as remat=False,
    bit for bit, on both engines -- with dropout too, under one seed (the
    recompute draws the masks the forward drew) -- and keeps fewer bytes
    for the backward (tests/test_attention_model.py:96-137)."""
    params = _params(3)
    x, y = _batch(4)
    kw = dict(layout="zigzag", impl=impl, dropout_rate=dropout)
    plain = _port_classifier(params, **kw)
    remat = _port_classifier(params, remat=True, **kw)
    seed = 7 if dropout else None
    got, want = (_loss_and_grads(m, x, y, seed) for m in (remat, plain))
    assert torch.equal(got[0], want[0])
    for k, w in want[1].items():
        assert torch.equal(got[1][k], w), k
    if dropout:
        # the masks are live: another seed moves the logits
        other = _loss_and_grads(plain, x, y, seed + 1)[0]
        assert not torch.equal(other, want[0])
    else:
        assert _saved_bytes(remat, x, y) < _saved_bytes(plain, x, y) / 2


def test_remat_matches_jax_remat():
    """The port's remat classifier against the JAX one's jax.checkpoint
    (pallas, zigzag): logits and gradients as without remat."""
    params = _params(5)
    x, y = _batch(6)
    jmodel = _jax_classifier("zigzag", "pallas", remat=True)

    def jloss(p):
        logits, _ = jmodel.apply(p, {}, jnp.asarray(x))
        return jlosses.binary_cross_entropy(logits, jnp.asarray(y))

    want = jax.jit(jax.grad(jloss))(params)
    got = _loss_and_grads(_port_classifier(params, "zigzag", "pallas",
                                           remat=True), x, y)[1]
    for k, w in _flat(want).items():
        np.testing.assert_allclose(got[k.replace("/", ".")], w, rtol=1e-4,
                                   atol=1e-4, err_msg=k)


@pytest.mark.parametrize("impl,remat", [("jnp", True), ("pallas", False),
                                        ("pallas", True)])
def test_lm_zigzag_and_remat_match_attention_lm(impl, remat):
    """AttentionLM(layout="zigzag", remat=...) against attention_lm with
    the same knobs: logits in natural order (1e-5), the next-token loss
    and every gradient (1e-4)."""
    jmodel = jlm.attention_lm(VOCAB, T, mesh=meshlib.seq_mesh(1),
                              block_impl=impl, layout="zigzag",
                              remat=remat, **SIZES)
    params = jax.device_get(jmodel.init(jax.random.key(8)).params)
    toks = np.random.default_rng(9).integers(0, VOCAB, (2, T))
    jt = jnp.asarray(toks, jnp.int32)

    def jloss(p):
        logits, _ = jmodel.apply(p, {}, jt)
        return jlm.next_token_loss(logits, jt), logits

    (want_loss, want_logits), want_grads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params)
    model = convert.load_jax(tlm.AttentionLM(
        VOCAB, T, block_impl=impl, layout="zigzag", remat=remat, **SIZES),
        params)
    logits = model(torch.from_numpy(toks))
    loss = tlm.next_token_loss(logits, torch.from_numpy(toks))
    loss.backward()
    np.testing.assert_allclose(logits.detach(), want_logits, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    for k, w in _flat(want_grads).items():
        np.testing.assert_allclose(
            dict(model.named_parameters())[k.replace("/", ".")].grad, w,
            rtol=1e-4, atol=1e-4, err_msg=k)


def test_zigzag_layout_is_a_training_knob_for_the_generator():
    """An LM trained under zigzag serves through the natural-order
    Generator: its prefill logits equal the zigzag model's last-position
    logits."""
    model = tcore.init_params(tlm.AttentionLM(VOCAB, T, layout="zigzag",
                                              **SIZES), 0)
    toks = np.random.default_rng(1).integers(0, VOCAB, (1, T))
    with torch.no_grad():
        want = model(torch.from_numpy(toks))[:, -1]
    gen = tlm.Generator(model, embed_dim=E, num_heads=HEADS,
                        num_blocks=BLOCKS, t_max=T,
                        cache_dtype=torch.float32, device="cpu")
    got, _ = gen.prefill(toks)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_sequence_helpers_equal_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    imgs = rng.random((3, 20, 20, 3), dtype=np.float32)
    for p in (1, 2, 5, 10):
        got, want = tseq.patchify(imgs, p), jseq.patchify(imgs, p)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert tseq.sequence_shape(20, p) == jseq.sequence_shape(20, p)
    for bad in ((imgs, 3), (imgs, 0), (imgs[:, :, :10], 5)):
        with pytest.raises(ValueError) as want:
            jseq.patchify(*bad)
        with pytest.raises(ValueError) as got:
            tseq.patchify(*bad)
        assert str(got.value) == str(want.value)
    for args in ((20, 3), (20, 0)):
        with pytest.raises(ValueError, match="patch"):
            tseq.sequence_shape(*args)
    for n, t, f, seed in ((5, 64, 8, 0), (9, 256, 3, 4)):
        got = tsyn.make_sequence_task(n, t, f, seed=seed)
        want = jsyn.make_sequence_task(n, t, f, seed=seed)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)


def _records(path):
    return [json.loads(line) for line in
            (path / "logs" / "run.jsonl").read_text().splitlines()]


def _verb(capsys, *argv):
    assert cli.main(["attention", "--device", "cpu", *argv]) == 0
    return capsys.readouterr().out.splitlines()


def test_attention_verb_trains_on_synthetic_sequences(tmp_path, capsys):
    lines = _verb(capsys, "--steps", "51", "--seq-len", "32",
                  "--batch-size", "8", "--embed-dim", "16", "--num-heads",
                  "2", "--mlp-dim", "32", "--synthetic-examples", "32",
                  "--path", str(tmp_path))
    assert lines[0] == "Device: cpu (ring size 1)"
    steps = [line for line in lines if line.startswith("step ")]
    assert [s.split(",")[0] for s in steps] == ["step 0", "step 50"]
    assert all("loss=" in s and "accuracy=" in s for s in steps)
    val = lines[-1].split()
    assert val[0] == "val:" and [v.split("=")[0] for v in val[1:]] == [
        "loss", "accuracy", "auroc"]
    recs = _records(tmp_path)
    assert [r["event"] for r in recs] == ["step", "step", "timer", "val",
                                          "metrics_snapshot"]
    assert recs[2]["name"] == "Attention training"
    assert set(recs[3]) >= {"loss", "accuracy", "auroc"}
    assert all(np.isfinite(r["loss"]) for r in recs if "loss" in r)


def test_attention_verb_zigzag_remat_pallas(tmp_path, capsys):
    """The card's configuration at a small size: the pallas ring (the
    kernels' plain versions here), zigzag and remat, with dropout."""
    lines = _verb(capsys, "--steps", "2", "--seq-len", "256",
                  "--batch-size", "2", "--embed-dim", "16", "--num-heads",
                  "2", "--mlp-dim", "32", "--num-blocks", "1",
                  "--synthetic-examples", "4", "--block-impl", "pallas",
                  "--layout", "zigzag", "--remat", "--dropout", "0.1")
    assert lines[-1].startswith("val: loss=")
    assert "auroc=" in lines[-1]


def test_attention_verb_reads_an_idc_tree_through_patchify(tmp_path,
                                                           capsys):
    rng = np.random.default_rng(0)
    for label in ("0", "1"):
        (tmp_path / label).mkdir()
        for i in range(10):
            Image.fromarray(rng.integers(0, 256, (20, 20, 3), np.uint8),
                            "RGB").save(tmp_path / label / f"p{i}.png")
    lines = _verb(capsys, "--data-dir", str(tmp_path), "--image-size", "20",
                  "--patch-size", "5", "--steps", "2", "--batch-size", "4",
                  "--embed-dim", "16", "--num-heads", "2", "--mlp-dim",
                  "32")
    assert ("IDC patch sequences: 16 train / 2 val, 16 tokens x 75 "
            "features per patch") in lines
    assert lines[-1].startswith("val: loss=")


def test_attention_verb_rejections(monkeypatch):
    """The JAX verb's own refusals, and what waits for ROADMAP A4-rest."""
    def refused(*argv, match):
        with pytest.raises(SystemExit, match=match):
            cli.main(["attention", "--device", "cpu", *argv])

    refused("--layout", "zigzag", "--seq-len", "33",
            match="--seq-len = 33 must divide into 2 equal stripes for "
                  "--layout zigzag at ring size 1")
    refused("--data-dir", "/nonexistent", "--patch-size", "7",
            match="--patch-size: image size 50 not divisible by "
                  "patch_size 7")
    refused("--dropout", "1.0", match="must be in")
    refused("--seq-parallel", "2", match="ROADMAP A4-rest")
    refused("--host-devices", "8", match="ROADMAP A4-rest")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["attention", "--steps", "1"])
