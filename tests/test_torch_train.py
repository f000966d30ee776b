"""The port's data and training layers (idc_models_tpu_torch/data, train,
observe, cli) against the JAX package's, on the CPU."""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from idc_models_tpu.data import idc as jidc
from idc_models_tpu.data import pipeline as jpipeline
from idc_models_tpu.data import synthetic as jsynthetic
from idc_models_tpu.models import core as jcore
from idc_models_tpu.train import losses as jlosses
from idc_models_tpu.train import metrics as jmetrics
from idc_models_tpu.train import state as jstate
from idc_models_tpu_torch import cli, convert
from idc_models_tpu_torch.data import idc as tidc
from idc_models_tpu_torch.data import pipeline as tpipeline
from idc_models_tpu_torch.data import synthetic as tsynthetic
from idc_models_tpu_torch.models import core as tcore
from idc_models_tpu_torch.models import mobilenet as tmobile
from idc_models_tpu_torch.models import pretrained as tpretrained
from idc_models_tpu_torch.observe import JsonlLogger, Timer
from idc_models_tpu_torch.train import losses as tlosses
from idc_models_tpu_torch.train import loop as tloop
from idc_models_tpu_torch.train import metrics as tmetrics
from idc_models_tpu_torch.train import state as tstate


def _tiny_classifier():
    return tcore.init_params(
        tcore.Classifier(tcore.Conv2d(3, 4, 3, name="stem"), 4, 1), 0)


@pytest.mark.parametrize("frozen", ["none", "backbone"])
def test_rmsprop_matches_jax_on_identical_gradients(frozen):
    """Three steps of the Keras RMSprop (nu = rho*nu + (1-rho) g^2,
    p -= lr g / (sqrt(nu) + eps)) fed the same gradients: parameters and
    moments agree; frozen leaves get no update and no moment."""
    model = _tiny_classifier()
    params, _ = convert.to_jax(model)
    mask = (tcore.head_only_mask(model) if frozen == "backbone"
            else None)
    jmask = (jcore.head_only_mask(params) if frozen == "backbone"
             else None)
    jopt = jstate.rmsprop(1e-2, trainable_mask=jmask)
    jparams = jax.tree.map(jnp.asarray, params)
    jopt_state = jopt.init(jparams)
    topt = tstate.rmsprop(model, 1e-2, trainable_mask=mask)
    named = dict(model.named_parameters())
    before = {k: v.detach().clone() for k, v in named.items()}
    rng = np.random.default_rng(0)
    for _ in range(3):
        grads = {k: rng.normal(0, 1, v.shape).astype(np.float32)
                 for k, v in named.items()}
        # a near-zero gradient: the first step is lr*sqrt(10)*sign(g)
        grads["head.bias"][0] = 1e-9
        jg = convert.unflatten({k.replace(".", "/"): jnp.asarray(g)
                                for k, g in grads.items()})
        upd, jopt_state = jopt.update(jg, jopt_state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for k, p in named.items():
            p.grad = (torch.from_numpy(grads[k]) if p.requires_grad
                      else None)
        topt.step()
    want = convert.flatten(jax.tree.map(np.asarray, jparams))
    for k, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   want[k.replace(".", "/")], rtol=1e-6,
                                   atol=1e-7, err_msg=k)
        if mask is not None and not mask[k]:
            assert torch.equal(p.detach(), before[k]), k
            assert p not in topt.state, k
    assert len(topt.param_groups[0]["params"]) == sum(
        (mask or {k: True for k in named}).values())


def test_freeze_where_rejects_a_foreign_mask():
    model = _tiny_classifier()
    with pytest.raises(ValueError, match="does not match"):
        tstate.freeze_where(model, {"head.kernel": True})


@pytest.mark.parametrize("repeat,drop", [(1, True), (2, True), (1, False)])
def test_loader_batch_order_matches_jax(repeat, drop):
    imgs, labels = jsynthetic.make_idc_like(37, size=4, seed=1)
    jl = jpipeline.Loader(jidc.ArrayDataset(imgs, labels), 8, seed=3,
                          repeat=repeat, drop_remainder=drop)
    tl = tpipeline.Loader(tidc.ArrayDataset(imgs, labels), 8, seed=3,
                          repeat=repeat, drop_remainder=drop)
    assert len(tl) == len(jl)
    for epoch in range(3):
        jb, tb = list(jl.epoch(epoch)), list(tl.epoch(epoch))
        assert len(jb) == len(tb)
        for (jx, jy), (tx, ty) in zip(jb, tb):
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)


def test_to_device_keeps_order_and_narrows_float64():
    imgs, labels = tsynthetic.make_idc_like(20, size=4, seed=0)
    assert imgs.dtype == np.float64
    ds = tidc.ArrayDataset(imgs, labels)
    got = list(tpipeline.to_device(tpipeline.eval_batches(ds, 6),
                                   torch.device("cpu")))
    assert [len(x) for x, _ in got] == [6, 6, 6, 2]
    assert got[0][0].dtype == torch.float32
    np.testing.assert_array_equal(torch.cat([y for _, y in got]).numpy(),
                                  labels)


def test_synthetic_and_split_match_jax():
    ti, tl = tsynthetic.make_idc_like(50, size=12, seed=4)
    ji, jl = jsynthetic.make_idc_like(50, size=12, seed=4)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tl, jl)
    tsplits = tidc.train_val_test_split(tidc.ArrayDataset(ti, tl), seed=2)
    jsplits = jidc.train_val_test_split(jidc.ArrayDataset(ji, jl), seed=2)
    for t, j in zip(tsplits, jsplits):
        np.testing.assert_array_equal(t.images, j.images)
        np.testing.assert_array_equal(t.labels, j.labels)


def test_load_directory_pil_matches_jax(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    for label in ("0", "1"):
        (tmp_path / label).mkdir()
        for i in range(3):
            arr = rng.integers(0, 256, (7 + i, 9, 3), dtype=np.uint8)
            Image.fromarray(arr).save(tmp_path / label / f"p{i}.png")
    got = tidc.load_directory(tmp_path, image_size=6, seed=5, limit=5)
    want = jidc.load_directory(tmp_path, image_size=6, seed=5, limit=5,
                               backend="pil")
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.images, want.images)
    with pytest.raises(FileNotFoundError):
        tidc.load_directory(tmp_path / "0")


def test_losses_and_metrics_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 2, (64, 1)).astype(np.float32)
    logits[:10] = 0.5                                 # ties for the AUROC
    labels = rng.integers(0, 2, 64).astype(np.int32)
    tl, tlab = torch.from_numpy(logits), torch.from_numpy(labels)
    jl, jlab = jnp.asarray(logits), jnp.asarray(labels)
    pairs = [
        (tlosses.binary_cross_entropy(tl, tlab),
         jlosses.binary_cross_entropy(jl, jlab)),
        (tmetrics.auto_accuracy(tl, tlab), jmetrics.auto_accuracy(jl, jlab)),
        (tmetrics.auroc(torch.sigmoid(tl), tlab),
         jmetrics.auroc(jax.nn.sigmoid(jl), jlab)),
    ]
    multi = rng.normal(0, 1, (64, 5)).astype(np.float32)
    cls = rng.integers(0, 5, 64).astype(np.int32)
    pairs += [
        (tlosses.sparse_categorical_cross_entropy(torch.from_numpy(multi),
                                                  torch.from_numpy(cls)),
         jlosses.sparse_categorical_cross_entropy(jnp.asarray(multi),
                                                  jnp.asarray(cls))),
        (tmetrics.auto_accuracy(torch.from_numpy(multi),
                                torch.from_numpy(cls)),
         jmetrics.auto_accuracy(jnp.asarray(multi), jnp.asarray(cls))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    one_class = torch.ones(8)
    assert np.isnan(float(tmetrics.auroc(torch.rand(8), one_class)))


def test_two_phase_fit_learns_on_synthetic_patches():
    """A short two-phase run of the fused build on 16x16 synthetic
    patches: phase-1 loss falls, metrics are finite, AUROC reported."""
    imgs, labels = tsynthetic.make_idc_like(160, size=16, seed=0)
    train, val, test = tidc.train_val_test_split(
        tidc.ArrayDataset(imgs, labels), seed=0)
    cfg = tloop.TwoPhaseConfig(lr=1e-3, epochs=3, fine_tune_epochs=1,
                               batch_size=16, eval_steps=2, seed=0)
    result = tloop.two_phase_fit(
        "mobilenet_v2", 1, train, val, cfg,
        build_kwargs={"depthwise_impl": "fused"}, device="cpu")
    loss = result.history["loss"]
    assert len(loss) == 3 and loss[-1] < loss[0]
    assert len(result.history_fine["loss"]) == 1
    assert result.train_steps == (3 * (len(train) // 16),
                                  1 * (len(train) // 16))
    for h in (result.history, result.history_fine):
        assert all(np.isfinite(v) for vs in h.values() for v in vs)
    m = tloop.evaluate(result.model, test, tlosses.binary_cross_entropy,
                       batch_size=16, with_auroc=True)
    assert set(m) == {"loss", "accuracy", "auroc"}
    assert all(np.isfinite(v) for v in m.values())
    logits = tloop.predict(result.model, test.images, batch_size=7)
    assert logits.shape == (len(test), 1) and np.isfinite(logits).all()
    assert tloop.predict(result.model, test.images[:0]).shape == (0, 1)


def test_fit_raises_on_non_finite_loss():
    imgs, labels = tsynthetic.make_idc_like(16, size=8, seed=0)
    imgs[3] = np.nan
    model = tmobile.mobilenet_v2(1, bn_frozen_below=tmobile.FREEZE_ALL)
    tcore.init_params(model, 0)
    state = tstate.TrainState(model, tstate.rmsprop(model, 1e-3))
    with pytest.raises(FloatingPointError, match="non-finite"):
        tloop.fit(state, tlosses.binary_cross_entropy,
                  tidc.ArrayDataset(imgs, labels), None, epochs=1,
                  batch_size=8, verbose=False)
    assert state.step == 2


def test_timer_and_jsonl_logger_records(tmp_path):
    path = tmp_path / "logs" / "run.jsonl"
    with JsonlLogger(path) as log:
        with Timer("Pre-training for 1 epochs", logger=log, quiet=True) as t:
            pass
        log.log(event="epoch", epoch=0, loss=torch.tensor(0.5),
                accuracy=np.float32(0.25))
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert recs[0]["event"] == "timer" and recs[0]["seconds"] == t.seconds
    assert recs[1] == {"ts": recs[1]["ts"], "event": "epoch", "epoch": 0,
                       "loss": 0.5, "accuracy": 0.25}


def test_cli_mobile_runs_two_phases_on_the_cpu(tmp_path, capsys):
    """The `mobile` verb end to end at a small size: jsonl epoch/test
    records (AUROC included) and a model.npz in the JAX layout that loads
    back into a fresh port model."""
    rc = cli.main(["mobile", "--device", "cpu", "--synthetic-examples",
                   "48", "--batch-size", "8", "--epochs", "1",
                   "--fine-tune-epochs", "1", "--depthwise-impl", "fused",
                   "--path", str(tmp_path)])
    assert rc == 0
    recs = [json.loads(line) for line in
            (tmp_path / "logs" / "run.jsonl").read_text().splitlines()]
    events = [r["event"] for r in recs]
    assert events.count("epoch") == 2 and events[-1] == "test"
    assert {"loss", "accuracy", "auroc"} <= set(recs[-1])
    assert "test: loss=" in capsys.readouterr().out
    params, state = tpretrained.load_pretrained_file(tmp_path / "model.npz")
    model = tmobile.mobilenet_v2(1)
    convert.load_jax(model, params, state)


def test_evaluate_and_predict_take_multiclass_logits():
    """Ten-class logits through `evaluate` and `predict`. The eval loop
    used to run the binary CE on every batch whatever the loss asked
    for, which refused [B, 10] logits; the loss and accuracy are now
    the asked-for loss's, as the JAX package's Evaluator computes them."""
    model = tcore.init_params(tcore.Classifier(
        tcore.Conv2d(3, 4, 3, name="stem"), 4, 10), 0)
    rng = np.random.default_rng(0)
    imgs = rng.random((10, 8, 8, 3), dtype=np.float32)
    labels = (np.arange(10) % 10).astype(np.int32)
    m = tloop.evaluate(model, tidc.ArrayDataset(imgs, labels),
                       tlosses.sparse_categorical_cross_entropy,
                       batch_size=4)
    logits = tloop.predict(model, imgs, batch_size=4)
    assert logits.shape == (10, 10)
    want_loss = jlosses.sparse_categorical_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(m["loss"], float(want_loss), rtol=1e-6)
    assert m["accuracy"] == float(jmetrics.auto_accuracy(
        jnp.asarray(logits), jnp.asarray(labels)))


def test_two_phase_fit_passes_the_train_set_repeats_times():
    """repeats=2 (the dense preset's): every epoch of both phases takes
    twice the steps of one pass, in the Loader's (seed, epoch, rep)
    order."""
    imgs, labels = tsynthetic.make_idc_like(20, size=32, seed=0)
    train = tidc.ArrayDataset(imgs[:16], labels[:16])
    val = tidc.ArrayDataset(imgs[16:], labels[16:])
    cfg = dict(epochs=1, fine_tune_epochs=1, batch_size=8, eval_steps=1)
    once = tloop.two_phase_fit("vgg16", 1, train, val,
                               tloop.TwoPhaseConfig(**cfg), device="cpu")
    twice = tloop.two_phase_fit("vgg16", 1, train, val,
                                tloop.TwoPhaseConfig(repeats=2, **cfg),
                                device="cpu")
    assert once.train_steps == (2, 2)
    assert twice.train_steps == (4, 4)
