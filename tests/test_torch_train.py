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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes on a few cores; torch's
    default of one thread a core oversubscribes them, and its OpenMP
    barriers then stall the many small ops of these models (a DenseNet
    test of 10 s took 350 s beside five other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    got = tidc.load_directory(tmp_path, image_size=6, seed=5, limit=5,
                              backend="pil")
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
    records (AUROC included), the closing metrics_snapshot record, and a
    model.npz in the JAX layout that loads back into a fresh port
    model."""
    rc = cli.main(["mobile", "--device", "cpu", "--synthetic-examples",
                   "48", "--batch-size", "8", "--epochs", "1",
                   "--fine-tune-epochs", "1", "--depthwise-impl", "fused",
                   "--path", str(tmp_path)])
    assert rc == 0
    recs = [json.loads(line) for line in
            (tmp_path / "logs" / "run.jsonl").read_text().splitlines()]
    events = [r["event"] for r in recs]
    assert events.count("epoch") == 2
    assert events[-2:] == ["test", "metrics_snapshot"]
    assert {"loss", "accuracy", "auroc"} <= set(recs[-2])
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


def _bn_classifier_pair(seed: int = 0):
    """The same conv -> BN -> relu classifier in both packages, on the
    JAX init's weights (no conv bias: a bias before a training BN has no
    gradient but rounding noise)."""
    jm = jcore.classifier(jcore.sequential(
        [jcore.conv2d(3, 8, 3, stride=2, use_bias=False, name="stem"),
         jcore.batch_norm(8, name="bn"), jcore.relu()], name="body"),
        8, 1, name="clf")
    v = jm.init(jax.random.key(seed))
    tm = tcore.Classifier(tcore.Sequential(
        [tcore.Conv2d(3, 8, 3, stride=2, use_bias=False, name="stem"),
         tcore.BatchNorm(8, name="bn"), tcore.ReLU()], name="body"),
        8, 1, name="clf")
    convert.load_jax(tm, v.params, v.state)
    return jm, v, tm


def _jax_fit(jm, v, ds, *, central_storage, epochs=2):
    from idc_models_tpu import mesh as meshlib
    from idc_models_tpu.train import loop as jloop

    opt = jstate.rmsprop(1e-3)
    state = jstate.TrainState(step=jnp.zeros((), jnp.int32),
                              params=v.params, model_state=v.state,
                              opt_state=opt.init(v.params))
    _, hist = jloop.fit(jm, opt, jlosses.binary_cross_entropy, state,
                        jidc.ArrayDataset(ds.images, ds.labels), None,
                        meshlib.data_mesh(1), epochs=epochs, batch_size=8,
                        seed=3, verbose=False,
                        central_storage=central_storage)
    return hist


def test_central_storage_equals_mirrored_and_jax():
    """central_storage keeps the state on the host between steps: the
    port's history and final weights equal its mirrored run bit for bit
    on the CPU, and its losses equal the JAX central_storage run's
    within rtol 1e-5 (the port's round tolerance, tests/
    test_torch_population.py)."""
    imgs, labels = tsynthetic.make_idc_like(32, size=10, seed=0)
    ds = tidc.ArrayDataset(imgs.astype(np.float32), labels)
    runs = {}
    for central in (False, True):
        jm, v, tm = _bn_classifier_pair()
        state = tstate.TrainState(tm, tstate.rmsprop(tm, 1e-3))
        hist = tloop.fit(state, tlosses.binary_cross_entropy, ds, None,
                         epochs=2, batch_size=8, seed=3, verbose=False,
                         central_storage=central)
        runs[central] = hist, {k: t.detach().clone()
                               for k, t in tm.state_dict().items()}
        assert state.step == 8
    (h_mir, w_mir), (h_cen, w_cen) = runs[False], runs[True]
    assert h_cen == h_mir
    for k in w_mir:
        assert torch.equal(w_cen[k], w_mir[k]), k
    want = _jax_fit(jm, v, ds, central_storage=True)
    np.testing.assert_allclose(h_cen["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(h_cen["accuracy"], want["accuracy"],
                               rtol=1e-5)


def _bf16_steps_against_jax(compute_dtype):
    """One train step and one eval step of the port at `compute_dtype`
    against JAX's bf16 steps, from the same weights and inputs. Returns
    (loss error relative to JAX's, each gradient's largest error over
    its largest |gradient|, largest logit error, the dtypes the stem
    convolution saw in and out)."""
    from idc_models_tpu.train import step as jstep
    from idc_models_tpu_torch.train import step as tstep

    rng = np.random.default_rng(0)
    x = rng.random((8, 10, 10, 3)).astype(np.float32)
    y = (np.arange(8) % 2).astype(np.int32)
    jm, v, tm = _bn_classifier_pair(1)

    def jax_loss(params):
        # the JAX train step's loss_of at compute_dtype=bf16
        logits, _ = jm.apply(params, v.state, jnp.asarray(x, jnp.bfloat16),
                             train=True)
        return jlosses.binary_cross_entropy(logits.astype(jnp.float32),
                                            jnp.asarray(y))

    jloss, jgrads = jax.value_and_grad(jax_loss)(v.params)
    seen = set()
    tm.backbone.stem.register_forward_hook(
        lambda m, a, out: seen.update({a[0].dtype, out.dtype}))
    state = tstate.TrainState(tm, tstate.rmsprop(tm, 1e-3))
    m = tstep.make_train_step(state, tlosses.binary_cross_entropy,
                              compute_dtype=compute_dtype)(
        torch.from_numpy(x), torch.from_numpy(y))
    loss_err = abs(float(m["loss"]) - float(jloss)) / abs(float(jloss))
    want = convert.flatten(jax.device_get(jgrads))
    grad_err = {}
    for k, p in tm.named_parameters():
        g = want[k.replace(".", "/")]
        grad_err[k] = float(np.abs(p.grad.numpy() - g).max()
                            / np.abs(g).max())
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert all(s["square_avg"].dtype == torch.float32
               for s in state.optimizer.state.values())
    assert all(b.dtype == torch.float32 for b in tm.buffers())

    # the eval step on the JAX weights, again
    jm, v, tm = _bn_classifier_pair(1)
    jeval = jstep.make_eval_step(jm, jlosses.binary_cross_entropy,
                                 compute_dtype=jnp.bfloat16)(
        jstate.TrainState(step=0, params=v.params, model_state=v.state,
                          opt_state=None), x, y)
    teval = tstep.make_eval_step(tm, tlosses.binary_cross_entropy,
                                 compute_dtype=compute_dtype)(
        torch.from_numpy(x), torch.from_numpy(y))
    assert teval["logits"].dtype == torch.float32
    logit_err = float(np.abs(teval["logits"].numpy()
                             - np.asarray(jeval["logits"])).max())
    return loss_err, grad_err, logit_err, seen


def test_bf16_train_and_eval_steps_match_jax():
    """compute_dtype=bf16 has the JAX step's semantics: inputs cast once,
    convolution weights cast to bf16, BN statistics in f32, the dense
    head promoted to f32, logits in f32 before the loss, master weights
    and moments f32. Both sides round at the same places, so on the same
    weights the port's bf16 steps agree with JAX's closely: the loss
    within 1e-5 relative and the eval logits within 1e-5 absolute
    (measured on the CPU: 8e-8 and 4.5e-8); each gradient within 1e-4
    of its largest |gradient| (measured: 1.2e-6), except the stem
    convolution's weight gradient, within 5e-2 (it sums 200 bf16
    products a weight in another order on each side; measured 2.0e-2).
    The stem convolution sees bf16 in and out.

    The control: the port's f32 steps on the same inputs fall outside
    those bounds (measured: loss 7.2e-5 relative, logits 9.2e-4, head
    kernel gradient 3.6e-3 of its largest), so the bounds tell a bf16
    step from an f32 one. The updated weights are not compared:
    RMSprop's first step moves each weight by lr*sqrt(10)*sign(g), so a
    near-zero gradient whose sign the two bf16 roundings differ on moves
    6e-3 apart."""
    loss_err, grad_err, logit_err, seen = _bf16_steps_against_jax(
        torch.bfloat16)
    assert seen == {torch.bfloat16}
    assert loss_err <= 1e-5
    assert logit_err <= 1e-5
    for k, err in grad_err.items():
        assert err <= (5e-2 if k == "backbone.stem.kernel" else 1e-4), (k, err)

    loss_err, grad_err, logit_err, seen = _bf16_steps_against_jax(None)
    assert seen == {torch.float32}
    assert loss_err > 1e-5
    assert logit_err > 1e-5
    assert grad_err["head.kernel"] > 1e-4


def test_bf16_steps_keep_token_ids_exact():
    """Integer inputs skip the compute-dtype cast, as the JAX step skips
    them (idc_models_tpu/train/step.py:39-46): token ids above 256 reach
    the LM unrounded under bf16, so the bf16 step's loss equals the f32
    step's on the same ids."""
    from idc_models_tpu_torch.models.lm import AttentionLM, next_token_loss
    from idc_models_tpu_torch.train import step as tstep

    ids = torch.tensor([[257, 300, 511, 1000, 1023, 5, 6, 7]])
    assert not torch.equal(ids.to(torch.bfloat16).long(), ids)
    assert torch.equal(tstep.cast_inputs(ids, torch.bfloat16), ids)
    losses = []
    for dtype in (torch.bfloat16, None):
        model = tcore.init_params(AttentionLM(
            1024, 8, embed_dim=16, num_heads=2, mlp_dim=32, num_blocks=1), 0)
        seen = []
        model.register_forward_pre_hook(lambda m, a: seen.append(a[0]))
        step = tstep.make_train_step(
            tstate.TrainState(model, tstate.rmsprop(model, 1e-3)),
            next_token_loss, compute_dtype=dtype)
        losses.append(float(step(ids, ids)["loss"]))
        assert torch.equal(seen[0], ids)
    assert losses[0] == losses[1]
