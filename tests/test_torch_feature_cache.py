"""The port's frozen-prefix feature cache (train/feature_cache.py) and
the unit splitter (core.UnitBackbone.splitter), on the CPU.

The split must compose to the full model bit for bit (eval and train
mode), cut where the JAX package's plan cuts, share the full model's
layers, fall back where there is nothing to split, never write into the
cached features, and give the uncached phase 2's training: parameters,
BN statistics and loss history within the JAX package's own tolerances
(tests/test_feature_cache.py: rtol 2e-5 / atol 1e-6, loss rtol 1e-4)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from idc_models_tpu.models import densenet as jdensenet
from idc_models_tpu.models import mobilenet as jmobile
from idc_models_tpu.models import vgg as jvgg
from idc_models_tpu.train import feature_cache as jfc
from idc_models_tpu_torch.data import synthetic
from idc_models_tpu_torch.data.idc import ArrayDataset
from idc_models_tpu_torch.models import core as tcore
from idc_models_tpu_torch.models import registry
from idc_models_tpu_torch.ops import fused_conv as tfc
from idc_models_tpu_torch.train import feature_cache as fc
from idc_models_tpu_torch.train import losses
from idc_models_tpu_torch.train import loop
from idc_models_tpu_torch.train.state import TrainState, rmsprop

PARAM_TOL = dict(rtol=2e-5, atol=1e-6)
LOSS_RTOL = 1e-4

# (registry name, JAX constructor, fine_tune_at, input size, num_outputs,
#  build kwargs, the JAX plan's feature dim)
CASES = {
    "vgg16": ("vgg16", jvgg.vgg16, 15, 32, 1, {}, 512),
    "mobilenet_fused": ("mobilenet_v2", jmobile.mobilenet_v2, 100, 32, 1,
                        {"depthwise_impl": "fused"}, 1280),
    "densenet_packed": ("densenet201", jdensenet.densenet201, 150, 32, 10,
                        {"block_impl": "packed"}, 1920),
    "densenet_concat": ("densenet201", jdensenet.densenet201, 150, 32, 10,
                        {"block_impl": "concat"}, 1920),
}


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


def _build(name, fine_tune_at, num_outputs, kw):
    spec = registry.get_model(name)
    if name != "vgg16":
        kw = {**kw, "bn_frozen_below": fine_tune_at}
    return spec, tcore.init_params(spec.build(num_outputs, **kw), 0)


def _images(n, size, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).random(
        (n, size, size, 3), dtype=np.float32))


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_composes_to_the_full_model_where_jax_cuts(case):
    name, jbuild, at, size, n_out, kw, dim = CASES[case]
    spec, model = _build(name, at, n_out, kw)
    plan = fc.plan_feature_cache(model, spec.layer_index, at)
    jkw = {} if name == "vgg16" else {"bn_frozen_below": at}
    jplan = jfc.plan_feature_cache(jbuild(n_out, **jkw), spec.layer_index,
                                   at, dim, n_out)
    assert plan.boundary == jplan.boundary
    assert plan.suffix_keys == tuple(jplan.suffix_keys)
    # the prefix is frozen, and the suffix model is the full model's own
    # layers and head
    prefix_keys = {k.split(".")[0] for k, _ in plan.prefix.named_parameters()}
    assert all(spec.layer_index[k] < at for k in prefix_keys)
    assert plan.suffix_model.head is model.head
    for k, p in plan.suffix_model.named_parameters():
        assert p is model.get_parameter(k)
    x = _images(4, size)
    for train in (False, True):
        state = {k: v.clone() for k, v in model.state_dict().items()}
        with torch.no_grad():
            want = model.train(train)(x)
            model.load_state_dict(state)
            got = plan.suffix_model.train(train)(plan.prefix.eval()(x))
        assert torch.equal(got, want), f"train={train}"


@pytest.mark.parametrize("name,build,at", [
    ("vgg16", lambda: registry.get_model("vgg16").build(1), 15),
    ("mobilenet_v2", lambda: registry.get_model("mobilenet_v2").build(1),
     100),
    ("densenet201", lambda: registry.get_model("densenet201").build(10),
     150),
])
def test_plan_fallbacks(name, build, at):
    model = tcore.init_params(build(), 0)
    index = registry.get_model(name).layer_index
    # nothing frozen before the boundary: no plan
    assert fc.plan_feature_cache(model, index, 0) is None
    # everything frozen: the whole backbone cached, GAP + head train
    plan = fc.plan_feature_cache(model, index, 10_000)
    assert plan.boundary is None and plan.suffix_keys == ()
    x = _images(2, 32)
    with torch.no_grad():
        assert torch.equal(plan.suffix_model.eval()(plan.prefix.eval()(x)),
                           model.eval()(x))
    assert fc.plan_feature_cache(model, index, at) is not None


def test_plan_declines_a_model_without_a_splittable_backbone():
    small = registry.get_model("small_cnn").build(1)
    assert fc.plan_feature_cache(small, {}, 0) is None


def test_cached_features_unchanged_after_a_cached_phase2():
    """DenseNet packed at fine_tune_at=150 caches the partly filled
    stage-4 buffer [N, 2, 2, 1792]; the suffix's first packed layer
    writes into its input's channels -- never into the cache."""
    spec, model = _build("densenet201", 150, 10, {"block_impl": "packed"})
    plan = fc.plan_feature_cache(model, spec.layer_index, 150)
    imgs, labels = synthetic.make_cifar_like(12, seed=0)
    feats = fc.compute_features(plan, ArrayDataset(imgs, labels),
                                batch_size=8)
    assert feats.images.shape == (12, 2, 2, 1792)
    assert not feats.images[..., 320 + 32:].any()   # not yet written
    kept = feats.images.copy()
    suffix = plan.suffix_model
    state = TrainState(suffix, rmsprop(
        suffix, 1e-5, trainable_mask=spec.fine_tune_mask(suffix, 150)))
    loop.fit(state, losses.sparse_categorical_cross_entropy, feats, feats,
             epochs=2, batch_size=4, verbose=False)
    np.testing.assert_array_equal(feats.images, kept)
    x = torch.from_numpy(kept[:4].copy())
    with torch.no_grad():
        suffix.train()(x)
    np.testing.assert_array_equal(x.numpy(), kept[:4])


def test_mobilenet_cache_sends_the_prefix_chains_through_the_kernel(
        monkeypatch):
    """mobile --cache-features --depthwise-impl fused: the prefix (stem +
    blocks 1-10) runs 11 fused chains a batch when the features are
    computed, the suffix's train forward none (its 6 chains train their
    BNs) and its eval forward 6: the counts chip_smoke.py holds the
    kernel's launches to."""
    seen = []
    real = tfc.fused_depthwise_bn_relu6
    monkeypatch.setattr(tfc, "fused_depthwise_bn_relu6",
                        lambda *a, **k: seen.append(1) or real(*a, **k))
    spec, model = _build("mobilenet_v2", 100, 1,
                         {"depthwise_impl": "fused"})
    plan = fc.plan_feature_cache(model, spec.layer_index, 100)
    imgs, labels = synthetic.make_idc_like(10, size=32, seed=0)
    feats = fc.compute_features(plan, ArrayDataset(imgs, labels),
                                batch_size=4)
    assert len(seen) == 11 * 3
    x = torch.from_numpy(feats.images[:4])
    for train, calls in ((True, 0), (False, 6)):
        seen.clear()
        with torch.no_grad():
            plan.suffix_model.train(train)(x)
        assert len(seen) == calls


@pytest.mark.parametrize("name,n_out,size,kw,epochs", [
    ("vgg16", 1, 50, {}, 1),
    ("mobilenet_v2", 1, 50, {"depthwise_impl": "fused"}, 1),
    ("densenet201", 10, 32, {}, 0),
])
def test_two_phase_cached_matches_uncached(name, n_out, size, kw, epochs):
    """The same seeds, the same batches: phase 2 on cached features
    gives the uncached phase 2's parameters, BN statistics and loss
    history; the train split (20) is no multiple of the batch (8), so
    the cache's last batch is a partial one."""
    imgs, labels = synthetic.make_idc_like(28, size=size, seed=0)
    if n_out > 1:
        labels = (np.arange(28) % n_out).astype(np.int32)
    train = ArrayDataset(imgs[:20], labels[:20])
    val = ArrayDataset(imgs[20:], labels[20:])
    cfg = dict(lr=1e-3, epochs=epochs, fine_tune_epochs=1, batch_size=8,
               eval_steps=1, seed=0)
    r_plain, r_cached = (
        loop.two_phase_fit(name, n_out, train, val,
                           loop.TwoPhaseConfig(cache_features=c, **cfg),
                           build_kwargs=kw, device="cpu")
        for c in (False, True))
    want, got = r_plain.model.state_dict(), r_cached.model.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   **PARAM_TOL, err_msg=k)
    for k in ("loss", "val_loss"):
        np.testing.assert_allclose(r_cached.history_fine[k],
                                   r_plain.history_fine[k], rtol=LOSS_RTOL)
    assert r_cached.train_steps == r_plain.train_steps
