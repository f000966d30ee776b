"""The port's MobileNetV2 (idc_models_tpu_torch/models/mobilenet.py)
against the JAX package's, at full width on a small input, on the CPU.

Weights come from the JAX `model.init`, with every BN's parameters and
moving statistics replaced by seeded random values (so the BNs are far
from identity), carried over by convert.py. The JAX side runs its plain
path (depthwise_impl="grouped"); the port runs its fused build, whose
wrapper takes the plain version on CPU tensors, and its grouped build.
Forward tolerance rtol 1e-4 / atol 1e-4 (52 layers of f32 summed in
different orders); gradients rtol 5e-3 / atol 1e-3, as
tests/test_fused_conv.py holds the JAX fused backward.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idc_models_tpu.models import mobilenet as jmobile
from idc_models_tpu.models import pretrained as jpretrained
from idc_models_tpu_torch import convert
from idc_models_tpu_torch.models import core as tcore
from idc_models_tpu_torch.models import mobilenet as tmobile
from idc_models_tpu_torch.models import pretrained as tpretrained
from idc_models_tpu_torch.ops import fused_conv as tfc

FWD_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=5e-3, atol=1e-3)
PHASE2 = 100            # the mobile preset's fine_tune_at


@functools.lru_cache(maxsize=None)
def _jax_variables():
    """JAX init of the full classifier, BN parameters and statistics
    randomised (numpy, seeded); (params, state) as numpy trees."""
    v = jmobile.mobilenet_v2(1).init(jax.random.key(0))
    rng = np.random.default_rng(7)
    params = convert.flatten(jax.tree.map(np.asarray, v.params))
    state = convert.flatten(jax.tree.map(np.asarray, v.state))
    for k, a in params.items():
        if k.endswith("/scale"):
            params[k] = (1.0 + rng.normal(0, 0.2, a.shape)).astype(np.float32)
        elif "_BN/" in k or "bn_" in k or "_bn/" in k:
            params[k] = rng.normal(0, 0.2, a.shape).astype(np.float32)
    for k, a in state.items():
        if k.endswith("/mean"):
            state[k] = rng.normal(0, 0.2, a.shape).astype(np.float32)
        else:
            state[k] = (0.5 + rng.random(a.shape)).astype(np.float32)
    return convert.unflatten(params), convert.unflatten(state)


def _jax(bn_frozen_below):
    return jmobile.mobilenet_v2(1, bn_frozen_below=bn_frozen_below,
                                depthwise_impl="grouped")


def _port(bn_frozen_below, impl="fused"):
    m = tmobile.mobilenet_v2(1, bn_frozen_below=bn_frozen_below,
                             depthwise_impl=impl)
    return convert.load_jax(m, *_jax_variables())


def _images(size, n=2, seed=3):
    return np.random.default_rng(seed).random((n, size, size, 3),
                                              dtype=np.float32)


def test_param_count_and_keras_index_match_jax():
    m = tmobile.mobilenet_v2_backbone()
    total = (tcore.count_params(m)
             + sum(b.numel() for b in m.buffers()))
    assert total == 2_257_984
    assert tmobile.KERAS_LAYER_INDEX == jmobile.KERAS_LAYER_INDEX
    assert tmobile._BLOCKS == jmobile._BLOCKS
    assert m.layer_names == tuple(jmobile.KERAS_LAYER_INDEX)


@pytest.mark.parametrize("impl", ["fused", "grouped"])
def test_eval_forward_matches_jax(impl):
    params, state = _jax_variables()
    x = _images(25)
    want, _ = _jax(0).apply(params, state, jnp.asarray(x), train=False)
    model = _port(0, impl).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 1)
    np.testing.assert_allclose(got, np.asarray(want), **FWD_TOL)


def test_frozen_train_forward_matches_jax_and_leaves_state_alone():
    """Phase 1: every BN frozen, so all 17 fused chains run in train mode;
    the output matches and the BN statistics stay bit-identical."""
    params, state = _jax_variables()
    x = _images(25)
    want, _ = _jax(jmobile.FREEZE_ALL).apply(params, state, jnp.asarray(x),
                                             train=True)
    model = _port(tmobile.FREEZE_ALL).train()
    before = {k: v.clone() for k, v in model.named_buffers()}
    got = model(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), **FWD_TOL)
    for k, v in model.named_buffers():
        assert torch.equal(v, before[k]), f"frozen BN state drifted at {k}"


def test_phase2_train_forward_matches_jax_state_update():
    """Phase 2 at fine_tune_at=100: the chains below it fused, the rest
    on batch statistics, whose moving statistics update as JAX's do. At
    50x50 the last blocks are 2x2, so batch 8 gives each batch statistic
    32 samples (at 25x25 they would see 1x1 maps and two samples: too
    ill-conditioned to compare two summation orders). Even so, six
    batch-statistics BNs amplify rounding: the JAX reference's own f32
    logits here stray from its f64 ones by 1.2e-4 (8e-4 relative), so
    logits are held to rtol 2e-3 / atol 3e-4; the statistics to 1e-4."""
    params, state = _jax_variables()
    x = _images(50, n=8)
    want, new_state = _jax(PHASE2).apply(params, state, jnp.asarray(x),
                                         train=True)
    model = _port(PHASE2).train()
    got = model(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-3, atol=3e-4)
    want_state = convert.flatten(jax.tree.map(np.asarray, new_state))
    _, got_state = convert.to_jax(model)
    got_state = convert.flatten(got_state)
    assert set(got_state) == set(want_state)
    for k, v in want_state.items():
        np.testing.assert_allclose(got_state[k], v, **FWD_TOL, err_msg=k)
    moved = [k for k, v in got_state.items()
             if not np.array_equal(v, convert.flatten(state)[k])]
    assert moved and all(tmobile.KERAS_LAYER_INDEX[k.split("/")[1]] >= PHASE2
                         for k in moved)


@pytest.mark.parametrize("bn_frozen_below,train,calls", [
    (tmobile.FREEZE_ALL, True, 17), (PHASE2, True, 11), (PHASE2, False, 17),
])
def test_fused_chain_count(monkeypatch, bn_frozen_below, train, calls):
    """How many chains one forward sends through the kernel's wrapper:
    the count chip_smoke.py holds the kernel's launch counter to."""
    seen = []
    real = tfc.fused_depthwise_bn_relu6
    monkeypatch.setattr(tfc, "fused_depthwise_bn_relu6",
                        lambda *a, **k: seen.append(1) or real(*a, **k))
    model = tmobile.mobilenet_v2(1, bn_frozen_below=bn_frozen_below,
                                 depthwise_impl="fused").train(train)
    tcore.init_params(model, 0)
    with torch.no_grad():
        model(torch.from_numpy(_images(13)))
    assert len(seen) == calls
    assert tmobile.fused_chain_count(bn_frozen_below, train=train) == calls
    # the kernel runs whole chains only: the layers of the others are the
    # grouped (cuDNN) conv, so a launch count is the count of chains
    assert {m.impl for m in model.modules()
            if isinstance(m, tcore.DepthwiseConv2d)} == {"grouped"}


def test_fine_tune_masks_match_jax():
    params, _ = _jax_variables()
    model = _port(PHASE2)
    for got, want in (
            (tmobile.fine_tune_mask(model, PHASE2),
             jmobile.fine_tune_mask(params, PHASE2)),
            (tmobile.head_only_mask(model),
             jmobile.head_only_mask(params))):
        want = convert.flatten(want)
        assert {k.replace(".", "/"): v for k, v in got.items()} == {
            k: bool(v) for k, v in want.items()}
    n_train = sum(p.numel() for n, p in model.named_parameters()
                  if tmobile.fine_tune_mask(model, PHASE2)[n])
    assert 0 < n_train < tcore.count_params(model)


def test_gradients_match_jax():
    """d(sum r*y)/d(params) of the backbone in train mode with every BN
    frozen (phase 1's build) at 13x13, r a fixed random projection: the
    fused chains' autograd.Function backward against JAX autodiff of the
    grouped path. (Phase 2 sends no gradient into the fused chains: all
    of them sit below fine_tune_at, frozen, with no trainable input. Its
    full-backbone gradients are not compared leaf by leaf: through
    train-mode BNs on 2x2 maps even the JAX reference's f32 gradients
    stray from its own f64 ones by more than 5e-3.)"""
    params, state = _jax_variables()
    size, n, bn_frozen_below = 13, 2, tmobile.FREEZE_ALL
    x = _images(size, n=n)
    out = -(-size // 32)
    r = np.random.default_rng(11).normal(0, 1, (n, out, out, 1280))
    r = r.astype(np.float32)
    jm = jmobile.mobilenet_v2_backbone(3, bn_frozen_below=bn_frozen_below)

    def loss(p):
        y, _ = jm.apply(p, state["backbone"], jnp.asarray(x), train=True)
        return jnp.sum(y * r)

    want = convert.flatten(jax.tree.map(
        np.asarray, jax.jit(jax.grad(loss))(params["backbone"])))
    model = _port(bn_frozen_below).backbone.train()
    (model(torch.from_numpy(x)) * torch.from_numpy(r)).sum().backward()
    got = {k.replace(".", "/"): p.grad.numpy()
           for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, **GRAD_TOL, err_msg=k)


def test_convert_round_trip_and_port_weights_in_jax():
    """JAX trees -> port -> JAX trees is exact, and the port's exported
    trees drive the JAX model to the port's own logits."""
    params, state = _jax_variables()
    model = _port(0).eval()
    p2, s2 = convert.to_jax(model)
    for a, b in ((params, p2), (state, s2)):
        fa, fb = convert.flatten(a), convert.flatten(b)
        assert set(fa) == set(fb)
        for k in fa:
            assert fa[k].shape == fb[k].shape
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    x = _images(13)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want, _ = _jax(0).apply(p2, s2, jnp.asarray(x), train=False)
    np.testing.assert_allclose(got, np.asarray(want), **FWD_TOL)


def test_jax_save_npz_loads_into_port(tmp_path):
    """A backbone artifact written by the JAX package's save_npz (the
    convert-weights layout, {"params", "state"}) loads straight into the
    port's backbone through --pretrained-weights' loader."""
    params, state = _jax_variables()
    path = tmp_path / "backbone.npz"
    jpretrained.save_npz(path, {"params": params["backbone"],
                                "state": state["backbone"]})
    model = tcore.init_params(tmobile.mobilenet_v2(1), 1)
    head_before = model.head.kernel.detach().clone()
    tpretrained.maybe_load_pretrained(model, path)
    got_p, got_s = convert.to_jax(model)
    for want, got in ((params["backbone"], got_p["backbone"]),
                      (state["backbone"], got_s["backbone"])):
        fw, fg = convert.flatten(want), convert.flatten(got)
        assert set(fw) == set(fg)
        for k in fw:
            np.testing.assert_array_equal(fg[k], fw[k], err_msg=k)
    assert torch.equal(model.head.kernel, head_before)   # head untouched
