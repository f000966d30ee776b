"""The port's layer library (idc_models_tpu_torch/models/core.py) against
the JAX package's layers on carried-over weights, on the CPU.

Tolerance rtol 1e-5 / atol 1e-6: both sides compute in f32 and differ
only in summation order (oneDNN vs XLA on the CPU)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idc_models_tpu.models import core as jcore
from idc_models_tpu_torch import convert
from idc_models_tpu_torch.models import core as tcore

RTOL, ATOL = 1e-5, 1e-6


def _x(seed, shape, scale=1.0):
    return np.random.default_rng(seed).normal(0, scale, shape).astype(
        np.float32)


def _carry(jmod, tmod, seed=0):
    """Init the JAX layer, copy its variables into the port's layer."""
    v = jmod.init(jax.random.key(seed))
    convert.load_jax(tmod, v.params, v.state)
    return v


@pytest.mark.parametrize("k,stride,size", [
    (3, 2, 50), (3, 2, 25), (3, 2, 13), (3, 1, 7), (1, 1, 6), (3, 2, 8),
])
def test_conv2d_same_matches_jax(k, stride, size):
    """TF-SAME is asymmetric at stride 2 on an even size (pads (0, 1));
    the port pads explicitly, so odd and even sizes both line up."""
    cin, cout = 3, 8
    jm = jcore.conv2d(cin, cout, k, stride=stride, name="c")
    tm = tcore.Conv2d(cin, cout, k, stride=stride, name="c")
    v = _carry(jm, tm)
    x = _x(1, (2, size, size, cin))
    want, _ = jm.apply(v.params, v.state, jnp.asarray(x))
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_conv2d_explicit_and_valid_padding_match_jax():
    for padding in ("VALID", ((1, 2), (0, 1))):
        jm = jcore.conv2d(4, 5, 3, stride=2, padding=padding, name="c")
        tm = tcore.Conv2d(4, 5, 3, stride=2, padding=padding, name="c")
        v = _carry(jm, tm)
        x = _x(2, (2, 9, 10, 4))
        want, _ = jm.apply(v.params, v.state, jnp.asarray(x))
        got = tm(torch.from_numpy(x)).detach().numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL,
                                   atol=ATOL, err_msg=str(padding))


@pytest.mark.parametrize("impl", ["grouped", "taps"])
@pytest.mark.parametrize("stride,size", [(1, 8), (1, 7), (2, 8), (2, 7),
                                         (2, 25)])
def test_depthwise_matches_jax(impl, stride, size):
    c = 12
    jm = jcore.depthwise_conv2d(c, 3, stride=stride, use_bias=True,
                                impl=impl, name="dw")
    tm = tcore.DepthwiseConv2d(c, 3, stride=stride, use_bias=True,
                               impl=impl, name="dw")
    v = jm.init(jax.random.key(0))
    params = {"kernel": v.params["kernel"],
              "bias": jnp.asarray(_x(3, (c,)))}
    convert.load_jax(tm, params)
    x = _x(1, (2, size, size, c))
    want, _ = jm.apply(params, v.state, jnp.asarray(x))
    got = tm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_depthwise_rejects_unknown_impl_and_valid_fused():
    with pytest.raises(ValueError, match="grouped"):
        tcore.DepthwiseConv2d(4, impl="winograd")
    with pytest.raises(ValueError, match="SAME"):
        tcore.DepthwiseConv2d(4, impl="fused", padding="VALID")


def _bn_pair(frozen, momentum=0.999):
    jm = jcore.batch_norm(6, momentum=momentum, frozen=frozen, name="bn")
    tm = tcore.BatchNorm(6, momentum=momentum, frozen=frozen, name="bn")
    params = {"scale": jnp.asarray(_x(4, (6,), 0.3) + 1.0),
              "bias": jnp.asarray(_x(5, (6,), 0.3))}
    state = {"mean": jnp.asarray(_x(6, (6,), 0.3)),
             "var": jnp.asarray(np.abs(_x(7, (6,))) + 0.5)}
    convert.load_jax(tm, params, state)
    return jm, tm, params, state


@pytest.mark.parametrize("mode", ["train", "eval", "frozen_train"])
def test_batch_norm_keras_semantics_match_jax(mode):
    """Train: biased batch variance, momentum on the OLD statistic, the
    moving statistics updated in place. Eval: moving statistics. Frozen:
    inference mode whatever the train flag, statistics untouched."""
    frozen = mode == "frozen_train"
    train = mode != "eval"
    jm, tm, params, state = _bn_pair(frozen)
    x = _x(8, (4, 5, 5, 6), 2.0) + 0.7
    want, new_state = jm.apply(params, state, jnp.asarray(x), train=train)
    tm.train(train)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    got = tm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(tm, k).numpy(),
                                   np.asarray(new_state[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
        if mode != "train":
            assert torch.equal(getattr(tm, k), before[k]), k


def test_dense_and_classifier_match_jax():
    jb = jcore.conv2d(3, 8, 3, stride=2, name="stem")
    jm = jcore.classifier(jb, 8, 1, name="clf")
    v = jm.init(jax.random.key(2))

    tb = tcore.Conv2d(3, 8, 3, stride=2, name="stem")
    tm = tcore.Classifier(tb, 8, 1, name="clf")
    # the JAX classifier keys the backbone's variables under "backbone"
    convert.load_jax(tm, v.params, v.state)
    x = _x(9, (3, 10, 10, 3))
    want, _ = jm.apply(v.params, v.state, jnp.asarray(x))
    got = tm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    assert tcore.count_params(tm) == jcore.count_params(v.params)


def test_init_params_is_seeded_and_keras_shaped():
    a = tcore.init_params(tcore.Conv2d(3, 8, 3, name="c"), 0)
    b = tcore.init_params(tcore.Conv2d(3, 8, 3, name="c"), 0)
    c = tcore.init_params(tcore.Conv2d(3, 8, 3, name="c"), 1)
    assert torch.equal(a.kernel, b.kernel)
    assert not torch.equal(a.kernel, c.kernel)
    assert a.kernel.shape == (3, 3, 3, 8)
    limit = np.sqrt(6.0 / (9 * 3 + 9 * 8))     # glorot_uniform
    assert float(a.kernel.detach().abs().max()) <= limit


def test_masks_follow_the_jax_predicates():
    jb = jcore.conv2d(3, 8, 3, name="stem")
    jm = jcore.classifier(jb, 8, 1)
    v = jm.init(jax.random.key(0))
    tm = tcore.Classifier(tcore.Conv2d(3, 8, 3, name="stem"), 8, 1)
    want = convert.flatten(jcore.head_only_mask(v.params))
    got = tcore.head_only_mask(tm)
    assert {k.replace(".", "/"): bool(x) for k, x in got.items()} == {
        k: bool(x) for k, x in want.items()}


@pytest.mark.parametrize("window,stride,padding,size", [
    (2, None, "VALID", 7), (3, 2, "VALID", 9), (3, 2, "SAME", 8),
    (3, 1, "SAME", 5),
])
def test_max_pool_matches_jax(window, stride, padding, size):
    """-inf padding: a padded position never wins, even where every real
    input is negative."""
    x = _x(10, (2, size, size, 3)) - 5.0
    want, _ = jcore.max_pool(window, stride, padding=padding).apply(
        {}, {}, jnp.asarray(x))
    got = tcore.MaxPool(window, stride, padding=padding)(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_max_pool_explicit_padding_matches_the_densenet_stem():
    """The DenseNet stem's 3x3/2 pool with explicit padding 1, as the JAX
    unit writes it with lax.reduce_window."""
    x = _x(11, (2, 16, 16, 4)) - 5.0
    want = jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max,
                                 (1, 3, 3, 1), (1, 2, 2, 1),
                                 [(0, 0), (1, 1), (1, 1), (0, 0)])
    got = tcore.MaxPool(3, 2, padding=((1, 1), (1, 1)))(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("window,stride,padding,size", [
    (2, None, "VALID", 8), (2, None, "VALID", 7), (3, 2, "SAME", 8),
    (3, 1, "SAME", 5), (2, 2, "SAME", 5),
])
def test_avg_pool_matches_jax(window, stride, padding, size):
    """VALID divides by window^2; SAME by the count of real elements.
    The window sums may add in another order: rtol 1e-6."""
    x = _x(12, (2, size, size, 3))
    want, _ = jcore.avg_pool(window, stride, padding=padding).apply(
        {}, {}, jnp.asarray(x))
    got = tcore.AvgPool(window, stride, padding=padding)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_subsequence_and_split_share_the_parent_layers():
    seq = tcore.init_params(tcore.Sequential([
        tcore.Conv2d(3, 4, 3, name="c1"), tcore.ReLU(),
        tcore.Conv2d(4, 4, 3, name="c2"), tcore.ReLU(),
        tcore.Dense(4, 2, name="d")], name="s"), 0)
    assert seq.layer_names == ("c1", "relu", "c2", "relu_0", "d")
    prefix, suffix = tcore.split_sequential(seq, "c2")
    assert prefix.layer_names == ("c1", "relu")
    assert suffix.layer_names == ("c2", "relu_0", "d")
    assert suffix.c2.kernel is seq.c2.kernel
    x = torch.from_numpy(_x(13, (2, 6, 6, 3)))
    assert torch.equal(suffix(prefix(x)), seq(x))
    with pytest.raises(KeyError, match="nope"):
        tcore.split_sequential(seq, "nope")
    with pytest.raises(ValueError, match="contiguous"):
        tcore.subsequence(seq, ["c2", "c1"])
    with pytest.raises(ValueError, match="contiguous"):
        tcore.subsequence(seq, ["c1", "c2"])
    assert torch.equal(tcore.subsequence(seq, [])(x), x)


def test_batch_norm_backward_matches_jax():
    """Train-mode BN saves the centred input, not the input, for its
    second moment's backward (core._MeanSquare); its gradients stay the
    JAX layer's."""
    jm, tm, params, state = _bn_pair(False)
    x = _x(14, (4, 5, 5, 6), 2.0) + 0.7
    r = _x(15, (4, 5, 5, 6))

    def loss(p, x):
        y, _ = jm.apply(p, state, x, train=True)
        return jnp.sum(y * r)

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (tm.train()(xt) * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-4,
                               atol=1e-5)
    for k in ("scale", "bias"):
        np.testing.assert_allclose(getattr(tm, k).grad.numpy(),
                                   np.asarray(gp[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
