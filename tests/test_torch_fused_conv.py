"""The port's fused depthwise chain (idc_models_tpu_torch/ops/fused_conv.py)
against the JAX package's.

On the CPU the port's wrapper runs its plain version, so these tests hold
that plain version against the JAX reference (`reference_impl`) and the
JAX Pallas kernel in interpret mode (its default off-TPU), on the grid of
tests/test_fused_conv.py: rtol 1e-5 / atol 1e-6, as both accumulate in
f32. The CUDA kernel itself is held against the plain version on the
card by tests/test_torch_gpu.py and chip_smoke.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idc_models_tpu.models import core as jcore
from idc_models_tpu.models import mobilenet as jmobile
from idc_models_tpu.ops import fused_conv as jfc
from idc_models_tpu_torch.models import core as tcore
from idc_models_tpu_torch.models import mobilenet as tmobile
from idc_models_tpu_torch.ops import fused_conv as tfc

RTOL, ATOL = 1e-5, 1e-6


def _inputs(seed, n, size, c):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, size, size, c)).astype(np.float32)
    w = rng.normal(0, 0.3, (3, 3, 1, c)).astype(np.float32)
    mul = (rng.normal(0, 0.5, (c,)) + 1.0).astype(np.float32)
    add = rng.normal(0, 0.5, (c,)).astype(np.float32)
    return x, w, mul, add


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("stride,size,c", [
    (1, 8, 6), (2, 7, 6), (2, 25, 32), (1, 25, 96),
])
@pytest.mark.parametrize("clamp6", [True, False])
def test_plain_matches_jax_reference_and_pallas(stride, size, c, clamp6):
    x, w, mul, add = _inputs(0, 2, size, c)
    got = tfc.fused_depthwise_affine(*_t(x, w, mul, add), stride=stride,
                                     clamp6=clamp6).numpy()
    want_ref = jfc.reference_impl(*map(jnp.asarray, (x, w, mul, add)),
                                  stride=stride, clamp6=clamp6)
    want_pallas = jfc.fused_depthwise_affine(
        *map(jnp.asarray, (x, w, mul, add)), stride=stride, clamp6=clamp6,
        interpret=True)
    assert got.shape == want_ref.shape
    np.testing.assert_allclose(got, np.asarray(want_ref), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(want_pallas), rtol=RTOL,
                               atol=ATOL)


def test_full_mobilenet_schedule_matches_jax_reference():
    """Every (spatial, channels, stride) the chain sees in MobileNetV2 at
    50x50 patches (fused_call_shapes), odd 25x25 and 13x13 edges too."""
    calls = tmobile.fused_call_shapes(1, 50)
    assert calls == jmobile.fused_call_shapes(1, 50)
    for k, call in enumerate(calls):
        c, s = call["c"], call["stride"]
        x, w, mul, add = _inputs(k, 1, call["h_in"], c)
        got = tfc.fused_depthwise_affine(*_t(x, w, mul, add),
                                         stride=s).numpy()
        want = jfc.reference_impl(*map(jnp.asarray, (x, w, mul, add)),
                                  stride=s)
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL,
                                   atol=ATOL, err_msg=f"entry {call}")


def test_fold_bn_matches_jax():
    rng = np.random.default_rng(1)
    scale, bias, mean = (rng.normal(0, 1, (40,)).astype(np.float32)
                         for _ in range(3))
    var = (rng.random(40) + 0.1).astype(np.float32)
    got = tfc.fold_bn(*_t(scale, bias, mean, var), 1e-3)
    want = jfc.fold_bn(*map(jnp.asarray, (scale, bias, mean, var)), 1e-3)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=RTOL,
                                   atol=ATOL)


def test_bn_relu6_chain_matches_jax():
    x, w, _, _ = _inputs(2, 2, 9, 12)
    rng = np.random.default_rng(3)
    scale, bias, mean = (rng.normal(0, 0.5, (12,)).astype(np.float32)
                         for _ in range(3))
    var = (rng.random(12) + 0.5).astype(np.float32)
    got = tfc.fused_depthwise_bn_relu6(*_t(x, w, scale, bias, mean, var),
                                       eps=1e-3, stride=2).numpy()
    want = jfc.reference_impl(
        jnp.asarray(x), jnp.asarray(w),
        *jfc.fold_bn(*map(jnp.asarray, (scale, bias, mean, var)), 1e-3),
        stride=2)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_channel_tile_must_divide():
    x, w, mul, add = _t(*_inputs(0, 1, 5, 6))
    with pytest.raises(ValueError, match="divide"):
        tfc.fused_depthwise_affine(x, w, mul, add, channel_tile=4)
    # a dividing tile changes nothing
    got = tfc.fused_depthwise_affine(x, w, mul, add, channel_tile=2)
    want = tfc.fused_depthwise_affine(x, w, mul, add)
    assert torch.equal(got, want)


@pytest.mark.parametrize("stride,clamp6", [(1, True), (2, True), (2, False)])
def test_backward_matches_jax_vjp_of_reference(stride, clamp6):
    """The autograd.Function's backward (autograd through the plain
    version at the saved inputs) against jax.vjp of reference_impl, the
    JAX custom_vjp's backward, for all four inputs."""
    x, w, mul, add = _inputs(4, 2, 11, 16)
    g = np.random.default_rng(5).normal(0, 1, (2, -(-11 // stride),
                                               -(-11 // stride), 16))
    g = g.astype(np.float32)
    ts = [t.requires_grad_() for t in _t(x, w, mul, add)]
    y = tfc.fused_depthwise_affine(*ts, stride=stride, clamp6=clamp6)
    y.backward(torch.from_numpy(g))
    _, vjp = jax.vjp(lambda *a: jfc.reference_impl(
        *a, stride=stride, clamp6=clamp6),
        *map(jnp.asarray, (x, w, mul, add)))
    for name, t, want in zip("x w mul add".split(), ts,
                             vjp(jnp.asarray(g))):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=1e-5,
                                   err_msg=f"d{name}")


def test_cpu_call_never_counts_a_launch():
    before = tfc.KERNEL.launches
    x, w, mul, add = _t(*_inputs(0, 1, 6, 4))
    tfc.fused_depthwise_affine(x, w, mul, add)
    tfc.fused_depthwise_bn_relu6(x, w, mul, add, add, mul, eps=1e-3)
    assert tfc.KERNEL.launches == before


@pytest.mark.parametrize("stride,size", [(1, 8), (2, 7), (2, 25)])
def test_fused_module_matches_jax_grouped(stride, size):
    """DepthwiseConv2d(impl="fused") (identity affine) against the JAX
    layer's XLA grouped lowering, on carried-over weights."""
    c = 16
    jm = jcore.depthwise_conv2d(c, 3, stride=stride, impl="grouped",
                                name="dw")
    v = jm.init(jax.random.key(0))
    x = np.random.default_rng(1).normal(0, 1, (2, size, size, c))
    x = x.astype(np.float32)
    want, _ = jm.apply(v.params, v.state, jnp.asarray(x))
    tm = tcore.DepthwiseConv2d(c, 3, stride=stride, impl="fused", name="dw")
    tm.load_state_dict({"kernel": torch.from_numpy(
        np.array(v.params["kernel"]))})
    got = tm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, w, mul, add = _t(*_inputs(0, 1, 5, 6))
    with pytest.raises(ValueError, match="CUDA"):
        tfc._launch(x, w, mul, add, (1, 1), True)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfc._launch(x.double(), w, mul, add, (1, 1), True)
    with pytest.raises(ValueError, match="channels"):
        tfc._launch(x, w[..., :4], mul, add, (1, 1), True)


@pytest.mark.parametrize("batch,itemsize", [(32, 4), (4096, 4), (8, 2)])
def test_chain_cost_matches_jax(batch, itemsize):
    """The analytic flops/bytes of the 17 calls, which PERF.md's bound
    quotes, count as the JAX package counts them."""
    calls = tmobile.fused_call_shapes(batch, 50)
    assert tfc.depthwise_chain_cost(calls, itemsize=itemsize) == \
        jfc.depthwise_chain_cost(calls, itemsize=itemsize)
    assert tfc.depthwise_call_cost(2, 7, 8, 6, stride=2) == \
        jfc.depthwise_call_cost(2, 7, 8, 6, stride=2)
