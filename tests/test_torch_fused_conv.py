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
    before = tfc.KERNEL.launches, dict(tfc.PATH_LAUNCHES)
    x, w, mul, add = _t(*_inputs(0, 1, 6, 4))
    tfc.fused_depthwise_affine(x, w, mul, add)
    tfc.fused_depthwise_bn_relu6(x, w, mul, add, add, mul, eps=1e-3)
    assert (tfc.KERNEL.launches, tfc.PATH_LAUNCHES) == before


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


# ---------------------------------------------------------------------------
# the kernel's tile plan and path, decided in Python before the launch
# ---------------------------------------------------------------------------

# the op grid of the card tests: C, H = W, stride, kh x kw
OP_GRID = [(c, h, s, k) for c in (1, 6, 8, 960) for h in (1, 2, 4, 25, 50)
           for s in (1, 2) for k in ((1, 1), (3, 3), (5, 5), (3, 1))]


def _walk_plan(n, h, w, c, kh, kw, sh, sw, t):
    """Walk tile plan `t` as the kernel's index arithmetic does: every
    block (slab fastest), every tile of its walk, every thread (channel
    vector, strip, row), every output of its strip. Returns how many
    times each output element of [n, Ho, Wo, C] is written, after
    checking that each output's taps lie inside its tile's staged window
    and that the window starts at the output's TF-SAME receptive
    field."""
    ho, wo, (pt, _), (pl, _) = tfc.same_pads(h, w, kh, kw, sh, sw)
    assert t.strip <= tfc.MAX_STRIP and t.rows <= tfc.MAX_ROWS
    assert np.prod(t.threads) <= tfc.MAX_THREADS
    assert t.smem <= tfc.SMEM_BUDGET
    assert t.walk == 1 or sh == 1
    assert t.rows_in == (t.rows - 1) * sh + kh
    assert t.cols_in == (t.cols - 1) * sw + kw
    assert t.cvec * t.width * t.slabs == c
    tiles = n * t.row_tiles * t.col_tiles
    assert t.blocks == -(-tiles // t.walk) * t.slabs
    cvec, ns, bz = t.threads
    assert ns == -(-t.cols // t.strip) and bz == t.rows
    # axes: block, tile of the walk, thread x, y, z, output of the strip
    block = np.arange(t.blocks).reshape(-1, 1, 1, 1, 1, 1)
    slab, group = block % t.slabs, block // t.slabs
    index = group * t.walk + np.arange(t.walk).reshape(1, -1, 1, 1, 1, 1)
    tx = np.arange(cvec).reshape(1, 1, -1, 1, 1, 1)
    ty = np.arange(ns).reshape(1, 1, 1, -1, 1, 1)
    r = np.arange(bz).reshape(1, 1, 1, 1, -1, 1)
    o = np.arange(t.strip).reshape(1, 1, 1, 1, 1, -1)
    ct = index % t.col_tiles
    rt = index // t.col_tiles % t.row_tiles
    img = index // t.col_tiles // t.row_tiles
    ho0, wo0 = rt * t.rows, ct * t.cols
    s0 = ty * t.strip
    live = ((index < tiles) & (r < np.minimum(t.rows, ho - ho0))
            & (o < np.minimum(t.strip, np.minimum(t.cols, wo - wo0) - s0)))
    shape = np.broadcast_shapes(*(a.shape for a in (
        live, img, ho0, wo0, r, s0, o, slab, tx)))
    live = np.broadcast_to(live, shape)

    def at(a):
        return np.broadcast_to(a, shape)[live]

    out_r, out_c = at(ho0 + r), at(wo0 + s0 + o)
    # the last tap of each output is staged, and the window's origin
    # (ih0, iw0) is where the output's receptive field starts
    assert (at(r) * sh + kh - 1 < t.rows_in).all()
    assert (at(s0 + o) * sw + kw - 1 < t.cols_in).all()
    assert (at(ho0 * sh - pt + r * sh) == out_r * sh - pt).all()
    assert (at(wo0 * sw - pl + (s0 + o) * sw) == out_c * sw - pl).all()
    ch = at(slab * cvec * t.width + tx * t.width)
    pix = (at(img) * ho + out_r) * wo + out_c
    seen = sum(np.bincount(pix * c + ch + v, minlength=n * ho * wo * c)
               for v in range(t.width))
    return seen.reshape(n, ho, wo, c)


@pytest.mark.parametrize("batch", [32, 4096])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_tile_plan_covers_every_output_once_at_the_main_path_shapes(
        batch, itemsize):
    """The 3x3 path's plans at every `fused_call_shapes` entry. The plan
    is the one of `batch` images; the walk covers 3 of them (the same
    tiles repeat for every image), with a walk across image
    boundaries."""
    for call in tmobile.fused_call_shapes(batch, 50):
        c, h, s = call["c"], call["h_in"], call["stride"]
        t = tfc.depthwise_tiles(batch, h, h, c, 3, 3, s, s, itemsize)
        assert t.blocks == -(-batch * t.row_tiles * t.col_tiles
                             // t.walk) * t.slabs
        three = t._replace(blocks=-(-3 * t.row_tiles * t.col_tiles
                                    // t.walk) * t.slabs)
        seen = _walk_plan(3, h, h, c, 3, 3, s, s, three)
        assert (seen == 1).all(), f"{call}: plan {t}"


@pytest.mark.parametrize("k", [(1, 1), (3, 3), (5, 5), (3, 1)])
def test_tile_plan_covers_every_output_once_on_the_op_grid(k):
    kh, kw = k
    for c, h, s, _ in [g for g in OP_GRID if g[3] == k]:
        for itemsize in (4, 2):
            vec = tfc.depthwise_path(c, kh, kw, s, s, itemsize,
                                     vector_ok=True)
            for path in {vec, "scalar"}:
                t = tfc.depthwise_tiles(2, h, h, c, kh, kw, s, s, itemsize,
                                        path)
                seen = _walk_plan(2, h, h, c, kh, kw, s, s, t)
                assert (seen == 1).all(), (c, h, s, k, itemsize, path)


def test_tile_plan_fills_the_card_and_walks_only_large_stride_1_calls():
    for call in tmobile.fused_call_shapes(32, 50):
        t = tfc.depthwise_tiles(32, call["h_in"], call["h_in"], call["c"],
                                3, 3, call["stride"], call["stride"], 4)
        assert t.blocks >= tfc.FILL_BLOCKS and t.walk == 1
    walks = [tfc.depthwise_tiles(4096, c["h_in"], c["h_in"], c["c"], 3, 3,
                                 c["stride"], c["stride"], 4).walk
             for c in tmobile.fused_call_shapes(4096, 50)]
    assert walks == [2 if c["stride"] == 1 else 1
                     for c in tmobile.fused_call_shapes(4096, 50)]


def test_tile_plan_tiles_wide_rows_into_columns():
    """A row too wide for the shared-memory budget is cut into column
    tiles, still covering every output once."""
    t = tfc.depthwise_tiles(1, 3, 3000, 64, 3, 3, 1, 1, 4)
    assert t.col_tiles > 1 and t.smem <= tfc.SMEM_BUDGET
    seen = _walk_plan(1, 3, 3000, 64, 3, 3, 1, 1, t)
    assert (seen == 1).all()


def test_path_predicate():
    """3x3 vector, general vector and scalar-channel, chosen from shapes,
    strides and pointers before the launch."""
    x = torch.zeros(2, 9, 9, 8)
    w = torch.zeros(3, 3, 1, 8)
    assert tfc.vector_ok(x, w)
    for (kh, kw, sh, sw, c, itemsize), want in {
            (3, 3, 1, 1, 8, 4): "3x3", (3, 3, 2, 2, 960, 4): "3x3",
            (3, 3, 1, 1, 16, 2): "3x3", (5, 5, 1, 1, 8, 4): "general",
            (3, 1, 1, 1, 8, 4): "general", (3, 3, 1, 2, 8, 4): "general",
            (1, 1, 2, 2, 960, 4): "general", (3, 3, 1, 1, 6, 4): "scalar",
            (3, 3, 1, 1, 1, 4): "scalar", (3, 3, 1, 1, 12, 2): "scalar",
    }.items():
        assert tfc.depthwise_path(c, kh, kw, sh, sw, itemsize,
                                  vector_ok=True) == want
    assert tfc.depthwise_path(8, 3, 3, 1, 1, 4, vector_ok=False) == "scalar"
    # misaligned: a view at a 1-element storage offset
    base = torch.zeros(2 * 9 * 9 * 8 + 1)
    assert not tfc.vector_ok(base[1:].view(2, 9, 9, 8), w)
    # channel-strided (an NHWC view of NCHW memory) and a W stride that
    # is not a whole vector
    assert not tfc.vector_ok(torch.zeros(2, 8, 9, 9).permute(0, 2, 3, 1), w)
    assert not tfc.vector_ok(torch.zeros(2, 9, 9, 6)[..., :4], w)
    # strided but whole vectors (a W-H transpose) keeps the vector path
    assert tfc.vector_ok(x.transpose(1, 2), w)
    # bf16 vectors are 8 channels: an offset of 8 keeps 16-byte starts
    xb = torch.zeros(2, 9, 9, 16, dtype=torch.bfloat16)
    assert tfc.vector_ok(xb[..., 8:], w)
    assert not tfc.vector_ok(xb[..., 4:12], w)


# ---------------------------------------------------------------------------
# the batchnorm chain, which the kernel folds inside its launch
# ---------------------------------------------------------------------------


def _bn_inputs(seed, n, size, c):
    x, w, _, _ = _inputs(seed, n, size, c)
    rng = np.random.default_rng(seed + 1)
    scale, bias, mean = (rng.normal(0, 0.5, (c,)).astype(np.float32)
                         for _ in range(3))
    var = (rng.random(c) + 0.5).astype(np.float32)
    return x, w, scale, bias, mean, var


@pytest.mark.parametrize("stride,size,c", [(1, 9, 12), (2, 9, 12),
                                           (2, 8, 6)])
def test_bn_chain_forward_and_vjp_match_jax_pallas(stride, size, c):
    """The plain BN-mode function (`reference_bn_impl`, the CPU path and
    the backward of the BN autograd.Function) against the JAX package's
    `fused_depthwise_bn_relu6` in interpret mode: forward, and the vjp
    for x, w and all four BN tensors."""
    ins = _bn_inputs(7, 2, size, c)
    ho = -(-size // stride)
    g = np.random.default_rng(8).normal(0, 1, (2, ho, ho, c))
    g = g.astype(np.float32)
    ts = [t.requires_grad_() for t in _t(*ins)]
    got = tfc.fused_depthwise_bn_relu6(*ts, eps=1e-3, stride=stride)
    got.backward(torch.from_numpy(g))
    want, vjp = jax.vjp(lambda *a: jfc.fused_depthwise_bn_relu6(
        *a, eps=1e-3, stride=stride, interpret=True),
        *map(jnp.asarray, ins))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    plain = tfc.reference_bn_impl(*_t(*ins), eps=1e-3, stride=stride)
    assert torch.equal(got.detach(), plain)
    for name, t, w_ in zip("x w scale bias mean var".split(), ts,
                           vjp(jnp.asarray(g))):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w_),
                                   rtol=RTOL, atol=1e-5,
                                   err_msg=f"d{name}")


def test_bn_chain_without_grad_runs_the_plain_version_directly():
    """No input needs a gradient: the wrapper calls the plain version
    (on the card, the kernel) without an autograd.Function, with the
    same values."""
    ins = _t(*_bn_inputs(9, 1, 7, 8))
    with torch.no_grad():
        got = tfc.fused_depthwise_bn_relu6(*ins, eps=1e-3, stride=2)
    assert got.grad_fn is None
    assert torch.equal(got, tfc.reference_bn_impl(*ins, eps=1e-3, stride=2))
    want = tfc.fused_depthwise_affine(
        ins[0], ins[1], *tfc.fold_bn(*ins[2:], 1e-3), stride=2)
    assert torch.equal(got, want)
