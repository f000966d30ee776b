"""The port's CUDA kernels on the card, against their plain PyTorch
versions.

Every test here is marked `gpu` and skips without a CUDA card. The file
imports neither JAX nor the JAX package, so it runs on a machine with
PyTorch alone; there, skip the JAX-pod conftest:

    python -m pytest tests/test_torch_gpu.py --noconftest -m gpu -q

TF32 is off in every test (cuDNN's default would round the grouped
reference's products to TF32).
"""

from __future__ import annotations

import pytest
import torch

from idc_models_tpu_torch import ring_attention as tring
from idc_models_tpu_torch.federated.fedavg import ServerState
from idc_models_tpu_torch.data.idc import ArrayDataset
from idc_models_tpu_torch.models import (
    core, densenet, mobilenet, registry, small_cnn,
)
from idc_models_tpu_torch.ops import flash_block_kernel as fbk
from idc_models_tpu_torch.ops import fused_conv as fc
from idc_models_tpu_torch.ops import secure_masking_kernel as smk
from idc_models_tpu_torch.secure.fedavg import make_secure_fedavg_round
from idc_models_tpu_torch.train import feature_cache
from idc_models_tpu_torch.train.loop import predict
from idc_models_tpu_torch.train.losses import binary_cross_entropy

pytestmark = pytest.mark.gpu

F32_TOL = dict(rtol=1e-5, atol=1e-6)    # same f32 arithmetic, same order
BF16_TOL = dict(rtol=1e-2, atol=1e-2)   # one bf16 rounding of equal f32 sums


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _inputs(gen, n, h, c, dtype=torch.float32):
    x = torch.randn(n, h, h, c, device="cuda", generator=gen).to(dtype)
    w = torch.randn(3, 3, 1, c, device="cuda", generator=gen) * 0.3
    mul = torch.randn(c, device="cuda", generator=gen) * 0.5 + 1.0
    add = torch.randn(c, device="cuda", generator=gen) * 0.5
    return x, w, mul, add


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_at_every_main_path_shape(cuda, dtype):
    """f32 equals the plain version bit for bit (the same roundings in
    the same order); bf16 within one bf16 rounding."""
    dt = getattr(torch, dtype)
    for call in mobilenet.fused_call_shapes(2, 50):
        x, w, mul, add = _inputs(cuda, 2, call["h_in"], call["c"], dt)
        before = fc.KERNEL.launches, fc.PATH_LAUNCHES["3x3"]
        got = fc.fused_depthwise_affine(x, w, mul, add,
                                        stride=call["stride"])
        torch.cuda.synchronize()
        assert (fc.KERNEL.launches, fc.PATH_LAUNCHES["3x3"]) == (
            before[0] + 1, before[1] + 1)
        assert got.dtype == dt and got.is_cuda
        want = fc.reference_impl(x, w, mul, add, stride=call["stride"])
        if dt == torch.float32:
            assert torch.equal(got, want), call
        else:
            torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)


def test_walking_plans_equal_plain(cuda):
    """At a batch large enough that stride-1 plans walk two tiles a
    block (double-buffered windows), f32 still equals the plain version
    bit for bit."""
    walked = 0
    for call in mobilenet.fused_call_shapes(512, 50):
        x, w, mul, add = _inputs(cuda, 512, call["h_in"], call["c"])
        s = call["stride"]
        walked += fc.depthwise_tiles(512, call["h_in"], call["h_in"],
                                     call["c"], 3, 3, s, s, 4).walk > 1
        got = fc.fused_depthwise_affine(x, w, mul, add, stride=s)
        assert torch.equal(got, fc.reference_impl(x, w, mul, add, stride=s))
    assert walked > 0


# the op grid: C, H = W, kh x kw; both strides and dtypes below
OP_C, OP_H = (1, 6, 8, 960), (1, 2, 4, 25, 50)


@pytest.mark.parametrize("k", [(1, 1), (3, 3), (5, 5), (3, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_the_op_grid(cuda, k, dtype):
    """Every C in OP_C, H = W in OP_H (odd and even sizes at stride 2),
    stride 1 and 2, clamp on and off: the path the predicate names is the
    one whose count moves, by one a call."""
    dt = getattr(torch, dtype)
    kh, kw = k
    for c in OP_C:
        for h in OP_H:
            for s in (1, 2):
                x = torch.randn(2, h, h, c, device="cuda",
                                generator=cuda).to(dt)
                w = torch.randn(kh, kw, 1, c, device="cuda",
                                generator=cuda) * 0.3
                mul = torch.randn(c, device="cuda", generator=cuda) + 1.0
                add = torch.randn(c, device="cuda", generator=cuda) * 0.5
                clamp = (h + c + s) % 2 == 0
                path = fc.depthwise_path(c, kh, kw, s, s, x.element_size(),
                                         vector_ok=fc.vector_ok(x, w))
                before = dict(fc.PATH_LAUNCHES)
                got = fc.fused_depthwise_affine(x, w, mul, add, stride=s,
                                                clamp6=clamp)
                torch.cuda.synchronize()
                assert {p: fc.PATH_LAUNCHES[p] - before[p]
                        for p in fc.PATHS} == {
                    p: int(p == path) for p in fc.PATHS}
                want = fc.reference_impl(x, w, mul, add, stride=s,
                                         clamp6=clamp)
                if dt == torch.float32:
                    assert torch.equal(got, want), (c, h, s, k, path)
                else:
                    torch.testing.assert_close(
                        got.float(), want.float(), **BF16_TOL,
                        msg=lambda m: f"{(c, h, s, k, path)}: {m}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_misaligned_and_strided_x(cuda, dtype):
    """x as a view at a 1-element storage offset (scalar path), as an
    NHWC view of NCHW memory (scalar path, channel stride H*W) and as a
    W-H transpose (the 3x3 vector path at the strides given)."""
    dt = getattr(torch, dtype)
    _, w, mul, add = _inputs(cuda, 2, 13, 64)
    base = torch.randn(2 * 13 * 13 * 64 + 1, device="cuda",
                       generator=cuda).to(dt)
    views = [
        ("scalar", base[1:].view(2, 13, 13, 64)),
        ("scalar", torch.randn(2, 64, 13, 13, device="cuda",
                               generator=cuda).to(dt).permute(0, 2, 3, 1)),
        ("3x3", base[:-1].view(2, 13, 13, 64).transpose(1, 2)),
    ]
    for path, x in views:
        before = fc.PATH_LAUNCHES[path]
        for s in (1, 2):
            got = fc.fused_depthwise_affine(x, w, mul, add, stride=s)
            want = fc.reference_impl(x, w, mul, add, stride=s)
            if dt == torch.float32:
                assert torch.equal(got, want), (path, s)
            else:
                torch.testing.assert_close(got.float(), want.float(),
                                           **BF16_TOL)
        assert fc.PATH_LAUNCHES[path] == before + 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [8, 6])
def test_padding_taps_multiply_zero_by_the_weight(cuda, dtype, c):
    """An inf weight on the tap that falls in the TF-SAME padding gives
    0 * inf = NaN along the top row and the left column, as both
    references compute; a kernel that skipped padding taps would hide
    it."""
    dt = getattr(torch, dtype)
    x, w, mul, add = _inputs(cuda, 1, 5, c, dt)   # pads (1, 1) at both
    w[0, 0, 0, 0] = float("inf")
    for s in (1, 2):
        got = fc.fused_depthwise_affine(x, w, mul, add, stride=s,
                                        clamp6=False)
        want = fc.reference_impl(x, w, mul, add, stride=s, clamp6=False)
        assert got[..., 0].isnan().any()
        assert torch.equal(got.isnan(), want.isnan())
        torch.testing.assert_close(got.float(), want.float(), equal_nan=True,
                                   **(F32_TOL if dt == torch.float32
                                      else BF16_TOL))


def test_nan_in_x_passes_through_the_clamp(cuda):
    for c in (8, 6):
        x, w, mul, add = _inputs(cuda, 1, 6, c)
        x[0, 2, 2, c - 1] = float("nan")
        got = fc.fused_depthwise_affine(x, w, mul, add)
        want = fc.reference_impl(x, w, mul, add)
        assert got.isnan().sum() == 9
        assert torch.equal(got.isnan(), want.isnan())


def _bn(gen, c):
    scale = torch.randn(c, device="cuda", generator=gen)
    bias = torch.randn(c, device="cuda", generator=gen)
    mean = torch.randn(c, device="cuda", generator=gen)
    var = torch.rand(c, device="cuda", generator=gen) + 0.1
    return scale, bias, mean, var


def test_in_kernel_bn_fold_equals_fold_bn(cuda):
    """The kernel folds the BN itself in fold_bn's order of operations
    (rsqrtf, as torch.rsqrt on the card): bit for bit the same as
    fold_bn + the affine kernel, and as the plain BN version, at every
    main-path shape and on the scalar path."""
    for call in mobilenet.fused_call_shapes(8, 50) + [
            dict(h_in=9, c=6, stride=2)]:
        c, s = call["c"], call["stride"]
        x, w, _, _ = _inputs(cuda, 8, call["h_in"], c)
        bn = _bn(cuda, c)
        before = fc.KERNEL.launches
        got = fc.fused_depthwise_bn_relu6(x, w, *bn, eps=1e-3, stride=s)
        assert fc.KERNEL.launches == before + 1
        folded = fc.fused_depthwise_affine(x, w, *fc.fold_bn(*bn, 1e-3),
                                           stride=s)
        assert torch.equal(got, folded), call
        assert torch.equal(got, fc.reference_bn_impl(x, w, *bn, eps=1e-3,
                                                      stride=s)), call


def test_bn_backward_matches_autograd_of_plain(cuda):
    x, w, _, _ = _inputs(cuda, 4, 9, 40)
    bn = _bn(cuda, 40)
    g = torch.randn(4, 5, 5, 40, device="cuda", generator=cuda)
    grads = []
    for fn in (fc.fused_depthwise_bn_relu6, fc.reference_bn_impl):
        ins = [t.clone().requires_grad_() for t in (x, w, *bn)]
        fn(*ins, eps=1e-3, stride=2).backward(g)
        grads.append([t.grad for t in ins])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, **F32_TOL)


def test_each_path_counts_its_launches(cuda):
    cases = {"3x3": (8, 3), "general": (8, 5), "scalar": (6, 3)}
    for path, (c, k) in cases.items():
        x = torch.randn(1, 7, 7, c, device="cuda", generator=cuda)
        w = torch.randn(k, k, 1, c, device="cuda", generator=cuda)
        one = torch.ones(c, device="cuda")
        before = fc.KERNEL.launches, dict(fc.PATH_LAUNCHES)
        fc.fused_depthwise_affine(x, w, one, one)
        fc.fused_depthwise_bn_relu6(x, w, one, one, one, one, eps=1e-3)
        assert fc.KERNEL.launches == before[0] + 2
        assert {p: fc.PATH_LAUNCHES[p] - before[1][p] for p in fc.PATHS} \
            == {p: 2 * (p == path) for p in fc.PATHS}


@pytest.mark.parametrize("stride", [1, 2])
def test_backward_matches_autograd_of_plain(cuda, stride):
    x, w, mul, add = _inputs(cuda, 4, 9, 40)
    g = torch.randn(4, -(-9 // stride), -(-9 // stride), 40, device="cuda",
                    generator=cuda)
    grads = []
    for fn in (fc.fused_depthwise_affine, fc.reference_impl):
        ins = [t.clone().requires_grad_() for t in (x, w, mul, add)]
        fn(*ins, stride=stride, clamp6=True).backward(g)
        grads.append([t.grad for t in ins])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, **F32_TOL)


def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    """x may have any strides (the kernel takes them); w and the
    per-channel vectors must be contiguous, on x's card, and carry C."""
    x, w, mul, add = _inputs(cuda, 1, 5, 8)
    before = fc.KERNEL.launches
    with pytest.raises(ValueError, match="contiguous"):
        fc.fused_depthwise_affine(x, w.transpose(0, 1), mul, add)
    with pytest.raises(ValueError, match="contiguous"):
        fc.fused_depthwise_bn_relu6(x, w, mul, add, mul,
                                    torch.ones(16, device="cuda")[::2],
                                    eps=1e-3)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fc.fused_depthwise_affine(x.half(), w, mul, add)
    with pytest.raises(ValueError, match="CUDA device"):
        fc.fused_depthwise_affine(x, w.cpu(), mul, add)
    with pytest.raises(ValueError, match="channels"):
        fc.fused_depthwise_bn_relu6(x, w, mul, add, mul[:4], add, eps=1e-3)
    assert fc.KERNEL.launches == before


def test_init_params_gives_the_same_weights_on_the_card(cuda):
    """A module already on the card is initialized from the CPU generator
    to the weights a CPU module gets from the same seed."""
    on_card = core.init_params(small_cnn.small_cnn(10, 3, 1).cuda(), 3)
    on_cpu = core.init_params(small_cnn.small_cnn(10, 3, 1), 3)
    for (k, a), (_, b) in zip(on_card.state_dict().items(),
                              on_cpu.state_dict().items()):
        assert a.is_cuda and torch.equal(a.cpu(), b), k


def test_fused_model_matches_grouped_model_on_the_card(cuda):
    """MobileNetV2 eval forward: the fused build (17 kernel launches)
    against the grouped (cuDNN) build of the same weights."""
    fused = core.init_params(mobilenet.mobilenet_v2(
        1, depthwise_impl="fused"), 0).cuda().eval()
    grouped = mobilenet.mobilenet_v2(1, depthwise_impl="grouped")
    grouped.load_state_dict(fused.state_dict())
    grouped.cuda().eval()
    x = torch.rand(8, 50, 50, 3, device="cuda", generator=cuda)
    before = fc.KERNEL.launches
    with torch.no_grad():
        got = fused(x)
        want = grouped(x)
    torch.cuda.synchronize()
    assert fc.KERNEL.launches - before == mobilenet.fused_chain_count(
        0, train=False) == 17
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# the secure masking kernel: integer arithmetic, held bit for bit


def _masking_input(gen, size):
    x = torch.randn(size, device="cuda", generator=gen) * 40
    edges = torch.tensor([64.0, -64.0, 70.0, -1e9, 3.5 * 2**-20,
                          -2.5 * 2**-20, 0.5 * 2**-20], device="cuda")
    k = min(size, len(edges))
    x[:k] = edges[:k]
    return x


@pytest.mark.parametrize("size", [1, 127, 1920, 192_576, 2**20 + 3])
@pytest.mark.parametrize("n_clients", [1, 8])
def test_masking_kernel_bit_exact_at_main_path_sizes(cuda, size, n_clients):
    x = _masking_input(cuda, size)
    for me in range(n_clients):
        seeds, signs = smk.pair_seeds_and_signs(0xFFFFFFFF, me, n_clients,
                                                device="cuda")
        before = smk.KERNEL.launches
        got = smk.fused_masked_quantize(x, seeds, signs, scale_bits=20,
                                        clip_abs=64.0)
        torch.cuda.synchronize()
        assert smk.KERNEL.launches == before + 1
        assert got.dtype == torch.int32 and got.is_cuda
        want = smk.masked_quantize_reference(x, seeds, signs, scale_bits=20,
                                             clip_abs=64.0)
        assert torch.equal(got, want)


@pytest.mark.parametrize("size", [1920, 192_576])
def test_masking_kernel_on_each_ranks_block_of_clients(cuda, size):
    """B2 as a rank of a 4-rank client group launches it: rank r's
    clients r*k .. r*k+k-1 (k = 2) of n_total = 8, each under its global
    id. Each launch equals the plain version bit for bit; the four
    blocks' int64 partials, summed and wrapped once (the group's sum),
    equal the plain versions' sum, and the masks cancel: that sum is the
    sum of the bare quantized values mod 2^32."""
    n_total, world = 8, 4
    k = n_total // world
    xs = [_masking_input(cuda, size) * (1 + c) for c in range(n_total)]
    partials, plain = [], torch.zeros(size, dtype=torch.int64, device="cuda")
    for rank in range(world):
        part = torch.zeros(size, dtype=torch.int64, device="cuda")
        for cid in range(rank * k, rank * k + k):
            seeds, signs = smk.pair_seeds_and_signs(0x9E3779B9, cid,
                                                    n_total, device="cuda")
            before = smk.KERNEL.launches
            got = smk.fused_masked_quantize(xs[cid], seeds, signs,
                                            scale_bits=20, clip_abs=64.0)
            assert smk.KERNEL.launches == before + 1
            want = smk.masked_quantize_reference(
                xs[cid], seeds, signs, scale_bits=20, clip_abs=64.0)
            assert torch.equal(got, want), (rank, cid)
            part += got.long()
            plain += want.long()
        partials.append(part)
    summed = smk.wrap_int32(torch.stack(partials).sum(0))
    assert torch.equal(summed, smk.wrap_int32(plain))
    bare = sum(smk.quantize_f32(x, 20, 64.0).long() for x in xs)
    assert torch.equal(summed, smk.wrap_int32(bare))


def test_masking_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    x = torch.randn(8, 6, device="cuda", generator=cuda)
    seeds, signs = smk.pair_seeds_and_signs(1, 0, 3, device="cuda")
    before = smk.KERNEL.launches
    with pytest.raises(ValueError, match="contiguous"):
        smk.fused_masked_quantize(x[:, ::2], seeds, signs, scale_bits=20,
                                  clip_abs=64.0)
    with pytest.raises(TypeError, match="float32"):
        smk.fused_masked_quantize(x.double(), seeds, signs, scale_bits=20,
                                  clip_abs=64.0)
    with pytest.raises(ValueError, match=r"\[n\] vectors"):
        smk.fused_masked_quantize(x, seeds, signs[:2], scale_bits=20,
                                  clip_abs=64.0)
    assert smk.KERNEL.launches == before


def test_secure_round_through_the_kernel_matches_threefry(cuda):
    """A small-CNN secure round on the card: `pallas` launches the kernel
    once per client and aggregates bit-identically to `threefry`. cuDNN
    runs deterministic algorithms, so both rounds train the same clients
    bit for bit."""
    imgs = torch.rand(4, 32, 10, 10, 3, device="cuda", generator=cuda)
    labels = (torch.rand(4, 32, device="cuda", generator=cuda) > 0.5).int()
    out = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    for impl in ("pallas", "threefry"):
        model = core.init_params(small_cnn.small_cnn(10, 3, 1), 0)
        server = ServerState.of(model)   # on the CPU: the round moves it
        rnd = make_secure_fedavg_round(model, 1e-3, binary_cross_entropy,
                                       percent=0.5, local_epochs=1,
                                       batch_size=16, mask_impl=impl)
        before = smk.KERNEL.launches
        server, m = rnd(server, imgs, labels,
                        torch.Generator().manual_seed(0))
        assert smk.KERNEL.launches - before == (4 if impl == "pallas" else 0)
        assert m["clip_saturated"] == 0.0
        out[impl] = {**server.params, **server.state}
    torch.backends.cudnn.deterministic = deterministic
    for k, t in out["threefry"].items():
        assert torch.equal(out["pallas"][k], t), k


# the causal LM's flash kernels: f32 arithmetic in another order than the
# plain versions (64-key chunks against whole-block products), so they are
# held normwise, max |kernel - plain| <= FLASH_TOL * (1 + max |plain|)

FLASH_TOL = 5e-5


def _flash_close(got, want, elementwise=False):
    """Normwise, or elementwise |got - want| <= FLASH_TOL * (1 + |want|)
    (for m, whose rows that never saw a key hold the -1e30 sentinel)."""
    diff = (got.float() - want.float()).abs()
    if elementwise:
        bad = diff > FLASH_TOL * (1.0 + want.float().abs())
        assert not bad.any(), diff.max().item()
    else:
        err = diff.max().item()
        assert err <= FLASH_TOL * (1.0 + want.float().abs().max().item()), err


def _flash_inputs(gen, t_q, t_k, d, dtype, fresh=False):
    def mk(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)
    q, dout = mk(2, t_q, 2, d).to(dtype), mk(2, t_q, 2, d).to(dtype)
    k, v = mk(2, t_k, 2, d).to(dtype), mk(2, t_k, 2, d).to(dtype)
    if fresh:
        m = torch.full((2, 2, t_q), -1e30, device="cuda")
        l = torch.zeros(2, 2, t_q, device="cuda")
        acc = torch.zeros(2, t_q, 2, d, device="cuda")
    else:
        m, acc = mk(2, 2, t_q), mk(2, t_q, 2, d)
        l = torch.rand(2, 2, t_q, device="cuda", generator=gen) + 0.5
    return q, k, v, m, l, acc, dout, mk(2, 2, t_q) + 8.0, mk(2, 2, t_q)


@pytest.mark.parametrize("offsets, fresh", [
    ([128, 0], False), ([32, 96], False), ([0, 256], False),
    ([0, 32], True), ([0, 256], True)])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernels_match_plain(cuda, d, dtype, causal, offsets, fresh):
    """The update, dq and dk/dv kernels against their plain versions,
    Tq 256 against Tk 512, a mid-stream or a fresh carry; one launch
    each; m elementwise. Offsets [128, 0] give partial diagonal tiles,
    [32, 96] cut a tile's span inside a chunk, and [0, 256] put every key
    after every query: there the causal backward kernels skip every tile
    and return exact zeros, and the update kernel returns a mid-stream
    carry bit for bit (its vote passes) but folds the plain version's
    p = 1 garbage into a fresh one (its vote fails). At [0, 32] with a
    fresh carry rows 0-31 see no key, so the first tile's vote fails and
    it walks every chunk."""
    q, k, v, m, l, acc, dout, lse, delta = _flash_inputs(
        cuda, 256, 512, d, getattr(torch, dtype), fresh=fresh)
    offs = torch.tensor(offsets, dtype=torch.int32, device="cuda")
    kw = dict(scale=d ** -0.5, causal=causal)
    before = [kern.launches for kern in fbk.KERNELS]
    got = fbk.flash_block_update(q, k, v, m, l, acc, offs, **kw)
    grads = fbk.flash_block_grads(q, k, v, dout, lse, delta, offs, **kw)
    torch.cuda.synchronize()
    assert [kern.launches - b for kern, b in
            zip(fbk.KERNELS, before)] == [1, 1, 1]
    for i, (g, w) in enumerate(zip(got, fbk.reference_impl(
            q, k, v, m, l, acc, offs, **kw))):
        assert g.dtype == torch.float32 and g.is_cuda
        _flash_close(g, w, elementwise=i == 0)
    if causal and offsets == [0, 256] and not fresh:
        for g, c in zip(got, (m, l, acc)):
            assert torch.equal(g, c)
    for g, w in zip(grads, fbk.block_grads_reference(
            q, k, v, dout, lse, delta, offs, **kw)):
        assert g.dtype == torch.float32 and g.is_cuda
        _flash_close(g, w)
        if causal and offsets == [0, 256]:
            assert not w.any() and not g.any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_backward_kernels_are_deterministic(cuda, dtype):
    """Two launches of dq and of dk/dv on the same inputs are bit-equal:
    each output is written once, by the one block that owns it."""
    q, k, v, _, _, _, dout, lse, delta = _flash_inputs(
        cuda, 512, 512, 64, getattr(torch, dtype))
    offs = torch.tensor([0, 0], dtype=torch.int32, device="cuda")
    kw = dict(scale=0.125, causal=True)
    first = fbk.flash_block_grads(q, k, v, dout, lse, delta, offs, **kw)
    second = fbk.flash_block_grads(q, k, v, dout, lse, delta, offs, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fresh", [True, False])
def test_flash_update_kernel_is_deterministic(cuda, dtype, fresh):
    """Two launches of the update kernel on the same inputs are
    bit-equal: each row's carry is written once, by the one warp that
    owns it."""
    q, k, v, m, l, acc, *_ = _flash_inputs(cuda, 512, 512, 64,
                                           getattr(torch, dtype), fresh=fresh)
    offs = torch.tensor([0, 0], dtype=torch.int32, device="cuda")
    kw = dict(scale=0.125, causal=True)
    first = fbk.flash_block_update(q, k, v, m, l, acc, offs, **kw)
    second = fbk.flash_block_update(q, k, v, m, l, acc, offs, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_fully_masked_first_block_heals(cuda, dtype):
    """A fresh carry folded with a fully masked block, then a visible
    one, equals the plain version's two folds."""
    q, k, v, m, l, acc, *_ = _flash_inputs(cuda, 128, 128, 64,
                                           getattr(torch, dtype), fresh=True)
    got, want = (m, l, acc), (m, l, acc)
    for offs in ([0, 128], [128, 0]):
        got = fbk.flash_block_update(q, k, v, *got, offs, scale=0.125,
                                     causal=True)
        want = fbk.reference_impl(q, k, v, *want, offs, scale=0.125,
                                  causal=True)
    for g, w in zip(got, want):
        _flash_close(g, w)
    assert torch.isfinite(got[1]).all() and (got[1] > 0).all()


def test_flash_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    q, k, v, m, l, acc, dout, lse, delta = _flash_inputs(cuda, 128, 128, 64,
                                                         torch.float32)
    kw = dict(scale=0.125, causal=True)
    offs = [0, 0]
    before = [kern.launches for kern in fbk.KERNELS]
    with pytest.raises(ValueError, match="D in"):
        fbk.flash_block_update(q[..., :48].contiguous(), k[..., :48]
                               .contiguous(), v[..., :48].contiguous(), m, l,
                               acc[..., :48].contiguous(), offs, **kw)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fbk.flash_block_update(q.half(), k.half(), v.half(), m, l, acc, offs,
                               **kw)
    with pytest.raises(TypeError, match="must be torch.float32"):
        fbk.flash_block_update(q, k, v, m.double(), l, acc, offs, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        fbk.flash_block_grads(q, k.transpose(1, 2).contiguous().transpose(
            1, 2), v, dout, lse, delta, offs, **kw)
    with pytest.raises(ValueError, match="must lie on"):
        fbk.flash_block_grads(q, k, v, dout, lse.cpu(), delta, offs, **kw)
    with pytest.raises(ValueError, match="multiples of 128"):
        fbk.flash_block_update(q[:, :64], k, v, m[..., :64], l[..., :64],
                               acc[:, :64], offs, **kw)
    assert [kern.launches for kern in fbk.KERNELS] == before


def test_pallas_ring_gradients_on_the_card(cuda):
    """Values and gradients of the pallas ring (the forward and backward
    kernels) against autograd of full attention, T=1024."""
    q, k, v = (torch.randn(1, 1024, 4, 64, device="cuda", generator=cuda)
               for _ in range(3))
    outs, grads = [], []
    for fn in (tring.make_ring_attention(causal=True, block_impl="pallas"),
               lambda a, b, c: tring.full_attention(a, b, c, causal=True)):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*ins)
        out.square().sum().backward()
        outs.append(out.detach())
        grads.append([t.grad for t in ins])
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-5, atol=1e-5)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)


def test_pallas_ring_backward_memory_is_blockwise(cuda):
    """Forward + backward of the pallas ring at B=1, T=16384, H=8, D=64
    raises the peak allocation by under 1 GB: no [T, T] tensor (8.6 GB
    in f32) is ever built."""
    q, k, v, g = (torch.randn(1, 16384, 8, 64, device="cuda", generator=cuda)
                  for _ in range(4))
    for t in (q, k, v):
        t.requires_grad_()
    ring = tring.make_ring_attention(causal=True, block_impl="pallas")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ring(q, k, v).backward(g)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < 1e9


# the zigzag layout: bf16 rings against their plain versions sum in f32
# in other orders and round to bf16, and the pallas backward's D reads
# the rounded output, so they are held at ||a - b|| / ||b|| <= 2^-7 per
# tensor, chip_smoke.py's bar (readings at most 2.9e-3)
ZIGZAG_BF16_REL = 2.0 ** -7


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pallas_zigzag_ring_on_the_card(cuda, dtype):
    """Values and gradients of the pallas zigzag ring (three quarter
    folds forward, three backward, B=2 so the quarters are cut from
    non-contiguous halves) against the plain zigzag ring and full
    attention, T=1024."""
    dt = getattr(torch, dtype)
    q, k, v, g = (torch.randn(2, 1024, 4, 64, device="cuda", generator=cuda)
                  for _ in range(4))
    runs = []
    before = [kern.launches for kern in fbk.KERNELS]
    for fn in (tring.make_ring_attention(causal=True, layout="zigzag",
                                         block_impl="pallas"),
               tring.make_ring_attention(causal=True, layout="zigzag"),
               lambda a, b, c: tring.full_attention(a, b, c, causal=True)):
        ins = [t.to(dt).clone().requires_grad_() for t in (q, k, v)]
        out = fn(*ins)
        out.backward(g.to(dt))
        runs.append([out.detach()] + [t.grad for t in ins])
        if len(runs) == 1:
            torch.cuda.synchronize()
            assert [kern.launches - b for kern, b in
                    zip(fbk.KERNELS, before)] == [3, 3, 3]
    for ref in runs[1:]:
        for i, (a, b) in enumerate(zip(runs[0], ref)):
            assert a.dtype == dt
            if dt == torch.float32:
                tol = (dict(rtol=1e-5, atol=1e-5) if i == 0
                       else dict(rtol=2e-4, atol=2e-5))
                torch.testing.assert_close(a, b, **tol)
            else:
                a, b = a.float(), b.float()
                rel = ((a - b).norm() / b.norm()).item()
                assert rel <= ZIGZAG_BF16_REL, (i, rel)


def _zigzag_quarters(n, th):
    """Every (query stripe, key stripe, q_off, k_off, causal) quarter
    fold an n-rank zigzag ring makes, once each: the ring's own
    schedule walked by all its ranks."""
    return sorted({quarter for me in range(n)
                   for step in tring.zigzag_schedule(me, n, th)
                   for quarter in step})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernels_at_every_four_rank_zigzag_quarter(cuda, dtype):
    """The update, dq and dk/dv kernels against their plain versions at
    every quarter fold of a 4-rank zigzag ring (36 offset pairs),
    B=2, H=8, D=64, quarters of 256 cut from [2, 512, 8, 64] blocks and
    [2, 8, 512] carries the way the ring cuts them; a fresh carry for a
    stripe's first (diagonal) fold, else a mid-stream one."""
    dt = getattr(torch, dtype)
    th = 256
    cases = _zigzag_quarters(4, th)
    assert len(cases) == 36
    for qi, ki, q_off, k_off, causal in cases:
        def mk(*shape):
            return torch.randn(*shape, device="cuda", generator=cuda)
        q, dout, k, v = (mk(2, 2 * th, 8, 64).to(dt) for _ in range(4))
        if causal:
            m = torch.full((2, 8, 2 * th), -1e30, device="cuda")
            l = torch.zeros(2, 8, 2 * th, device="cuda")
            acc = torch.zeros(2, 2 * th, 8, 64, device="cuda")
        else:
            m, acc = mk(2, 8, 2 * th), mk(2, 2 * th, 8, 64)
            l = torch.rand(2, 8, 2 * th, device="cuda", generator=cuda) + 0.5
        lse, delta = mk(2, 8, 2 * th) + 8.0, mk(2, 8, 2 * th)
        rows = [tring._halves(t, th)[qi] for t in (q, acc, dout)]
        cols = [tring._halves(t, th, 2)[qi] for t in (m, l, lse, delta)]
        ks, vs = (tring._halves(t, th)[ki] for t in (k, v))
        offs = torch.tensor([q_off, k_off], dtype=torch.int32,
                            device="cuda")
        kw = dict(scale=0.125, causal=causal)
        fold_in = (rows[0], ks, vs, cols[0], cols[1], rows[1], offs)
        got = fbk.flash_block_update(*fold_in, **kw)
        for i, (a, b) in enumerate(zip(got, fbk.reference_impl(
                *fold_in, **kw))):
            _flash_close(a, b, elementwise=i == 0)
        grads_in = (rows[0], ks, vs, rows[2], cols[2], cols[3], offs)
        for a, b in zip(fbk.flash_block_grads(*grads_in, **kw),
                        fbk.block_grads_reference(*grads_in, **kw)):
            _flash_close(a, b)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_remat_classifier_on_the_card(cuda, dropout):
    """An AttentionClassifier (pallas, zigzag, T=512) with remat against
    the same weights without: logits and gradients within FLASH_TOL
    normwise, dropout masks drawn alike under one seed; remat runs the
    update kernel again in the backward (6 launches a block a step
    instead of 3)."""
    from idc_models_tpu_torch.models.attention import AttentionClassifier

    x = torch.randn(2, 512, 8, device="cuda", generator=cuda)
    y = torch.tensor([0, 1], device="cuda")
    runs, launches = [], []
    for remat in (False, True):
        model = core.init_params(AttentionClassifier(
            512, 8, embed_dim=64, num_heads=2, mlp_dim=128, num_blocks=2,
            block_impl="pallas", layout="zigzag", dropout_rate=dropout,
            remat=remat), 0).cuda().train()
        core.use_generator(model, torch.Generator(device="cuda")
                           .manual_seed(3))
        before = [kern.launches for kern in fbk.KERNELS]
        logits = model(x)
        binary_cross_entropy(logits, y).backward()
        torch.cuda.synchronize()
        launches.append([kern.launches - b for kern, b in
                         zip(fbk.KERNELS, before)])
        runs.append([logits.detach()] + [p.grad for p in model.parameters()])
    assert launches == [[6, 6, 6], [12, 6, 6]]
    for a, b in zip(*runs):
        _flash_close(a, b)


# ---------------------------------------------------------------------------
# the classifier zoo: VGG16, DenseNet201 packed/concat, the feature cache
# ---------------------------------------------------------------------------


def _densenet_pair(bn_frozen_below=0):
    """Packed and concat DenseNet201 on the card, the same seeded
    weights."""
    packed = core.init_params(densenet.densenet201(
        10, bn_frozen_below=bn_frozen_below, block_impl="packed"), 0)
    concat = densenet.densenet201(10, bn_frozen_below=bn_frozen_below,
                                  block_impl="concat")
    concat.load_state_dict(packed.state_dict())
    return packed.cuda(), concat.cuda()


@pytest.mark.parametrize("n,size", [(8, 32), (2, 64)])
def test_densenet_packed_equals_concat_on_the_card(cuda, n, size):
    packed, concat = _densenet_pair()
    x = torch.rand(n, size, size, 3, device="cuda", generator=cuda)
    with torch.no_grad():
        assert torch.equal(packed.eval()(x), concat.eval()(x))


def test_densenet_phase2_backward_through_packed_blocks_on_the_card(cuda):
    """fine_tune_at=150: the backward runs through packed blocks, and
    every gradient is concat's within 1e-4 of the tensor's largest
    |gradient|."""
    x = torch.rand(16, 32, 32, 3, device="cuda", generator=cuda)
    r = torch.randn(16, 10, device="cuda", generator=cuda)
    grads = []
    for m in _densenet_pair(150):
        mask = densenet.fine_tune_mask(m, 150)
        for k, p in m.named_parameters():
            p.requires_grad_(mask[k])
        (m.train()(x) * r).sum().backward()
        grads.append({k: p.grad for k, p in m.named_parameters() if mask[k]})
    for k, g in grads[1].items():
        err = float((grads[0][k] - g).abs().max())
        assert err <= 1e-4 * float(g.abs().max()), k


@pytest.mark.parametrize("name,n_out,size", [("vgg16", 1, 50),
                                             ("densenet201", 10, 32)])
def test_card_logits_match_the_cpu(cuda, name, n_out, size):
    """The same weights on the card and on the CPU: eval logits within
    1e-4 (1 + max |logit|), TF32 off."""
    cpu = core.init_params(registry.get_model(name).build(n_out), 0).eval()
    card = registry.get_model(name).build(n_out)
    card.load_state_dict(cpu.state_dict())
    x = torch.rand(4, size, size, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = cpu(x)
        got = card.cuda().eval()(x.cuda()).cpu()
    assert (got - want).abs().max() <= 1e-4 * (1 + want.abs().max())


@pytest.mark.parametrize("name,n_out,at,kw", [
    ("vgg16", 1, 15, {}),
    ("mobilenet_v2", 1, 100, {"depthwise_impl": "fused",
                              "bn_frozen_below": 100}),
    ("densenet201", 10, 150, {"bn_frozen_below": 150}),
])
def test_cached_features_give_the_uncached_logits_on_the_card(cuda, name,
                                                              n_out, at, kw):
    """The suffix on cached prefix features (a partial last batch padded
    to the batch) gives the full model's eval logits, within 1e-6."""
    spec = registry.get_model(name)
    model = core.init_params(spec.build(n_out, **kw), 0).cuda()
    plan = feature_cache.plan_feature_cache(model, spec.layer_index, at)
    size = 32 if name != "vgg16" else 50
    imgs = torch.rand(12, size, size, 3,
                      generator=torch.Generator().manual_seed(2)).numpy()
    ds = ArrayDataset(imgs, torch.zeros(12, dtype=torch.int32).numpy())
    feats = feature_cache.compute_features(plan, ds, batch_size=8)
    want = predict(model, imgs, batch_size=8)
    got = predict(plan.suffix_model, feats.images, batch_size=8)
    torch.testing.assert_close(torch.from_numpy(got), torch.from_numpy(want),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the federated path (fed): checkpoints, the FedAvg round, the driver
# ---------------------------------------------------------------------------

def _fed_model():
    """Dropout-free, as the CPU parity tests hold the round."""
    return core.init_params(core.Sequential(
        [core.Conv2d(3, 4, 3, name="c1"), core.ReLU(),
         core.MaxPool(2, name="pool"), core.Flatten(),
         core.Dense(100, 1, name="head")], name="seq"), 0)


def _fed_data(gen, n_clients=4, shard=16):
    imgs = torch.rand(n_clients, shard, 10, 10, 3, generator=gen)
    labels = (torch.rand(n_clients, shard, generator=gen) > 0.5).int()
    return imgs, labels


def test_checkpoint_moves_between_card_and_cpu(cuda, tmp_path):
    """A checkpoint saved from the card restores onto the CPU and one
    saved from the CPU onto the card, bit for bit, on the target's
    device."""
    from idc_models_tpu_torch.train.checkpoint import (
        restore_checkpoint, save_checkpoint,
    )

    model = _fed_model()
    server = ServerState.of(model.cuda(), round=4)
    save_checkpoint(tmp_path / "card", server.tree())
    on_cpu = ServerState.from_tree(restore_checkpoint(
        tmp_path / "card", server.to("cpu").tree()))
    assert on_cpu.round == 4
    for k, v in server.params.items():
        assert on_cpu.params[k].device.type == "cpu"
        assert torch.equal(on_cpu.params[k], v.cpu()), k
    save_checkpoint(tmp_path / "cpu", on_cpu.tree())
    back = ServerState.from_tree(restore_checkpoint(tmp_path / "cpu",
                                                    server.tree()))
    for k, v in server.params.items():
        assert back.params[k].is_cuda and torch.equal(back.params[k], v), k


@pytest.mark.parametrize("aggregator,spec", [("mean", None),
                                             ("trimmed_mean", "nan:1"),
                                             ("median", "sign_flip:2:x5")])
def test_fedavg_round_on_the_card_matches_the_cpu(cuda, aggregator, spec):
    """One round from the same weights, full-shard local steps, on the
    card and on the CPU: each aggregate tensor within 1e-4 (1 + max |w|)
    and the same metrics. In float64: a client's first RMSprop step has
    slope lr / 1e-7 at a zero gradient, which would amplify the two
    devices' f32 summation-order differences past any such bar."""
    from idc_models_tpu_torch import faults as tfaults
    from idc_models_tpu_torch.federated.fedavg import make_fedavg_round

    imgs, labels = _fed_data(torch.Generator().manual_seed(3))
    imgs = imgs.double()
    weights = torch.tensor([16.0, 12.0, 16.0, 8.0])
    out = {}
    for device in ("cuda", "cpu"):
        model = _fed_model().double()
        plan = tfaults.parse_fault_spec(spec, 4) if spec else None
        rnd = make_fedavg_round(model, 1e-3, binary_cross_entropy,
                                batch_size=16, aggregator=aggregator,
                                faults=plan, device=device)
        server = ServerState.of(model)
        out[device] = rnd(server, imgs.to(device), labels.to(device),
                          weights, (0, 0, 0))
    (card, cm), (cpu, pm) = out["cuda"], out["cpu"]
    for k, want in cpu.params.items():
        err = float((card.params[k].cpu() - want).abs().max())
        assert err <= 1e-4 * (1 + float(want.abs().max())), k
    assert cm.keys() == pm.keys()
    for k in cm:
        assert abs(cm[k] - pm[k]) <= 1e-4 * (1 + abs(pm[k])), k


def test_run_rounds_on_the_card_retries_a_round_over_its_timeout(cuda):
    """Round 1's first attempt leaves a kernel that sleeps on the card
    after the round returns: the driver's synchronize puts it inside the
    round's wall time, past the budget, and the round retries on a
    reseeded subset; the driver's first attempt is exempt."""
    from idc_models_tpu_torch.federated import (
        DriverConfig, make_fedavg_round, run_rounds,
    )

    imgs, labels = _fed_data(torch.Generator().manual_seed(4))
    imgs, labels = imgs.cuda(), labels.cuda()
    model = _fed_model()
    rnd = make_fedavg_round(model, 1e-3, binary_cross_entropy,
                            batch_size=16, device="cuda")
    calls = []

    def slow_once(server, images, labels, weights, key):
        new, m = rnd(server, images, labels, weights, key)
        calls.append(key)
        if key[1:] == (1, 0):
            torch.cuda._sleep(2_000_000_000)     # about a second
        return new, m

    res = run_rounds(slow_once, ServerState.of(model.cuda()), imgs, labels,
                     torch.full((4,), 16.0),
                     config=DriverConfig(rounds=3, timeout_s=0.5), seed=1)
    assert [(e["round"], e["attempt"], e["status"]) for e in res.events] == [
        (0, 0, "ok"), (1, 0, "timeout"), (1, 1, "ok"), (2, 0, "ok")]
    assert res.events[1]["seconds"] > 0.5
    assert res.events[2]["participants"] < 4
    assert res.server.round == 3


def test_trimmed_mean_ranks_ties_by_client_on_the_card(cuda):
    """A frozen leaf (every client the server's value) beside a trained
    one with two attackers, at a size where the card sorts in parallel:
    the card's trimmed mean and clients_trimmed equal the CPU's (ties
    rank by client index, as JAX's stable argsort ranks them)."""
    from idc_models_tpu_torch.federated import robust

    gen = torch.Generator().manual_seed(5)
    server = {"frozen": torch.randn(300_000, generator=gen),
              "w": torch.randn(50_000, generator=gen)}
    upd = {"frozen": server["frozen"].repeat(10, 1),
           "w": server["w"] + 0.1 * torch.randn(10, 50_000, generator=gen)}
    upd["w"][:2] += 1000.0
    weight = torch.ones(10)
    agg = robust.TrimmedMean(2)
    want, wm = agg(upd, weight, server)
    got, gm = agg({k: v.cuda() for k, v in upd.items()}, weight.cuda(),
                  {k: v.cuda() for k, v in server.items()})
    assert {k: float(v) for k, v in gm.items()} == {
        k: float(v) for k, v in wm.items()}
    for k in server:
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-6,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# the population path: streamed waves and the buffered async server
# ---------------------------------------------------------------------------

@pytest.fixture
def deterministic(cuda):
    """cuDNN's deterministic algorithms (no atomics in the weight
    gradients), so two runs of one program on the card agree bit for
    bit."""
    torch.backends.cudnn.deterministic = True
    yield cuda
    torch.backends.cudnn.deterministic = False


def _population(weight_range=(8.0, 24.0)):
    from idc_models_tpu_torch.federated import ClientPopulation, CohortSampler

    pop = ClientPopulation(64, examples_per_client=16, image_size=10, seed=3,
                           weight_range=weight_range)
    return pop, CohortSampler(pop, 8, seed=5)


@pytest.mark.parametrize("mode", ["1 wave", "2 waves", "async"])
def test_population_rounds_on_the_card_match_the_cpu(cuda, mode):
    """Two rounds of the streamed or the async round from the same
    weights on the card and on the CPU, in float64 (as the FedAvg round
    above): each server tensor within 1e-4 (1 + max |w|), the same
    metrics, and for async the same clients in the same order."""
    from idc_models_tpu_torch.federated import (
        make_async_round, make_population_round,
    )

    out = {}
    for device in ("cuda", "cpu"):
        pop, sampler = _population()
        model = _fed_model().double()
        if mode == "async":
            rnd = make_async_round(model, 1e-3, binary_cross_entropy, pop,
                                   sampler, buffer_size=4, batch_size=16,
                                   seed=11, device=device)
        else:
            rnd = make_population_round(
                model, 1e-3, binary_cross_entropy, pop, sampler,
                wave_size=8 // int(mode[0]), batch_size=16, device=device)
        server, ms, order = ServerState.of(model), [], []
        for r in range(2):
            server, m = rnd(server, None, None, None, (1, r, 0), round_idx=r)
            ms.append(m)
            order.append(getattr(rnd, "last_participants", None))
        out[device] = server, ms, order
    (card, cm, co), (cpu, pm, po) = out["cuda"], out["cpu"]
    for k, want in cpu.params.items():
        assert card.params[k].is_cuda
        err = float((card.params[k].cpu() - want).abs().max())
        assert err <= 1e-4 * (1 + float(want.abs().max())), k
    for a, b in zip(cm, pm):
        assert a.keys() == b.keys()
        for k in a:
            assert abs(a[k] - b[k]) <= 1e-4 * (1 + abs(b[k])), k
    if mode == "async":
        for a, b in zip(co, po):
            assert a.tolist() == b.tolist()


def test_one_wave_equals_the_fedavg_round_on_the_card(deterministic):
    """On the card, with cuDNN deterministic and TF32 off, one wave over
    the cohort equals make_fedavg_round on the materialized cohort bit
    for bit, and a crash equals a zeroed participation mask."""
    from idc_models_tpu_torch import faults as tfaults
    from idc_models_tpu_torch.federated import (
        make_fedavg_round, make_population_round,
    )

    pop, sampler = _population()
    ids = sampler.cohort(0)
    imgs, labels, w = pop.materialize(ids)
    model = small_cnn.small_cnn(10, 3, 1)
    core.init_params(model, 0)
    server = ServerState.of(model.cuda())
    one, m1 = make_fedavg_round(model, 1e-3, binary_cross_entropy,
                                batch_size=16, device="cuda")(
        server, imgs, labels, w, (7, 0, 0))
    stream = make_population_round(model, 1e-3, binary_cross_entropy, pop,
                                   sampler, wave_size=8, batch_size=16,
                                   device="cuda")
    wave, mw = stream(server, None, None, None, (7, 0, 0), round_idx=0)
    for k in one.params:
        assert torch.equal(one.params[k], wave.params[k]), k
    assert mw["loss"] == m1["loss"]

    plan = tfaults.PopulationFaultPlan(64, [tfaults.PopulationFault(
        "crash", clients=(int(ids[3]),))])
    crashed, _ = make_population_round(
        model, 1e-3, binary_cross_entropy, pop, sampler, wave_size=4,
        batch_size=16, faults=plan, device="cuda")(
        server, None, None, None, (5, 0, 0), round_idx=0)
    mask = torch.ones(8)
    mask[3] = 0.0
    masked, _ = make_population_round(
        model, 1e-3, binary_cross_entropy, pop, sampler, wave_size=4,
        batch_size=16, device="cuda")(
        server, None, None, mask, (5, 0, 0), round_idx=0)
    for k in crashed.params:
        assert torch.equal(crashed.params[k], masked.params[k]), k


def _fused_mobilenet_step(device, batch: int = 8,
                          compute_dtype=torch.bfloat16):
    """A MobileNetV2 fine-tune step (fused depthwise chains, BN frozen
    below 100, the bench configuration's mask and rate; bf16 unless
    asked otherwise) on `device`, from seed-0 weights, and its inputs."""
    from idc_models_tpu_torch.train.state import TrainState, rmsprop
    from idc_models_tpu_torch.train.step import make_train_step

    model = core.init_params(mobilenet.mobilenet_v2(
        1, bn_frozen_below=100, depthwise_impl="fused"), 0).to(device)
    opt = rmsprop(model, 1e-5,
                  trainable_mask=mobilenet.fine_tune_mask(model, 100))
    step = make_train_step(TrainState(model, opt), binary_cross_entropy,
                           compute_dtype=compute_dtype)
    gen = torch.Generator().manual_seed(1)
    x = torch.rand(batch, 50, 50, 3, generator=gen).to(device)
    y = (torch.arange(batch) % 2).to(torch.int32).to(device)
    return model, opt, step, x, y


def test_program_report_on_the_card_measures_memory_and_the_kernel(cuda):
    """On the card `program_report` measures the call's memory, and the
    fused chains' analytic account (at bf16's itemsize 2) merges into
    its count: the 11 frozen chains launch the kernel, a ctypes call the
    op count cannot see."""
    from idc_models_tpu_torch.observe import profile as prof

    model, opt, step, x, y = _fused_mobilenet_step("cuda", batch=32)
    before = fc.KERNEL.launches
    cost, m = prof.program_report(step, x, y, name="gpu.step",
                                  arguments=(model, opt))
    assert fc.KERNEL.launches - before == mobilenet.fused_chain_count(
        100, train=True) == 11
    assert torch.isfinite(m["loss"])
    assert cost.argument_bytes > 0 and cost.temp_bytes > 0
    assert cost.peak_hbm_bytes == cost.argument_bytes + cost.temp_bytes
    assert cost.output_bytes is not None
    assert set(cost.missing) == {"alias_bytes", "generated_code_bytes"}
    k_flops, k_bytes = fc.depthwise_chain_cost(
        mobilenet.fused_call_shapes(32, 50)[:11], itemsize=2)
    merged = prof.augment_cost(cost, flops=k_flops, bytes_accessed=k_bytes)
    assert merged.flops == cost.flops + k_flops
    assert merged.bytes_accessed == cost.bytes_accessed + k_bytes


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_fused_mobilenet_step_on_the_card_matches_the_cpu(cuda, dtype):
    """The fused MobileNetV2 at `dtype` through the kernel on the card
    against the plain version on the CPU, from the same weights and
    inputs: eval logits, then one fine-tune step. Every convolution,
    the fused depthwise chains included, sees `dtype` in and out.

    bf16: the eval logits within 5e-2 of the largest |logit| (measured
    on the H100 over two weight seeds and three inputs: 2.9e-3 to
    2.3e-2, each layer's bf16 rounding of sums taken in another order),
    the train step's loss within 2e-2 relative. Its gradients are not
    held: through the train-mode BNs of blocks 11-16 bf16 rounding moves
    them by amounts comparable to the gradients themselves between any
    two implementations (the CPU's grouped conv against the CPU's f32
    step as much as cuDNN against the kernel). f32: the eval logits
    within 1e-5 of the largest |logit| (measured 1.6e-6), the loss
    within 1e-5 relative, and all trained gradients together within
    1e-4 of their norm (a BN bias whose every path runs into a
    train-mode BN has a zero gradient but rounding noise, so tensors are
    not held one by one)."""
    from idc_models_tpu_torch.train.step import make_eval_step

    dt = getattr(torch, dtype)
    results = {}
    for device in ("cuda", "cpu"):
        model, _, step, x, y = _fused_mobilenet_step(device,
                                                     compute_dtype=dt)
        seen = set()
        for mod in model.modules():
            if isinstance(mod, (core.Conv2d, core.DepthwiseConv2d)):
                mod.register_forward_hook(
                    lambda m, a, out: seen.update({a[0].dtype, out.dtype}))
        before = fc.KERNEL.launches
        logits = make_eval_step(model, binary_cross_entropy,
                                compute_dtype=dt)(x, y)["logits"]
        m = step(x, y)
        if device == "cuda":
            assert fc.KERNEL.launches - before == 17 + 11
        assert seen == {dt}, (device, seen)
        results[device] = (logits.cpu(), float(m["loss"]), torch.cat([
            p.grad.float().cpu().reshape(-1)
            for p in model.parameters() if p.grad is not None]))
    (card_z, card_loss, card_g), (cpu_z, cpu_loss, cpu_g) = (
        results["cuda"], results["cpu"])
    z_err = float((card_z - cpu_z).abs().max() / cpu_z.abs().max())
    if dtype == "bfloat16":
        assert z_err <= 5e-2
        assert card_loss == pytest.approx(cpu_loss, rel=2e-2)
    else:
        assert z_err <= 1e-5
        assert card_loss == pytest.approx(cpu_loss, rel=1e-5)
        assert float((card_g - cpu_g).norm()) <= 1e-4 * float(cpu_g.norm())


def test_sharded_lm_on_a_one_rank_nccl_group_matches_the_plain_lm(
        cuda, tmp_path):
    """A 1-rank NCCL group (file:// rendezvous): the LM under LM_RULES on
    an fsdp x tp x seq mesh of one rank -- gathers, splits and the
    vocab-parallel loss over the group, the pallas ring -- takes the
    plain LM's steps (losses rtol 1e-5) with the same flash launches."""
    import numpy as np
    import torch.distributed as dist

    from idc_models_tpu_torch import mesh
    from idc_models_tpu_torch.models.lm import (
        AttentionLM, make_lm_train_step, next_token_loss,
    )
    from idc_models_tpu_torch.train.state import TrainState, rmsprop
    from idc_models_tpu_torch.train.step import make_train_step

    rng = np.random.default_rng(0)
    seqs = torch.as_tensor((rng.integers(0, 64, (2, 1)) + np.arange(256))
                           % 64).cuda()
    kw = dict(embed_dim=64, num_heads=2, mlp_dim=128, num_blocks=2,
              block_impl="pallas")
    mesh.initialize_multihost(f"file://{tmp_path / 'store'}", 1, 0)
    try:
        assert dist.get_backend() == "nccl"
        runs = {}
        for name in ("plain", "plan"):
            grid = mesh.fsdp_tp_mesh(1, 1, 1) if name == "plan" else None
            model = core.init_params(AttentionLM(64, 256, mesh=grid, **kw),
                                     0).cuda()
            if grid is not None:
                model.shard_(registry.LM_RULES)
            state = TrainState(model, rmsprop(model, 3e-3))
            step = (make_lm_train_step(state, global_batch=2) if grid
                    else make_train_step(state, next_token_loss))
            before = [k.launches for k in fbk.KERNELS]
            runs[name] = ([float(step(seqs, seqs)["loss"])
                           for _ in range(2)],
                          [k.launches - b for k, b in zip(fbk.KERNELS,
                                                          before)])
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(runs["plan"][0], runs["plain"][0], rtol=1e-5)
    assert runs["plan"][1] == runs["plain"][1] == [4, 4, 4]


# -- serving (ring_decode.py's batched and chunk folds, serve/engine.py) ---

def _fold_inputs(b, t, h, d, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(*shape, generator=g) for shape in
            ((b, t, h, d), (b, t, h, d), (b, 1, h, d), (b, 1, h, d),
             (b, 1, h, d))]


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_batched_fold_on_the_card_matches_the_cpu(cuda, quantized):
    """The batched fold at 4 rows (two live, one dead mid-cache, one
    dead at pos == t_max) on the card against the CPU: outputs of the
    live rows and both caches (int8 appends bit for bit), the dead rows'
    cache rows untouched."""
    from idc_models_tpu_torch import ring_decode as tdecode

    b, t, h, d = 4, 256, 8, 64
    kc, vc, q, k, v = _fold_inputs(b, t, h, d, 0)
    scales = ()
    if quantized:
        kc, vc = (torch.clamp(torch.round(x * 40), -127, 127).to(torch.int8)
                  for x in (kc, vc))
        scales = (torch.rand(b, h) * 0.02 + 0.005,
                  torch.rand(b, h) * 0.02 + 0.005)
    pos = torch.tensor([0, 200, 17, t])
    live = torch.tensor([True, True, False, False])
    fold = tdecode.make_batched_ring_decode(quantized=quantized)
    want = fold(kc.clone(), vc.clone(), q, k, v, pos, live, *scales)
    got = fold(kc.cuda(), vc.cuda(), q.cuda(), k.cuda(), v.cuda(),
               pos.cuda(), live.cuda(), *(s.cuda() for s in scales))
    torch.testing.assert_close(got[0].cpu()[live], want[0][live], **F32_TOL)
    for g, w, before in zip(got[1:], want[1:], (kc, vc)):
        if quantized:
            assert torch.equal(g.cpu(), w)
        else:
            torch.testing.assert_close(g.cpu(), w, **F32_TOL)
        assert torch.equal(g.cpu()[~live], before[~live])


def test_chunk_fold_on_the_card_matches_the_cpu(cuda):
    """A ragged chunk (64 of 128 positions real) at 256 over a 1,024-slot
    cache: the real queries' outputs and both caches."""
    from idc_models_tpu_torch import ring_decode as tdecode

    g = torch.Generator().manual_seed(1)
    kc, vc = (torch.randn(2, 1024, 8, 64, generator=g) for _ in range(2))
    q, k, v = (torch.randn(2, 128, 8, 64, generator=g) for _ in range(3))
    fold = tdecode.make_chunk_ring_decode()
    want = fold(kc.clone(), vc.clone(), q, k, v, 256, 320)
    got = fold(kc.cuda(), vc.cuda(), q.cuda(), k.cuda(), v.cuda(), 256, 320)
    torch.testing.assert_close(got[0].cpu()[:, :64], want[0][:, :64],
                               **F32_TOL)
    for gc, wc in zip(got[1:], want[1:]):
        torch.testing.assert_close(gc.cpu(), wc, **F32_TOL)


def _engine_against_serial(eng, gen, what):
    """Six requests through a 4-slot engine with recycling, windows of
    one step, against each request alone through the serial `gen` on the
    card: every step's logits within 1e-5 of the largest |logit|, tokens
    equal up to the first step where the serial top-2 margin falls below
    that; prints whether any bit differed."""
    g = torch.Generator().manual_seed(2)
    prompts = [torch.randint(0, 64, (int(n),), generator=g).tolist()
               for n in torch.randint(5, 120, (6,), generator=g)]
    budgets = [int(n) for n in torch.randint(8, 40, (6,), generator=g)]
    queue, slot_of = list(range(6)), {}
    toks = {i: [] for i in queue}
    seen = {i: [] for i in queue}
    while queue or slot_of:
        for s in eng.free_slots():
            if queue:
                i = queue.pop(0)
                eng.admit(s, prompts[i], budgets[i])
                slot_of[s] = i
        for s, i in slot_of.items():
            seen[i].append(eng._logits[s].clone())
        for s, row in eng.step_window(1).items():
            toks[slot_of[s]] += row
        for s in [s for s in slot_of if eng.finished(s)]:
            eng.release(s)
            del slot_of[s]
    held = total = same_bits = 0
    for i, (p, n) in enumerate(zip(prompts, budgets)):
        logits, caches = gen.prefill([p])
        bits = True
        for j in range(n):
            scale = float(logits.abs().max())
            diff = float((seen[i][j] - logits[0]).abs().max())
            bits &= diff == 0.0
            assert diff <= 1e-5 * scale, (i, j, diff, scale)
            top2 = logits[0].topk(2).values
            total += 1
            if float(top2[0] - top2[1]) < 1e-5 * scale:
                total += n - j - 1
                break
            tok, logits, caches = gen.decode(caches, logits, len(p) + j, 1)
            assert toks[i][j] == int(tok[0, 0]), (i, j)
            held += 1
        same_bits += bits
    print(f"{what} vs serial on the card: tokens held {held} of {total} "
          f"steps; logits bit-equal in {same_bits} of 6 requests")


def _card_lm():
    from idc_models_tpu_torch.models.lm import AttentionLM

    model = core.init_params(AttentionLM(64, 256, embed_dim=128,
                                         num_heads=4, mlp_dim=256,
                                         num_blocks=2), 0)
    kw = dict(embed_dim=128, num_heads=4, num_blocks=2, t_max=256,
              cache_dtype=torch.float32, device="cuda")
    return model, kw


def test_engine_greedy_on_the_card_meets_the_serial_contract(cuda):
    """A 4-slot engine (f32 caches) against the serial Generator on the
    card (`_engine_against_serial`)."""
    from idc_models_tpu_torch.models.lm import Generator
    from idc_models_tpu_torch.serve import SlotEngine

    model, kw = _card_lm()
    _engine_against_serial(SlotEngine(model, n_slots=4, **kw),
                           Generator(model, **kw), "engine")


def test_paged_engine_greedy_on_the_card_meets_the_serial_contract(cuda):
    """A 4-slot PAGED engine (f32 pools of 16-token pages, chunks of 32,
    40 pages) against the serial chunked Generator on the card, and
    every page back at the end."""
    from idc_models_tpu_torch.models.lm import Generator
    from idc_models_tpu_torch.serve import SlotEngine

    model, kw = _card_lm()
    eng = SlotEngine(model, n_slots=4, prefill_chunk=32, kv_page_size=16,
                     kv_pages=40, **kw)
    _engine_against_serial(eng, Generator(model, prefill_chunk=32, **kw),
                           "paged engine")
    assert eng._alloc.used_count() == 0


def _paged_case(b, h, d, ps, n_pages, seed, quantized):
    """Contiguous [b, t] caches scattered into a pool of `n_pages` pages
    by a random table (row b's last page left unallocated; the pool's
    last page is the folds' sink, named by no row), with int8 levels and
    per-page scales when `quantized`."""
    g = torch.Generator().manual_seed(seed)
    t = 256
    l_pages = t // ps
    kc, vc = (torch.randn(b, t, h, d, generator=g) for _ in range(2))
    pt = torch.randperm(n_pages - 1, generator=g)[:b * l_pages].reshape(
        b, l_pages).to(torch.int32)
    pt[-1, -1] = -1
    pools = []
    for c in (kc, vc):
        pool = torch.randn(n_pages, ps, h, d, generator=g)
        for r in range(b):
            for j in range(l_pages):
                if pt[r, j] >= 0:
                    pool[pt[r, j]] = c[r, j * ps:(j + 1) * ps]
        pools.append(pool)
    scales = ()
    if quantized:
        pools = [torch.clamp(torch.round(x * 40), -127, 127).to(torch.int8)
                 for x in pools]
        scales = (torch.rand(n_pages, h, generator=g) * 0.02 + 0.005,
                  torch.rand(n_pages, h, generator=g) * 0.02 + 0.005)
    return kc, vc, pt, pools, scales


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_paged_folds_on_the_card_match_the_cpu(cuda, quantized):
    """The paged batched fold (4 rows: two live, a dead one, a live one
    whose page is unallocated) and the paged chunk fold (a ragged chunk,
    48 of 64 positions real, at 128) over pools of 16-token pages on the
    card against the CPU: the live rows' and real queries' outputs, the
    pools (int8 appends bit for bit) and the chunk's new int8 scales."""
    from idc_models_tpu_torch import ring_decode as tdecode

    _, _, pt, (kp, vp), scales = _paged_case(4, 8, 64, 16, 80, 3,
                                             quantized)
    g = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(4, 1, 8, 64, generator=g) for _ in range(3))
    pos = torch.tensor([0, 200, 17, 250])
    live = torch.tensor([True, True, False, True])
    fold = tdecode.make_paged_batched_ring_decode(page_size=16,
                                                  quantized=quantized)
    want = fold(kp.clone(), vp.clone(), pt, q, k, v, pos, live,
                *(s.clone() for s in scales))
    got = fold(kp.cuda(), vp.cuda(), pt.cuda(), q.cuda(), k.cuda(),
               v.cuda(), pos.cuda(), live.cuda(), *(s.cuda() for s in scales))
    torch.testing.assert_close(got[0].cpu()[live], want[0][live], **F32_TOL)
    for a, w in zip(got[1:], want[1:]):
        if quantized:
            assert torch.equal(a.cpu(), w)
        else:
            torch.testing.assert_close(a.cpu(), w, **F32_TOL)
    q, k, v = (torch.randn(1, 64, 8, 64, generator=g) for _ in range(3))
    chunk = tdecode.make_paged_chunk_ring_decode(page_size=16,
                                                 quantized=quantized)
    want = chunk(kp.clone(), vp.clone(), pt[:1], q, k, v, 128, 176,
                 *(s.clone() for s in scales))
    got = chunk(kp.cuda(), vp.cuda(), pt[:1].cuda(), q.cuda(), k.cuda(),
                v.cuda(), 128, 176, *(s.cuda() for s in scales))
    torch.testing.assert_close(got[0].cpu()[:, :48], want[0][:, :48],
                               **F32_TOL)
    for a, w in zip(got[1:], want[1:]):
        if quantized and a.dtype == torch.int8:
            # the chunk's levels round x / scale: a tie may flip one level
            assert (a.cpu().int() - w.int()).abs().max() <= 1
        else:
            torch.testing.assert_close(a.cpu(), w, **F32_TOL)


def test_paged_folds_on_the_card_are_bit_equal_to_the_contiguous(cuda):
    """On the card, the paged batched and chunk folds over scattered
    pages give the contiguous folds' outputs and appends bit for bit
    (f32 and bf16 caches): the gathered view holds the same values in
    the same order."""
    from idc_models_tpu_torch import ring_decode as tdecode

    for dtype in (torch.float32, torch.bfloat16):
        kc, vc, pt, (kp, vp), _ = _paged_case(4, 8, 64, 16, 80, 5, False)
        full = (pt >= 0).all(1)
        g = torch.Generator().manual_seed(6)
        q, k, v = (torch.randn(4, 1, 8, 64, generator=g) for _ in range(3))
        pos = torch.tensor([0, 200, 17, 230])
        live = torch.tensor([True, True, False, True]) & full
        kc, vc, kp, vp = (x.to(dtype).cuda() for x in (kc, vc, kp, vp))
        dev = [x.cuda() for x in (q, k, v, pos, live)]
        out_c, kc2, _ = tdecode.make_batched_ring_decode()(kc, vc, *dev)
        out_p, kp2, _ = tdecode.make_paged_batched_ring_decode(
            page_size=16)(kp, vp, pt.cuda(), *dev)
        live = live.cuda()
        assert torch.equal(out_p[live], out_c[live]), dtype
        ptc = pt.cuda().long()
        view = kp2[ptc.clamp(min=0)].reshape(4, 256, 8, 64)
        assert torch.equal(view[live], kc2[live]), dtype
        q, k, v = (torch.randn(1, 64, 8, 64, generator=g).cuda()
                   for _ in range(3))
        out_c, kc2, _ = tdecode.make_chunk_ring_decode()(
            kc[:1].clone(), vc[:1].clone(), q, k, v, 128, 176)
        out_p, kp2, _ = tdecode.make_paged_chunk_ring_decode(
            page_size=16)(kp, vp, pt[:1].cuda(), q, k, v, 128, 176)
        assert torch.equal(out_p[:, :48], out_c[:, :48]), dtype
        view = kp2[ptc[:1]].reshape(1, 256, 8, 64)
        assert torch.equal(view[:, :176], kc2[:, :176]), dtype


# -- speculative decoding (ring_decode.py's batched chunk folds, the
# -- engine's verify) ---------------------------------------------------


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_batched_chunk_folds_on_the_card_match_the_cpu(cuda, quantized):
    """The verify's two folds on the card against the CPU, 8 draft
    queries a row: the contiguous fold (two live rows, a dead one mid-
    cache, a dead one at t_max) and the paged fold over 16-token pages
    (two live rows, a dead one, a live one whose chunk runs onto its
    unallocated last page): the live rows' outputs, the caches and pools
    (int8 appends bit for bit), the dead rows' cache rows untouched, no
    page scale written."""
    from idc_models_tpu_torch import ring_decode as tdecode

    b, t, h, d, c = 4, 256, 8, 64, 8
    g = torch.Generator().manual_seed(7)
    kc, vc = (torch.randn(b, t, h, d, generator=g) for _ in range(2))
    q, k, v = (torch.randn(b, c, h, d, generator=g) for _ in range(3))
    scales = ()
    if quantized:
        kc, vc = (torch.clamp(torch.round(x * 40), -127, 127).to(torch.int8)
                  for x in (kc, vc))
        scales = (torch.rand(b, h, generator=g) * 0.02 + 0.005,
                  torch.rand(b, h, generator=g) * 0.02 + 0.005)
    pos = torch.tensor([0, 200, 17, t])
    live = torch.tensor([True, True, False, False])
    fold = tdecode.make_batched_chunk_ring_decode(quantized=quantized)
    want = fold(kc.clone(), vc.clone(), q, k, v, pos, live, *scales)
    got = fold(kc.cuda(), vc.cuda(), q.cuda(), k.cuda(), v.cuda(),
               pos.cuda(), live.cuda(), *(s.cuda() for s in scales))
    torch.testing.assert_close(got[0].cpu()[live], want[0][live], **F32_TOL)
    for a, w, before in zip(got[1:], want[1:], (kc, vc)):
        if quantized:
            assert torch.equal(a.cpu(), w)
        else:
            torch.testing.assert_close(a.cpu(), w, **F32_TOL)
        assert torch.equal(a.cpu()[~live], before[~live])
    _, _, pt, (kp, vp), scales = _paged_case(4, h, d, 16, 80, 8, quantized)
    pos = torch.tensor([0, 200, 17, 244])
    live = torch.tensor([True, True, False, True])
    fold = tdecode.make_paged_batched_chunk_ring_decode(page_size=16,
                                                        quantized=quantized)
    want = fold(kp.clone(), vp.clone(), pt, q, k, v, pos, live,
                *(s.clone() for s in scales))
    dev_scales = [s.cuda() for s in scales]
    got = fold(kp.cuda(), vp.cuda(), pt.cuda(), q.cuda(), k.cuda(),
               v.cuda(), pos.cuda(), live.cuda(), *dev_scales)
    torch.testing.assert_close(got[0].cpu()[live], want[0][live], **F32_TOL)
    for a, w in zip(got[1:], want[1:]):
        a, w = a.cpu()[:-1], w[:-1]            # the sink page aside
        if quantized:
            assert torch.equal(a, w)
        else:
            torch.testing.assert_close(a, w, **F32_TOL)
    for s, before in zip(dev_scales, scales):
        assert torch.equal(s.cpu(), before)


class _Scripted:
    """A drafter replaying known streams at a fixed accepted length a
    request (the rest of each draft off by one)."""

    def __init__(self, k, plans, vocab=64):
        self.k, self.plans, self.vocab = k, plans, vocab

    def propose(self, history):
        import numpy as np

        h = [int(x) for x in history]
        for prompt, stream, accept in self.plans:
            if h[:len(prompt)] != list(prompt):
                continue
            done = len(h) - len(prompt)
            cont = list(stream[done:done + self.k])
            cont += [0] * (self.k - len(cont))
            for j in range(accept, self.k):
                cont[j] = (cont[j] + 1) % self.vocab
            return np.asarray(cont, np.int64)
        return None


@pytest.mark.parametrize("kind", ["greedy", "sampled", "paged"])
def test_spec_server_on_the_card_matches_spec_off(cuda, kind):
    """On the card, the spec-off server's streams fed back through a
    scripted drafter at mixed accepted lengths come out of the spec-on
    server unchanged: greedy, sampled (each verify's K+1 draws rewound to
    its emitted count on the card's generators) and paged; and a greedy
    `begin_verify` launches its work without a host sync (CUDA sync debug
    mode "error")."""
    from idc_models_tpu_torch.observe import MetricsRegistry
    from idc_models_tpu_torch.serve import LMServer, Request

    model, kw = _card_lm()
    extra = {"greedy": {}, "sampled": dict(temperature=0.9, top_k=8),
             "paged": dict(prefill_chunk=32, kv_page_size=16,
                           kv_pages=40)}[kind]
    g = torch.Generator().manual_seed(3)
    reqs = [Request(id=f"c{i}", prompt=tuple(
        torch.randint(0, 64, (int(n),), generator=g).tolist()),
        max_new_tokens=int(b), seed=50 + i)
        for i, (n, b) in enumerate(zip(torch.randint(5, 90, (6,), generator=g),
                                       torch.randint(8, 30, (6,), generator=g)))]

    def run(**more):
        server = LMServer(model, n_slots=4, window=4,
                          registry=MetricsRegistry(), **kw, **extra, **more)
        server.run([(0.0, r) for r in reqs])
        return server, {r.id: server.poll(r.id).tokens for r in reqs}

    _, base = run()
    plans = [(r.prompt, base[r.id], a) for r, a in zip(reqs, (4, 0, 2, 4, 1, 3))]
    server, got = run(spec_decode=True, draft_k=4,
                      drafter=_Scripted(4, plans))
    assert got == base
    s = server.summary()
    assert s["serve_spec_verify_dispatches"] > 0 and s["serve_spec_accepted"]
    if kind != "greedy":
        return
    eng = server.engine
    eng.admit(0, reqs[0].prompt, 8)
    drafts = torch.zeros((4, 4), dtype=torch.long).numpy()
    live = torch.tensor([True, False, False, False]).numpy()
    eng.begin_verify(drafts, live)
    eng.collect()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.begin_verify(drafts, live)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(eng.collect()[0]) == 1


def _res_requests(n, lo, hi, budget, seed):
    """`n` requests of `lo`..`hi` prompt tokens over the card LM's vocab
    of 64, each with budget `budget`."""
    from idc_models_tpu_torch.serve import Request

    g = torch.Generator().manual_seed(seed)
    return [Request(id=f"q{i}", prompt=tuple(torch.randint(
        0, 64, (int(p),), generator=g).tolist()), max_new_tokens=budget)
        for i, p in enumerate(torch.randint(lo, hi, (n,), generator=g))]


def test_health_reduce_catches_nan_and_huge_logits_on_the_card(cuda):
    """The per-cycle health reduce on card logits: NaN reads as code 1
    (nonfinite_logits), +1e32 and -1e32 as code 2 (logit_magnitude),
    clean rows as 0."""
    from idc_models_tpu_torch.serve import HEALTH_KINDS, SlotEngine

    model, kw = _card_lm()
    eng = SlotEngine(model, n_slots=4, **kw)
    for s in range(4):
        eng.admit(s, (1, 2, 3 + s), 4)
    assert eng.slot_health().tolist() == [0, 0, 0, 0]
    eng.inject_slot_fault(0, "nan_logits")
    eng.inject_slot_fault(1, "garbage_logits")
    eng._logits[2, 5] = -1e32
    codes = eng.slot_health()
    assert [HEALTH_KINDS.get(int(c)) for c in codes] == [
        "nonfinite_logits", "logit_magnitude", "logit_magnitude", None]


def test_retried_request_on_the_pallas_server_equals_its_unfaulted_run(
        cuda):
    """A NaN-poisoned slot on the pallas bf16 server (the flash kernel
    prefills every admission, a retry's too): quarantined, retried once,
    and its tokens equal the unfaulted run's bit for bit; B3 launches
    twice an admission."""
    from idc_models_tpu_torch.observe import MetricsRegistry
    from idc_models_tpu_torch.serve import (
        LMServer, RetryPolicy, ServeFault, ServeFaultPlan,
    )

    model, kw = _card_lm()
    kw = dict(kw, cache_dtype=torch.bfloat16, block_impl="pallas")
    reqs = _res_requests(3, 100, 140, 24, 5)

    def run(**more):
        server = LMServer(model, n_slots=2, window=4,
                          registry=MetricsRegistry(), **kw, **more)
        torch.cuda.synchronize()
        before = fbk.KERNELS[0].launches
        server.run([(0.0, r) for r in reqs])
        torch.cuda.synchronize()
        return server, fbk.KERNELS[0].launches - before

    clean, clean_launches = run()
    faulted, launches = run(
        fault_plan=ServeFaultPlan([ServeFault("nan_logits", 2, slot=0)]),
        retry=RetryPolicy(max_retries=1, backoff_s=0.0))
    assert clean_launches == 2 * len(reqs)
    assert launches == 2 * (len(reqs) + 1)
    assert faulted.summary()["serve_slot_faults"] == 1
    assert [faulted.poll(r.id).attempts for r in reqs].count(2) == 1
    for r in reqs:
        assert faulted.poll(r.id).status == "ok"
        assert faulted.poll(r.id).tokens == clean.poll(r.id).tokens


def test_crash_and_journal_recovery_on_the_card(cuda, tmp_path):
    """A crash mid-run with a journal; a new server on the same weights
    re-admits the pending requests, and every request's tokens equal an
    uncrashed run's bit for bit."""
    from idc_models_tpu_torch.observe import MetricsRegistry
    from idc_models_tpu_torch.serve import (
        InjectedEngineCrash, LMServer, ServeFault, ServeFaultPlan,
        pending_requests,
    )

    model, kw = _card_lm()
    reqs = _res_requests(5, 3, 40, 16, 6)

    def server(**more):
        return LMServer(model, n_slots=2, window=4,
                        registry=MetricsRegistry(), **kw, **more)

    clean = server()
    clean.run([(0.0, r) for r in reqs])
    wal = tmp_path / "wal.jsonl"
    a = server(journal=wal,
               fault_plan=ServeFaultPlan([ServeFault("crash", 4)]))
    with pytest.raises(InjectedEngineCrash):
        a.run([(0.0, r) for r in reqs])
    a.close()
    pending = [r.id for r in pending_requests(wal)]
    assert pending
    b = server(journal=wal)
    assert b.resubmit_pending(wal) == pending
    b.drain()
    b.close()
    for r in reqs:
        got = b.poll(r.id) if r.id in pending else a.poll(r.id)
        assert got.status == "ok"
        assert got.tokens == clean.poll(r.id).tokens
    assert pending_requests(wal) == []


def test_armed_clean_tick_makes_no_host_sync_on_the_card(cuda, tmp_path):
    """A steady tick of a server with a journal, a brownout and an empty
    fault plan armed (health checks off: their [S] fetch is the one sync
    they add, by design) runs under CUDA's sync debug mode "error": the
    collect waits on the window's event only, and the journal, the
    brownout and the next window's issue never synchronize."""
    from idc_models_tpu_torch.observe import MetricsRegistry
    from idc_models_tpu_torch.serve import (
        BrownoutController, LMServer, ServeFaultPlan,
    )

    model, kw = _card_lm()
    server = LMServer(
        model, n_slots=2, window=4, registry=MetricsRegistry(),
        journal=tmp_path / "wal.jsonl", fault_plan=ServeFaultPlan(),
        health_checks=False,
        brownout=BrownoutController(queue_high=64,
                                    registry=MetricsRegistry()), **kw)
    for r in _res_requests(2, 3, 10, 64, 7):
        server.submit(r)
    while len(server.scheduler._running) < 2:
        server.step()
    server.step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            assert server.step() == []
    finally:
        torch.cuda.set_sync_debug_mode("default")
    server.drain()
    assert server.summary()["serve_requests"] == 2


def _card_tenancy(adapter_scale=0.5, *, n=3, rank=4, vocab=64, seed=0):
    """A registry of `n` tenants (t0, t1, ...), each with a rank-`rank`
    logit adapter over the card LM's vocab, drawn from `seed`."""
    import numpy as np

    from idc_models_tpu_torch.serve import TenantRegistry

    rng = np.random.default_rng(seed)
    reg = TenantRegistry()
    for i in range(n):
        reg.register(f"t{i}", adapter=(
            rng.normal(0, adapter_scale, (vocab, rank)).astype(np.float32),
            rng.normal(0, adapter_scale, (rank, vocab)).astype(np.float32)))
    return reg


def test_adapter_hook_on_the_card_matches_the_cpu(cuda):
    """The pick-time adapter hook on [S, V] and [S, K+1, V] card logits
    against the same hook on the CPU within 1e-6 of the largest |logit|
    (the two devices sum the products in different orders), and a zero
    row bit for bit."""
    from idc_models_tpu_torch.models.lm import make_adapter_head_hook

    u = torch.randn(3, 1024, 8, generator=cuda, device="cuda") * 0.05
    v = torch.randn(3, 8, 1024, generator=cuda, device="cuda") * 0.05
    u[0], v[0] = 0.0, 0.0
    tslot = torch.tensor([1, 0, 2, 1, 2, 0, 1, 2], device="cuda")
    for shape in ((8, 1024), (8, 5, 1024)):
        logits = torch.randn(*shape, generator=cuda, device="cuda") * 4.0
        got = make_adapter_head_hook(u, v, tslot)(logits)
        want = make_adapter_head_hook(u.cpu(), v.cpu(), tslot.cpu())(
            logits.cpu())
        err = float((got.cpu() - want).abs().max())
        assert err <= 1e-6 * float(want.abs().max()), err
        assert torch.equal(got[1], logits[1]) and torch.equal(
            got[5], logits[5])


def test_tenanted_pallas_server_launches_b3_twice_an_admission(cuda):
    """A three-tenant pallas bf16 server with adapters: the flash update
    kernel prefills every admission, whatever its tenant (two launches,
    one a block), and each tenant's tokens equal a one-tenant server's."""
    from idc_models_tpu_torch.observe import MetricsRegistry
    from idc_models_tpu_torch.serve import LMServer, Request, TenantRegistry

    model, kw = _card_lm()
    kw = dict(kw, cache_dtype=torch.bfloat16, block_impl="pallas")
    reqs = [Request(id=r.id, prompt=r.prompt, max_new_tokens=6,
                    tenant=f"t{i % 3}")
            for i, r in enumerate(_res_requests(6, 100, 140, 6, 8))]
    reg = _card_tenancy()
    server = LMServer(model, n_slots=4, window=4,
                      registry=MetricsRegistry(), tenancy=reg, **kw)
    torch.cuda.synchronize()
    before = fbk.KERNELS[0].launches
    server.run([(0.0, r) for r in reqs])
    torch.cuda.synchronize()
    assert fbk.KERNELS[0].launches - before == 2 * len(reqs)
    bank = server.tenancy.bank
    for i in range(3):
        solo = TenantRegistry()
        solo.register(f"t{i}", adapter=(bank.u[i], bank.v[i]))
        alone = LMServer(model, n_slots=4, window=4,
                         registry=MetricsRegistry(), tenancy=solo, **kw)
        mine = [r for r in reqs if r.tenant == f"t{i}"]
        alone.run([(0.0, r) for r in mine])
        for r in mine:
            assert server.poll(r.id).status == "ok"
            assert server.poll(r.id).tokens == alone.poll(r.id).tokens


def test_tenanted_window_makes_no_host_sync_on_the_card(cuda):
    """With an adapter bank armed, the window's hook (one gather a
    window, two small products a step) adds no host sync: steady ticks
    run under CUDA's sync debug mode "error"."""
    from idc_models_tpu_torch.observe import MetricsRegistry
    from idc_models_tpu_torch.serve import LMServer

    model, kw = _card_lm()
    server = LMServer(model, n_slots=2, window=4, registry=MetricsRegistry(),
                      tenancy=_card_tenancy(), health_checks=False, **kw)
    for i, r in enumerate(_res_requests(2, 3, 10, 64, 9)):
        server.submit(type(r)(id=r.id, prompt=r.prompt,
                              max_new_tokens=r.max_new_tokens,
                              tenant=f"t{i + 1}"))
    while len(server.scheduler._running) < 2:
        server.step()
    server.step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            assert server.step() == []
    finally:
        torch.cuda.set_sync_debug_mode("default")
    server.drain()
    assert server.summary()["serve_tenants"]["t1"]["requests"] == 1


# -- phase 17: weight rollout and the one-server drain ----------------------


def _card_candidate():
    """The card LM's seed-1 weights as a host tree: the rollout's
    candidate."""
    from idc_models_tpu_torch import convert
    from idc_models_tpu_torch.models.lm import AttentionLM

    return convert.to_jax(core.init_params(AttentionLM(
        64, 256, embed_dim=128, num_heads=4, mlp_dim=256, num_blocks=2),
        1))[0]


def test_swap_params_is_ordered_behind_the_window_in_flight(cuda):
    """swap_params issued while a 32-step window of 4 slots is still on
    the card: that window's tokens are the old weights' (an engine that
    swapped after collecting), and the next window's the new ones'."""
    import numpy as np

    from idc_models_tpu_torch.serve import SlotEngine

    model, kw = _card_lm()
    cand = _card_candidate()
    a, b = (SlotEngine(model, n_slots=4, **kw) for _ in range(2))
    rng = np.random.default_rng(4)
    for s in range(4):
        p = rng.integers(0, 64, 20)
        a.admit(s, p, 100)
        b.admit(s, p, 100)
    torch.cuda.synchronize()
    a.begin_window(32)
    a.swap_params(cand)
    first = a.collect()
    assert first == b.step_window(32)
    b.swap_params(cand)
    second = a.step_window(32)
    assert second == b.step_window(32)
    assert first != second


def test_pallas_spot_check_launches_b3_twice_and_touches_nothing(cuda):
    """A pallas bf16 server mid-request: a spot-check launches the flash
    update kernel twice (its prefill at the 128 bucket, one a block) and
    leaves every cache row, logit, position and budget bit-equal."""
    from idc_models_tpu_torch.observe import MetricsRegistry
    from idc_models_tpu_torch.serve import LMServer, Request

    model, kw = _card_lm()
    kw = dict(kw, cache_dtype=torch.bfloat16, block_impl="pallas")
    server = LMServer(model, n_slots=2, window=4,
                      registry=MetricsRegistry(), **kw)
    # a pallas prefill takes buckets of at least 128 (the kernel's tile)
    server.submit(Request(id="a", prompt=tuple(i % 63 + 1
                                               for i in range(130)),
                          max_new_tokens=30))
    server.step()
    server.quiesce()
    eng = server.engine
    state = [t.clone() for pair in eng._caches for t in pair] + [
        eng._logits.clone(), eng._pos.clone(), eng._rem.clone()]
    torch.cuda.synchronize()
    before = fbk.KERNELS[0].launches
    check = eng.spot_check_params(_card_candidate())
    torch.cuda.synchronize()
    assert check["ok"] and fbk.KERNELS[0].launches - before == 2
    after = [t for pair in eng._caches for t in pair] + [
        eng._logits, eng._pos, eng._rem]
    assert all(torch.equal(x, y) for x, y in zip(state, after))
    server.drain()
    assert server.poll("a").status == "ok"


def test_sampled_slot_migrates_between_card_engines_bit_for_bit(cuda):
    """A sampled request exported after one window and imported into
    another card engine's other slot (its CUDA generator's state in the
    snapshot) equals the same request unmigrated, bit for bit."""
    import numpy as np

    from idc_models_tpu_torch.serve import SlotEngine

    model, kw = _card_lm()
    kw = dict(kw, temperature=0.8, top_k=20)
    src, dst, ref = (SlotEngine(model, n_slots=4, **kw) for _ in range(3))
    prompt = np.random.default_rng(6).integers(0, 64, 30)
    for eng in (src, ref):
        eng.admit(2, prompt, 40, rng=11)
    moved = src.step_window(8)[2]
    stay = ref.step_window(8)[2]
    snap = src.export_slot(2)
    src.release(2)
    dst.import_slot(0, snap)
    while dst._occupied[0] and dst._rem_h[0] > 0:
        moved += dst.step_window(8)[0]
    while ref._occupied[2] and ref._rem_h[2] > 0:
        stay += ref.step_window(8)[2]
    assert len(moved) == 40 and moved == stay


def test_paged_spot_check_after_quiesce_makes_no_host_sync(cuda):
    """A paged server mid-burst, quiesced: its spot-check runs under
    CUDA's sync debug mode "error" (the candidate goes up pinned, the
    verdict comes back behind an event), and leaves the grantable pages
    and the page table bit-equal."""
    from idc_models_tpu_torch.observe import MetricsRegistry
    from idc_models_tpu_torch.serve import LMServer

    model, kw = _card_lm()
    server = LMServer(model, n_slots=4, window=4, prefill_chunk=32,
                      kv_page_size=16, kv_pages=40,
                      registry=MetricsRegistry(), **kw)
    for r in _res_requests(4, 20, 60, 30, 12):
        server.submit(r)
    for _ in range(3):
        server.step()
    server.quiesce()
    eng = server.engine
    assert eng._pending is None and eng._slot_pages
    pools = [t[:-1].clone() for pair in eng._caches for t in pair]
    table = eng._pt.clone()
    cand = _card_candidate()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        check = eng.spot_check_params(cand)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert check["ok"]
    assert all(torch.equal(p, t[:-1]) for p, t in zip(
        pools, (t for pair in eng._caches for t in pair)))
    assert torch.equal(table, eng._pt)
    server.drain()
    assert all(r.status == "ok" for r in server.results())


class _Places:
    """A logger keeping the router's placements and the replicas'
    admissions."""

    def __init__(self):
        self.places, self.admits = [], 0

    def log(self, **rec):
        if rec.get("event") == "cluster_place":
            self.places.append((rec["id"], rec["replica"]))
        self.admits += rec.get("event") == "serve_admit"

    def close(self):
        pass


def _pallas_fleet(model, kw, device, log):
    from idc_models_tpu_torch.serve import Router, build_replica

    kw = dict(kw, device=device)
    return Router([build_replica(model, replica_id=f"r{i}", n_slots=2,
                                 window=4, block_impl="pallas", logger=log,
                                 **kw)
                   for i in range(2)], logger=log)


def test_pallas_router_on_the_card_places_like_the_cpu(cuda):
    """Two pallas replicas on the card behind the router: the same
    placements as the same fleet on the CPU (placement reads only host
    state), every request's tokens held to the serial card Generator
    under the 1e-5 contract, and the flash update kernel launched twice
    an admission (one a block) on the card and never on the CPU."""
    from idc_models_tpu_torch.models.lm import Generator

    model, kw = _card_lm()
    reqs = _res_requests(6, 100, 140, 10, 21)
    runs = {}
    for device in ("cpu", "cuda"):
        log = _Places()
        router = _pallas_fleet(model, kw, device, log)
        torch.cuda.synchronize()
        before = fbk.KERNELS[0].launches
        out = router.run([(0.0, r) for r in reqs])
        torch.cuda.synchronize()
        assert sorted(r.id for r in out) == sorted(r.id for r in reqs)
        assert {r.status for r in out} == {"ok"}
        runs[device] = (log.places, log.admits,
                        fbk.KERNELS[0].launches - before,
                        {r.id: r.tokens for r in out})
    assert runs["cuda"][0] == runs["cpu"][0]
    assert {rep for _, rep in runs["cuda"][0]} == {"r0", "r1"}
    assert runs["cuda"][1] == len(reqs)
    assert runs["cuda"][2] == 2 * runs["cuda"][1]
    assert runs["cpu"][2] == 0
    gen = Generator(model, **dict(kw, device="cuda"))
    held = 0
    for r in reqs:
        logits, caches = gen.prefill([list(r.prompt)])
        for j, tok in enumerate(runs["cuda"][3][r.id]):
            top2 = logits[0].topk(2).values
            if float(top2[0] - top2[1]) < 1e-5 * float(logits.abs().max()):
                break
            want, logits, caches = gen.decode(caches, logits,
                                              len(r.prompt) + j, 1)
            assert tok == int(want[0, 0]), (r.id, j)
            held += 1
    print(f"pallas router on the card: tokens held {held} of "
          f"{sum(len(t) for t in runs['cuda'][3].values())} steps")


# -- serving over ranks (ring_decode.py's merge) and the compile cache -----


@pytest.fixture
def nccl_one_rank(cuda, tmp_path):
    """A 1-rank NCCL world through a file:// rendezvous, taken down
    after the test."""
    import torch.distributed as dist

    from idc_models_tpu_torch import mesh as meshlib

    meshlib.initialize_multihost(f"file://{tmp_path}/store", 1, 0)
    try:
        assert dist.get_backend() == "nccl"
        yield meshlib.seq_mesh(1).group(meshlib.SEQ_AXIS)
    finally:
        dist.destroy_process_group()


def test_folds_on_a_one_rank_nccl_ring_equal_the_unmeshed_folds(
        nccl_one_rank):
    """Every fold (one-token, batched f32 and int8, chunk, batched
    chunk, and the three paged ones) on the card over a ring of one NCCL
    rank against the same fold without a ring: outputs and caches bit
    for bit."""
    from idc_models_tpu_torch import ring_decode as tdecode

    g = nccl_one_rank
    b, t, h, d, ps = 3, 256, 8, 64, 16
    kc, vc, q, k, v = (x.cuda() for x in _fold_inputs(b, t, h, d, 3))
    pos = torch.tensor([0, 200, 255], device="cuda")
    live = torch.tensor([True, False, True], device="cuda")
    kc8, vc8 = (torch.clamp(torch.round(x * 40), -127, 127).to(torch.int8)
                for x in (kc, vc))
    sc = (torch.rand(b, h, device="cuda") * 0.02 + 0.005,
          torch.rand(b, h, device="cuda") * 0.02 + 0.005)
    n_pages = t // ps
    kp = torch.randn(n_pages + 1, ps, h, d, device="cuda")
    vp = torch.randn(n_pages + 1, ps, h, d, device="cuda")
    pt = torch.arange(n_pages, device="cuda", dtype=torch.int32).reshape(
        1, -1).repeat(b, 1)
    pt[1, 8:] = -1
    qc, kk, vv = (torch.randn(b, 4, h, d, device="cuda") for _ in range(3))
    q1, k1, v1 = (torch.randn(1, 32, h, d, device="cuda")
                  for _ in range(3))
    cases = {
        "one": lambda gr: tdecode.make_ring_decode(group=gr)(
            kc.clone(), vc.clone(), q, k, v, 100),
        "batched": lambda gr: tdecode.make_batched_ring_decode(group=gr)(
            kc.clone(), vc.clone(), q, k, v, pos, live),
        "batched_int8": lambda gr: tdecode.make_batched_ring_decode(
            quantized=True, group=gr)(kc8.clone(), vc8.clone(), q, k, v,
                                      pos, live, *sc),
        "chunk": lambda gr: tdecode.make_chunk_ring_decode(group=gr)(
            kc[:1].clone(), vc[:1].clone(), q1, k1, v1, 64, 80),
        "batched_chunk": lambda gr: tdecode.make_batched_chunk_ring_decode(
            group=gr)(kc.clone(), vc.clone(), qc, kk, vv,
                      torch.tensor([0, 100, 250], device="cuda"), live),
        "paged": lambda gr: tdecode.make_paged_batched_ring_decode(
            page_size=ps, group=gr)(kp.clone(), vp.clone(), pt, q, k, v,
                                    pos, live),
        "paged_chunk": lambda gr: tdecode.make_paged_chunk_ring_decode(
            page_size=ps, group=gr)(kp.clone(), vp.clone(), pt[:1], q1,
                                    k1, v1, 32, 60),
        "paged_batched_chunk": lambda gr:
            tdecode.make_paged_batched_chunk_ring_decode(
                page_size=ps, group=gr)(kp.clone(), vp.clone(), pt, qc, kk,
                                        vv, pos.clamp(max=t - 4), live),
    }
    for name, run in cases.items():
        for a, w in zip(run(g), run(None)):
            assert torch.equal(a, w), name


def test_compile_cache_round_trips_an_nvcc_blob_and_evicts_a_cut_one(
        cuda, tmp_path, monkeypatch):
    """B3's library through the store: a miss builds it with nvcc in a
    fresh build directory and stores it; a fresh handle on another fresh
    directory places it from the blob, and the installed library runs
    the kernel equal to the plain version; a blob cut in half is evicted
    as a miss, and the rebuild stores it again; a blob with one byte of
    the library flipped is evicted without touching the build
    directory."""
    from idc_models_tpu_torch.ops import build
    from idc_models_tpu_torch.serve import compile_cache as ccm

    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    kern = fbk.FWD_KERNEL
    cache = ccm.CompileCache(tmp_path / "cc")
    key = cache.key(program="prefill",
                    fingerprint={"kernels": [kern.library_path().name]})
    build.set_build_dir(tmp_path / "cold")
    assert cache.load(key) is None
    cache.compile_and_store(key, [ccm.kernel_library(kern)],
                            program="prefill")
    assert cache.compile_s > 0 and cache.stores == 1
    build.set_build_dir(tmp_path / "warm")
    fresh = ccm.CompileCache(tmp_path / "cc")
    prog = fresh.load(key)
    assert prog is not None and fresh.hits == 1
    assert (tmp_path / "warm" / kern.library_path().name).exists()
    kern.install(prog.handles[kern.name])
    q, k, v, m, l, acc, *_ = _flash_inputs(cuda, 128, 128, 64,
                                           torch.float32, fresh=True)
    offs = torch.tensor([0, 0], dtype=torch.int32, device="cuda")
    kw = dict(scale=64 ** -0.5, causal=True)
    before = kern.launches
    got = fbk.flash_block_update(q, k, v, m, l, acc, offs, **kw)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    want = fbk.reference_impl(q, k, v, m, l, acc, offs, **kw)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-3, atol=1e-3)
    blob = fresh._file(key)
    data = blob.read_bytes()
    blob.write_bytes(data[:len(data) // 2])
    build.set_build_dir(tmp_path / "again")
    assert fresh.load(key) is None and fresh.evicted_corrupt == 1
    fresh.compile_and_store(key, [ccm.kernel_library(kern)],
                            program="prefill")
    assert fresh.stores == 1 and fresh.load(key) is not None
    # one byte of the library flipped in a blob of the right size: the
    # good library in the build directory is left as it was, and on an
    # empty directory nothing is placed, so the miss runs nvcc
    good = tmp_path / "again" / kern.library_path().name
    good_bytes = good.read_bytes()
    data = blob.read_bytes()
    at = len(data) - len(good_bytes) // 2
    flipped = data[:at] + bytes([data[at] ^ 0xFF]) + data[at + 1:]
    blob.write_bytes(flipped)
    assert fresh.load(key) is None and fresh.evicted_corrupt == 2
    assert good.read_bytes() == good_bytes
    blob.write_bytes(flipped)
    build.set_build_dir(tmp_path / "empty")
    assert fresh.load(key) is None and fresh.evicted_corrupt == 3
    assert not kern.library_path().exists()
    compiled = fresh.compile_s
    fresh.compile_and_store(key, [ccm.kernel_library(kern)],
                            program="prefill")
    assert fresh.compile_s > compiled and kern.library_path().exists()
