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

from idc_models_tpu_torch.federated.fedavg import ServerState
from idc_models_tpu_torch.models import core, mobilenet, small_cnn
from idc_models_tpu_torch.ops import fused_conv as fc
from idc_models_tpu_torch.ops import secure_masking_kernel as smk
from idc_models_tpu_torch.secure.fedavg import make_secure_fedavg_round
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
    dt = getattr(torch, dtype)
    tol = F32_TOL if dt == torch.float32 else BF16_TOL
    for call in mobilenet.fused_call_shapes(2, 50):
        x, w, mul, add = _inputs(cuda, 2, call["h_in"], call["c"], dt)
        before = fc.KERNEL.launches
        got = fc.fused_depthwise_affine(x, w, mul, add,
                                        stride=call["stride"])
        torch.cuda.synchronize()
        assert fc.KERNEL.launches == before + 1
        assert got.dtype == dt and got.is_cuda
        want = fc.reference_impl(x, w, mul, add, stride=call["stride"])
        torch.testing.assert_close(got.float(), want.float(), **tol)


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
    x, w, mul, add = _inputs(cuda, 1, 5, 8)
    with pytest.raises(ValueError, match="contiguous"):
        fc.fused_depthwise_affine(x.transpose(1, 2), w, mul, add)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fc.fused_depthwise_affine(x.half(), w, mul, add)
    with pytest.raises(ValueError, match="CUDA device"):
        fc.fused_depthwise_affine(x, w.cpu(), mul, add)


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
