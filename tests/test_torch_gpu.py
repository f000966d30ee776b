"""The port's CUDA kernel on the card, against its plain PyTorch version.

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

from idc_models_tpu_torch.models import core, mobilenet
from idc_models_tpu_torch.ops import fused_conv as fc

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
