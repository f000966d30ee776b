"""Fused depthwise conv + folded batchnorm + ReLU6: a hand-written CUDA
kernel (``csrc/fused_depthwise.cu``) and its plain PyTorch version.

The counterpart of ``idc_models_tpu/ops/fused_conv.py``. MobileNetV2's
frozen and eval depthwise chains (depthwise conv -> inference-mode BN ->
ReLU6) run as one kernel on the BN folded to one affine pair:

    mul = scale * rsqrt(var + eps)
    add = bias - mean * mul
    y   = clamp6(dwconv(x) * mul + add)

Folding happens outside the kernel and outside its autograd.Function,
in plain tensor code, so the BN parameters get their gradients from
ordinary autograd.

Dispatch is by where the tensor lies. A CPU tensor runs the plain
version, ``reference_impl`` (the taps formulation of the JAX package's
reference); a CUDA tensor launches the kernel or raises. There is no
fallback from one to the other. Each launch adds one to
``KERNEL.launches``; a CPU call never touches it.

Gradients: ``_FusedDepthwise`` is an autograd.Function whose forward is
the kernel and whose backward is autograd through ``reference_impl`` at
the saved inputs, as the JAX package's custom_vjp differentiates its
jnp reference. The JAX package has no backward kernel for this chain.

Layouts are the JAX package's: x [N, H, W, C], w [kh, kw, 1, C],
mul/add [C]. ``depthwise_call_cost`` / ``depthwise_chain_cost`` are the
JAX package's analytic count, kept verbatim so the two agree.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from idc_models_tpu_torch.ops.build import CudaKernel


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.fused_depthwise_forward.argtypes = (
        [ptr] * 5 + [i32, i64] + [i32] * 12 + [ptr])
    lib.fused_depthwise_forward.restype = i32
    lib.fused_depthwise_error_string.argtypes = [i32]
    lib.fused_depthwise_error_string.restype = ctypes.c_char_p


KERNEL = CudaKernel("fused_depthwise.cu", _declare)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def same_pads(h_in: int, w_in: int, kh: int, kw: int, sh: int, sw: int):
    """TF-SAME geometry: (h_out, w_out, (top, bottom), (left, right)).
    The low pad is total // 2 and the high pad the rest, as XLA's
    "SAME" does; for stride 2 at an even size that is (0, 1)."""
    h_out, w_out = -(-h_in // sh), -(-w_in // sw)
    ph = max((h_out - 1) * sh + kh - h_in, 0)
    pw = max((w_out - 1) * sw + kw - w_in, 0)
    return h_out, w_out, (ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2)


def fold_bn(scale, bias, mean, var, eps):
    """Fold inference-mode batchnorm into one (mul, add) affine pair:
    ``bn(y) = (y - mean) * rsqrt(var + eps) * scale + bias = y*mul + add``."""
    mul = scale * torch.rsqrt(var + eps)
    return mul, bias - mean * mul


def reference_impl(x, w, mul, add, *, stride=1, clamp6=True):
    """The plain version: taps depthwise conv (TF-SAME), folded-BN
    affine, optional ReLU6, accumulated in f32 and returned in x's dtype.
    The CPU path, the kernel's parity target on the card, and the
    function the backward differentiates."""
    kh, kw = int(w.shape[0]), int(w.shape[1])
    sh, sw = _pair(stride)
    h_out, w_out, (pt, pb), (pl, pr) = same_pads(x.shape[1], x.shape[2],
                                                 kh, kw, sh, sw)
    xp = F.pad(x, (0, 0, pl, pr, pt, pb))
    wf = w.reshape(kh, kw, -1)
    y = None
    for i in range(kh):
        for j in range(kw):
            xs = xp[:, i:i + (h_out - 1) * sh + 1:sh,
                    j:j + (w_out - 1) * sw + 1:sw, :]
            t = xs.float() * wf[i, j].float()
            y = t if y is None else y + t
    y = y * mul + add
    if clamp6:
        y = torch.clamp(y, 0.0, 6.0)
    return y.to(x.dtype)


def _launch(x, w, mul, add, stride, clamp6):
    """Run the kernel on CUDA tensors. Checks what the kernel takes and
    raises on anything else; the output comes from torch.empty and the
    launch goes on the current stream."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused depthwise kernel takes float32 or bfloat16 "
                        f"x, got {x.dtype}")
    if x.dim() != 4 or w.dim() != 4 or w.shape[2] != 1:
        raise ValueError(f"expected x [N,H,W,C] and w [kh,kw,1,C], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    n, h, wd, c = x.shape
    kh, kw = int(w.shape[0]), int(w.shape[1])
    if w.shape[3] != c or mul.shape != (c,) or add.shape != (c,):
        raise ValueError(f"w {tuple(w.shape)}, mul {tuple(mul.shape)} and "
                         f"add {tuple(add.shape)} must carry C={c} channels")
    # the kernel reads w/mul/add as f32, as the TPU kernel casts them
    w, mul, add = (t.to(torch.float32) for t in (w, mul, add))
    for name, t in (("x", x), ("w", w), ("mul", mul), ("add", add)):
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"{name} must lie on x's CUDA device "
                             f"{x.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (x in NHWC)")
    sh, sw = stride
    h_out, w_out, (pt, _), (pl, _) = same_pads(h, wd, kh, kw, sh, sw)
    y = torch.empty((n, h_out, w_out, c), dtype=x.dtype, device=x.device)
    lib = KERNEL.lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_depthwise_forward(
            x.data_ptr(), w.data_ptr(), mul.data_ptr(), add.data_ptr(),
            y.data_ptr(), _DTYPE_CODE[x.dtype], n, h, wd, c, h_out, w_out,
            kh, kw, sh, sw, pt, pl, int(clamp6), stream)
    if err != 0:
        msg = lib.fused_depthwise_error_string(err).decode()
        raise RuntimeError(f"fused depthwise kernel launch failed: {msg}")
    KERNEL.launches += 1
    return y


class _FusedDepthwise(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU). Backward:
    autograd through ``reference_impl`` at the saved inputs."""

    @staticmethod
    def forward(ctx, x, w, mul, add, stride, clamp6):
        ctx.save_for_backward(x, w, mul, add)
        ctx.stride, ctx.clamp6 = stride, clamp6
        if x.device.type == "cpu":
            return reference_impl(x, w, mul, add, stride=stride,
                                  clamp6=clamp6)
        return _launch(x, w, mul, add, stride, clamp6)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[:4]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(nd)
                      for t, nd in zip(saved, needs)]
            y = reference_impl(*inputs, stride=ctx.stride,
                               clamp6=ctx.clamp6)
            wanted = [t for t, nd in zip(inputs, needs) if nd]
            grads = iter(torch.autograd.grad(y, wanted, g))
        return (*(next(grads) if nd else None for nd in needs), None, None)


def fused_depthwise_affine(x, w, mul, add, *, stride=1, clamp6=True,
                           channel_tile=None):
    """Fused ``clamp6(dwconv(x) * mul + add)`` with TF-SAME padding.

    x: [N, H, W, C]; w: [kh, kw, 1, C]; mul/add: [C] (identity: ones and
    zeros). Differentiable in all four tensors. ``channel_tile`` keeps
    the JAX signature's contract (it must divide C, else ValueError); the
    CUDA kernel needs no channel tiling, so it does not change the
    launch."""
    c = x.shape[-1]
    if channel_tile is not None and c % channel_tile:
        raise ValueError(f"channel_tile {channel_tile} must divide channel "
                         f"count {c}")
    return _FusedDepthwise.apply(x, w, mul, add, _pair(stride), bool(clamp6))


def fused_depthwise_bn_relu6(x, w, scale, bias, mean, var, *, eps, stride=1,
                             channel_tile=None):
    """The MobileNetV2 chain: depthwise conv -> inference-mode BN ->
    ReLU6 as one kernel. Folding happens here, outside the
    autograd.Function, so scale/bias gradients flow through autograd."""
    mul, add = fold_bn(scale, bias, mean, var, eps)
    return fused_depthwise_affine(x, w, mul, add, stride=stride,
                                  clamp6=True, channel_tile=channel_tile)


# ---------------------------------------------------------------------------
# analytic cost, as the JAX package counts it
# ---------------------------------------------------------------------------


def depthwise_call_cost(n, h_in, w_in, c, *, stride=1, kernel_size=3,
                        itemsize=4):
    """Analytic (flops, bytes_accessed) of ONE fused call: kh*kw MACs +
    the affine + the clamp per output element; bytes are the padded
    input (as the TPU kernel reads it) + output + the weight/affine
    operands."""
    k = kernel_size
    sh, sw = _pair(stride)
    h_out, w_out = -(-h_in // sh), -(-w_in // sw)
    out_elems = n * h_out * w_out * c
    flops = float(out_elems * (2 * k * k + 3))
    h_p = (h_out - 1) * sh + k
    w_p = (w_out - 1) * sw + k
    bytes_accessed = float(
        (n * h_p * w_p * c + out_elems) * itemsize
        + (k * k * c + 2 * c) * 4)
    return flops, bytes_accessed


def depthwise_chain_cost(calls, *, itemsize=4):
    """Sum `depthwise_call_cost` over `calls`, an iterable of dicts of its
    keyword arguments (models/mobilenet.py `fused_call_shapes`)."""
    flops = bytes_accessed = 0.0
    for call in calls:
        f, b = depthwise_call_cost(itemsize=itemsize, **call)
        flops += f
        bytes_accessed += b
    return flops, bytes_accessed
