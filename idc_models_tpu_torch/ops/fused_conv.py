"""Fused depthwise conv + batchnorm + ReLU6: a hand-written CUDA kernel
(``csrc/fused_depthwise.cu``) and its plain PyTorch version.

The counterpart of ``idc_models_tpu/ops/fused_conv.py``. MobileNetV2's
frozen and eval depthwise chains (depthwise conv -> inference-mode BN ->
ReLU6) run as one kernel launch:

    mul = scale * rsqrt(var + eps)
    add = bias - mean * mul
    y   = clamp6(dwconv(x) * mul + add)

``fused_depthwise_bn_relu6`` hands the kernel the four BN tensors and it
folds them itself, in ``fold_bn``'s order of operations;
``fused_depthwise_affine`` hands it a folded (mul, add) pair.

Dispatch is by where the tensor lies. A CPU tensor runs the plain
version (``reference_impl``, ``reference_bn_impl``: the taps formulation
of the JAX package's reference); a CUDA tensor launches the kernel or
raises. There is no fallback from one to the other. Each launch adds one
to ``KERNEL.launches`` and to its path's entry in ``PATH_LAUNCHES``; a
CPU call touches neither.

The kernel has three paths, chosen before the launch by
``depthwise_path`` from shapes, strides and pointers: "3x3" (kh = kw = 3
at stride 1 or 2, 16-byte channel vectors, a sliding register window),
"general" (any kh x kw and stride, 16-byte channel vectors) and "scalar"
(one channel a thread, for channel counts that are not a multiple of the
vector width and for misaligned or channel-strided x). x may have any
strides; y is contiguous. ``depthwise_tiles`` plans each call's tiles.

Gradients: the autograd.Functions' forward is the kernel and their
backward is autograd through the plain version at the saved inputs, as
the JAX package's custom_vjp differentiates its jnp reference; the BN
version differentiates ``fold_bn`` too, so scale, bias, mean and var get
the gradients the JAX package's fold outside its custom_vjp gives them.
The JAX package has no backward kernel for this chain. Without autograd
(no grad mode, or no input that requires grad) the wrappers launch
directly.

Layouts are the JAX package's: x [N, H, W, C], w [kh, kw, 1, C],
per-channel vectors [C]. ``depthwise_call_cost`` /
``depthwise_chain_cost`` are the JAX package's analytic count, kept
verbatim so the two agree.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from idc_models_tpu_torch.ops.build import CudaKernel


def _declare(lib: ctypes.CDLL) -> None:
    lib.fused_depthwise_forward.argtypes = [ctypes.c_void_p] * 9
    lib.fused_depthwise_forward.restype = ctypes.c_int
    lib.fused_depthwise_error_string.argtypes = [ctypes.c_int]
    lib.fused_depthwise_error_string.restype = ctypes.c_char_p


KERNEL = CudaKernel("fused_depthwise.cu", _declare)

PATHS = ("3x3", "general", "scalar")
PATH_LAUNCHES = dict.fromkeys(PATHS, 0)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# the kernel's limits (csrc/fused_depthwise.cu: kMaxThreads, kMaxStrip;
# blockDim.z at most 64)
MAX_THREADS, MAX_STRIP, MAX_ROWS = 128, 8, 64
# The tile plan's choices, tuned on an H100 at the MobileNetV2 shapes
# (PERF.md, section 6): shared memory a block may ask for (above 48 KB the
# launch opts in); the blocks that fill the card (two a streaming
# multiprocessor on its 132); how many tiles a block walks with its
# window double-buffered, at stride 1 only, and only while WALK_BLOCKS
# blocks (eight a multiprocessor) remain.
SMEM_BUDGET = 64 * 1024
FILL_BLOCKS = 2 * 132
MAX_WALK, WALK_BLOCKS = 2, 8 * 132


class _Geometry(ctypes.Structure):
    """The kernel's per-shape arguments (``Geometry`` in the source)."""

    _fields_ = [(f, ctypes.c_int) for f in ("dtype", "path", "bn", "clamp6")]
    _fields_ += [("eps", ctypes.c_float)]
    _fields_ += [(f, ctypes.c_int) for f in (
        "H", "W", "C", "Ho", "Wo", "kh", "kw", "sh", "sw", "pad_top",
        "pad_left")]
    _fields_ += [(f, ctypes.c_longlong) for f in ("xs_n", "xs_h", "xs_w",
                                                  "xs_c")]
    _fields_ += [(f, ctypes.c_int) for f in (
        "rows", "cols", "strip", "cvec", "row_tiles", "col_tiles", "slabs",
        "walk")]
    _fields_ += [("n", ctypes.c_longlong)]


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


def reference_bn_impl(x, w, scale, bias, mean, var, *, eps, stride=1):
    """The plain version of the batchnorm chain: ``fold_bn`` then
    ``reference_impl`` with the clamp."""
    mul, add = fold_bn(scale, bias, mean, var, eps)
    return reference_impl(x, w, mul, add, stride=stride, clamp6=True)


# ---------------------------------------------------------------------------
# the kernel's path and tile plan, decided in Python before the launch
# ---------------------------------------------------------------------------


def depthwise_path(c: int, kh: int, kw: int, sh: int, sw: int,
                   itemsize: int, *, vector_ok: bool) -> str:
    """Which instantiation of the kernel takes a call. `vector_ok` says
    whether x's pointer and strides and w's pointer allow 16-byte
    channel vectors (see ``vector_ok``); the vector paths also need C to
    be a multiple of the vector width (4 f32, 8 bf16)."""
    if not vector_ok or c % (16 // itemsize):
        return "scalar"
    if kh == kw == 3 and sh == sw and sh in (1, 2):
        return "3x3"
    return "general"


def vector_ok(x: torch.Tensor, w: torch.Tensor) -> bool:
    """x's channels are contiguous, every stride that is walked is a
    multiple of the vector width, and x and w start on 16 bytes."""
    return (not (x.data_ptr() | w.data_ptr()) % 16
            and _strides_ok(x.shape, x.stride(), x.element_size()))


def _strides_ok(shape, strides, itemsize) -> bool:
    width = 16 // itemsize
    return strides[3] == 1 and all(
        s % width == 0 for d, s in zip(shape[:3], strides[:3]) if d > 1)


class Tiles(NamedTuple):
    """One call's tile plan: a block owns `rows` x `cols` outputs of one
    image and `cvec` channel vectors of `width` channels; a thread owns
    one vector and a strip of `strip` outputs along one output row."""

    rows: int
    cols: int
    strip: int
    cvec: int
    width: int
    row_tiles: int
    col_tiles: int
    slabs: int
    walk: int        # tiles a block walks (two window buffers if > 1)
    rows_in: int     # the window a block stages, halo included
    cols_in: int
    smem: int        # bytes of shared memory a block asks for
    threads: tuple   # blockDim: (cvec, strips, rows)
    blocks: int      # gridDim: ceil(tiles / walk) x slabs


def _divisors(m: int) -> list[int]:
    return [d for d in range(1, m + 1) if m % d == 0]


@functools.lru_cache(maxsize=None)
def depthwise_tiles(n: int, h: int, w: int, c: int, kh: int, kw: int,
                    sh: int, sw: int, itemsize: int,
                    path: str = "3x3") -> Tiles:
    """The tile plan of one call, a pure function of its shape.

    A tile is `rows` x `cols` outputs of one image; there are
    n x row_tiles x col_tiles of them for each of `slabs` channel slabs.
    At stride 1 a block walks `walk` consecutive tiles of one slab, as
    long as WALK_BLOCKS blocks remain, with two window buffers when it
    walks more than one. (On the H100 a walk made stride-2 calls slower,
    and batch-32 calls need every block they have.)

    Among the plans that fit (at most MAX_THREADS threads and
    SMEM_BUDGET bytes of shared memory a block), it prefers, in order:
    enough blocks to fill the card (FILL_BLOCKS); 128 contiguous bytes of
    a pixel's slab, so each staged pixel is a whole 128-byte line; the
    least window staged per output (the halo's share); a slab of whole
    groups of 8 vectors (conflict-free 16-byte shared loads); more
    threads."""
    ho, wo, _, _ = same_pads(h, w, kh, kw, sh, sw)
    width = 1 if path == "scalar" else 16 // itemsize
    vectors = c // width
    best = None

    def strips(cols):                # (count, outputs each), even lengths
        strip = -(-cols // -(-cols // MAX_STRIP))
        return -(-cols // strip), strip

    for cvec in _divisors(vectors):
        px = cvec * width * itemsize          # a pixel's slab, bytes
        w_bytes = 0 if path == "3x3" else kh * kw * cvec * width * 4

        def smem(rows, cols, buffers=1, px=px, w_bytes=w_bytes):
            win = ((rows - 1) * sh + kh) * ((cols - 1) * sw + kw) * px
            return buffers * (-(-win // 16) * 16) + w_bytes

        col_tiles, cols = 1, wo
        while cols > 1 and (smem(1, cols) > SMEM_BUDGET
                            or cvec * strips(cols)[0] > MAX_THREADS):
            col_tiles += 1
            cols = -(-wo // col_tiles)
        col_tiles = -(-wo // cols)
        ns, strip = strips(cols)
        if smem(1, cols) > SMEM_BUDGET or cvec * ns > MAX_THREADS:
            continue
        for rows in range(1, min(ho, MAX_ROWS) + 1):
            threads = cvec * ns * rows
            if threads > MAX_THREADS or smem(rows, cols) > SMEM_BUDGET:
                break
            row_tiles = -(-ho // rows)
            if -(-ho // row_tiles) != rows:
                continue            # a shorter tile covers as many rows
            tiles = n * row_tiles * col_tiles
            slabs = vectors // cvec
            walk = (max(1, min(MAX_WALK, tiles * slabs // WALK_BLOCKS))
                    if sh == 1 else 1)
            buffers = 1 if path == "scalar" or walk == 1 else 2
            if smem(rows, cols, buffers) > SMEM_BUDGET:
                walk, buffers = 1, 1
            blocks = -(-tiles // walk) * slabs
            rows_in, cols_in = (rows - 1) * sh + kh, (cols - 1) * sw + kw
            halo = rows_in * cols_in / (rows * sh * cols * sw)
            key = (min(blocks, FILL_BLOCKS), min(px, 128),
                   -round(halo, 1), cvec % 8 == 0, threads)
            if best is None or key > best[0]:
                best = (key, Tiles(rows, cols, strip, cvec, width, row_tiles,
                                   col_tiles, slabs, walk, rows_in, cols_in,
                                   smem(rows, cols, buffers),
                                   (cvec, ns, rows), blocks))
    if best is None:
        raise ValueError(f"no tile of a {kh}x{kw} depthwise call on "
                         f"[{n}, {h}, {w}, {c}] fits {SMEM_BUDGET} bytes of "
                         f"shared memory")
    return best[1]


@functools.lru_cache(maxsize=4096)
def _plan(shape, strides, dtype, kh, kw, stride, clamp6, bn, eps, aligned):
    """The path, the kernel's Geometry and y's shape for one call shape;
    `aligned`: x and w start on 16 bytes."""
    n, h, wd, c = shape
    sh, sw = stride
    itemsize = 4 if dtype == torch.float32 else 2
    path = depthwise_path(c, kh, kw, sh, sw, itemsize, vector_ok=(
        aligned and _strides_ok(shape, strides, itemsize)))
    h_out, w_out, (pt, _), (pl, _) = same_pads(h, wd, kh, kw, sh, sw)
    t = depthwise_tiles(n, h, wd, c, kh, kw, sh, sw, itemsize, path)
    g = _Geometry(_DTYPE_CODE[dtype], PATHS.index(path), int(bn),
                  int(clamp6), eps, h, wd, c, h_out, w_out, kh, kw, sh, sw,
                  pt, pl, *strides, t.rows, t.cols, t.strip, t.cvec,
                  t.row_tiles, t.col_tiles, t.slabs, t.walk, n)
    return path, g, (n, h_out, w_out, c)


_NAMES = ("w", "a", "b", "mean", "var")


def _launch(x, w, a, b, stride, clamp6, mean=None, var=None, eps=0.0):
    """Run the kernel on CUDA tensors: (a, b) = (mul, add), or with
    `mean` and `var` given, (scale, bias) of a batchnorm the kernel
    folds. Checks what the kernel takes and raises on anything else; the
    output comes from torch.empty and the launch goes on the current
    stream."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused depthwise kernel takes float32 or bfloat16 "
                        f"x, got {x.dtype}")
    if x.dim() != 4 or w.dim() != 4 or w.shape[2] != 1:
        raise ValueError(f"expected x [N,H,W,C] and w [kh,kw,1,C], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    c = x.shape[3]
    vecs = (a, b) if mean is None else (a, b, mean, var)
    if w.shape[3] != c or any(t.shape != (c,) for t in vecs):
        raise ValueError(f"w {tuple(w.shape)} and the per-channel vectors "
                         f"{[tuple(t.shape) for t in vecs]} must carry "
                         f"C={c} channels")
    # the kernel reads w and the vectors as f32, as the TPU kernel casts
    # them
    params = [t if t.dtype == torch.float32 else t.float()
              for t in (w, *vecs)]
    device = x.get_device()
    if device < 0:
        raise ValueError(f"x must lie on a CUDA device, got {x.device}")
    for name, t in zip(_NAMES, params):
        if t.get_device() != device:
            raise ValueError(f"{name} must lie on x's CUDA device "
                             f"{x.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    path, g, y_shape = _plan(
        x.shape, x.stride(), x.dtype, w.shape[0], w.shape[1], stride,
        clamp6, mean is not None, eps,
        not (x.data_ptr() | params[0].data_ptr()) % 16)
    y = torch.empty(y_shape, dtype=x.dtype, device=x.device)
    if mean is None:
        params += params[1:]          # the kernel reads mean/var only in BN
    lib = KERNEL.lib()
    args = (ctypes.byref(g), x.data_ptr(), *(t.data_ptr() for t in params),
            y.data_ptr())
    if device == torch.cuda.current_device():
        err = lib.fused_depthwise_forward(
            *args, torch._C._cuda_getCurrentRawStream(device))
    else:
        with torch.cuda.device(device):
            err = lib.fused_depthwise_forward(
                *args, torch._C._cuda_getCurrentRawStream(device))
    if err != 0:
        msg = lib.fused_depthwise_error_string(err).decode()
        raise RuntimeError(f"fused depthwise kernel launch failed: {msg}")
    KERNEL.launches += 1
    PATH_LAUNCHES[path] += 1
    return y


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _input_grads(ctx, g, fn):
    """Autograd through `fn` (a plain version) at the saved inputs."""
    saved = ctx.saved_tensors
    needs = ctx.needs_input_grad[:len(saved)]
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(nd)
                  for t, nd in zip(saved, needs)]
        y = fn(*inputs)
        wanted = [t for t, nd in zip(inputs, needs) if nd]
        grads = iter(torch.autograd.grad(y, wanted, g))
    return [next(grads) if nd else None for nd in needs]


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
        grads = _input_grads(ctx, g, lambda *t: reference_impl(
            *t, stride=ctx.stride, clamp6=ctx.clamp6))
        return (*grads, None, None)


class _FusedDepthwiseBN(torch.autograd.Function):
    """The batchnorm chain. Forward: the kernel, which folds the BN
    itself (CUDA), or ``reference_bn_impl`` (CPU). Backward: autograd
    through ``reference_bn_impl`` at the saved inputs."""

    @staticmethod
    def forward(ctx, x, w, scale, bias, mean, var, eps, stride):
        ctx.save_for_backward(x, w, scale, bias, mean, var)
        ctx.eps, ctx.stride = eps, stride
        if x.device.type == "cpu":
            return reference_bn_impl(x, w, scale, bias, mean, var, eps=eps,
                                     stride=stride)
        return _launch(x, w, scale, bias, stride, True, mean, var, eps)

    @staticmethod
    def backward(ctx, g):
        grads = _input_grads(ctx, g, lambda *t: reference_bn_impl(
            *t, eps=ctx.eps, stride=ctx.stride))
        return (*grads, None, None)


def _check_channel_tile(c, channel_tile):
    if channel_tile is not None and c % channel_tile:
        raise ValueError(f"channel_tile {channel_tile} must divide channel "
                         f"count {c}")


def fused_depthwise_affine(x, w, mul, add, *, stride=1, clamp6=True,
                           channel_tile=None):
    """Fused ``clamp6(dwconv(x) * mul + add)`` with TF-SAME padding.

    x: [N, H, W, C]; w: [kh, kw, 1, C]; mul/add: [C] (identity: ones and
    zeros). Differentiable in all four tensors. ``channel_tile`` keeps
    the JAX signature's contract (it must divide C, else ValueError); the
    kernel plans its own channel slabs, so it does not change the
    launch."""
    _check_channel_tile(x.shape[-1], channel_tile)
    stride, clamp6 = _pair(stride), bool(clamp6)
    if _needs_grad(x, w, mul, add):
        return _FusedDepthwise.apply(x, w, mul, add, stride, clamp6)
    if x.device.type == "cpu":
        return reference_impl(x, w, mul, add, stride=stride, clamp6=clamp6)
    return _launch(x, w, mul, add, stride, clamp6)


def fused_depthwise_bn_relu6(x, w, scale, bias, mean, var, *, eps, stride=1,
                             channel_tile=None):
    """The MobileNetV2 chain: depthwise conv -> inference-mode BN ->
    ReLU6 as one kernel launch, which folds the BN itself. Differentiable
    in x, w and all four BN tensors."""
    _check_channel_tile(x.shape[-1], channel_tile)
    stride, eps = _pair(stride), float(eps)
    if _needs_grad(x, w, scale, bias, mean, var):
        return _FusedDepthwiseBN.apply(x, w, scale, bias, mean, var, eps,
                                       stride)
    if x.device.type == "cpu":
        return reference_bn_impl(x, w, scale, bias, mean, var, eps=eps,
                                 stride=stride)
    return _launch(x, w, scale, bias, stride, True, mean, var, eps)


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
