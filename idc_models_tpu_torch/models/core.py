"""Layer library: the counterparts of ``idc_models_tpu/models/core.py``.

Every layer is an ``nn.Module`` whose parameters keep the JAX package's
names and shapes, so a state-dict key is the JAX tree path with "/"
spelled "." (``backbone.block_1_depthwise.kernel``) and ``convert.py``
carries weights across without reshaping:

- conv kernels are HWIO ``[kh, kw, in, out]``;
- depthwise kernels are ``[kh, kw, 1, C]``;
- dense kernels are ``[in, out]``;
- batchnorm has parameters ``scale``/``bias`` and buffers ``mean``/``var``.

Activations are NHWC at every public function. Convolutions hand cuDNN
an NCHW *view* of the NHWC tensor (``permute``), which is a
``channels_last`` tensor with the same bytes, so no copy is made.

Train/eval is the module's ``training`` flag (``model.train()`` /
``model.eval()``), where the JAX package passes ``train=``. Parameters
are created empty and filled by ``init_params(module, seed)`` from one
explicit ``torch.Generator``, on the CPU, so a seed gives the same
weights on every device. (JAX's random stream cannot be reproduced;
parity tests carry the JAX init over with ``convert.py``.)
"""

from __future__ import annotations

import math
from collections.abc import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from idc_models_tpu_torch import collectives
from idc_models_tpu_torch.ops import fused_conv
from idc_models_tpu_torch.ops.fused_conv import same_pads

# ---------------------------------------------------------------------------
# initializers (Keras-default parity)
# ---------------------------------------------------------------------------


def glorot_uniform_(t: torch.Tensor, fan_in: int, fan_out: int,
                    generator: torch.Generator) -> None:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        # drawn where the generator lies, then copied: a seed gives the
        # same weights on whatever device the module already is
        t.copy_(torch.empty(t.shape, dtype=t.dtype,
                            device=generator.device).uniform_(
                                -limit, limit, generator=generator))


def init_params(module: nn.Module, seed: int) -> nn.Module:
    """Fill every layer's parameters and state, in registration order,
    from one CPU generator seeded with `seed`. Returns `module`."""
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(g)
    return module


def _conv_padding(h: int, w: int, kh: int, kw: int, sh: int, sw: int,
                  padding) -> tuple[tuple[int, int], tuple[int, int]]:
    """((top, bottom), (left, right)) for "SAME" (TF-SAME, asymmetric),
    "VALID", or explicit ((lo_h, hi_h), (lo_w, hi_w)) pairs."""
    if padding == "SAME":
        _, _, ph, pw = same_pads(h, w, kh, kw, sh, sw)
        return ph, pw
    if padding == "VALID":
        return (0, 0), (0, 0)
    (pt, pb), (pl, pr) = padding
    return (pt, pb), (pl, pr)


def _nhwc_conv(x, k_oihw, stride, pads, groups=1):
    """Convolve an NHWC tensor through cuDNN/oneDNN on its NCHW
    (channels_last) view. Symmetric padding goes to the conv itself;
    asymmetric TF-SAME padding (stride 2 at an even size pads (0, 1),
    which ``padding=`` cannot express) is an explicit ``F.pad``."""
    (pt, pb), (pl, pr) = pads
    if pt == pb and pl == pr:
        conv_pad = (pt, pl)
    else:
        x = F.pad(x, (0, 0, pl, pr, pt, pb))
        conv_pad = (0, 0)
    y = F.conv2d(x.permute(0, 3, 1, 2), k_oihw, None, stride, conv_pad,
                 1, groups)
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


class Dense(nn.Module):
    """``y = x @ kernel + bias``; kernel [in, out]."""

    def __init__(self, features_in: int, features_out: int, *,
                 use_bias: bool = True, name: str = "dense"):
        super().__init__()
        self.name = name
        self.kernel = nn.Parameter(torch.empty(features_in, features_out))
        self.bias = (nn.Parameter(torch.zeros(features_out)) if use_bias
                     else None)

    def reset_parameters(self, g: torch.Generator) -> None:
        glorot_uniform_(self.kernel, *self.kernel.shape, g)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        return dense(x, self.kernel, self.bias)


def dense(x, kernel, bias=None):
    """`Dense`'s arithmetic on given weights. JAX's type promotion: a
    bf16 input meeting the f32 kernel computes in f32, as
    ``x @ kernel`` does there."""
    dt = torch.promote_types(x.dtype, kernel.dtype)
    y = x.to(dt) @ kernel.to(dt)
    return y + bias if bias is not None else y


class Conv2d(nn.Module):
    """2-D convolution on NHWC with an HWIO kernel. `padding` is
    "SAME" (TF-SAME), "VALID", or explicit ((lo_h, hi_h), (lo_w, hi_w))."""

    def __init__(self, features_in: int, features_out: int,
                 kernel_size: int | tuple = 3, *, stride: int | tuple = 1,
                 padding: str | tuple = "SAME", use_bias: bool = True,
                 name: str = "conv"):
        super().__init__()
        kh, kw = ((kernel_size, kernel_size) if isinstance(kernel_size, int)
                  else kernel_size)
        self.name = name
        self.stride = (stride, stride) if isinstance(stride, int) else stride
        self.padding = padding
        self.kernel = nn.Parameter(
            torch.empty(kh, kw, features_in, features_out))
        self.bias = (nn.Parameter(torch.zeros(features_out)) if use_bias
                     else None)

    def reset_parameters(self, g: torch.Generator) -> None:
        kh, kw, cin, cout = self.kernel.shape
        glorot_uniform_(self.kernel, kh * kw * cin, kh * kw * cout, g)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        kh, kw = self.kernel.shape[:2]
        pads = _conv_padding(x.shape[1], x.shape[2], kh, kw, *self.stride,
                             self.padding)
        k = self.kernel.to(x.dtype).permute(3, 2, 0, 1)   # HWIO -> OIHW
        y = _nhwc_conv(x, k, self.stride, pads)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


DEPTHWISE_IMPLS = ("grouped", "taps", "fused")


class DepthwiseConv2d(nn.Module):
    """Depthwise conv (MobileNetV2 building block), kernel [kh, kw, 1, C].

    `impl` picks the lowering, same math either way:

    - "grouped": ``F.conv2d(groups=C)`` -- cuDNN's depthwise path;
    - "taps": explicit kh*kw shifted multiply-accumulates;
    - "fused": the hand-written CUDA kernel (ops/fused_conv.py) with an
      identity affine (its plain version on a CPU tensor). Its point is
      the cross-layer fusion models/mobilenet.py drives through it.
    """

    def __init__(self, features: int, kernel_size: int | tuple = 3, *,
                 stride: int | tuple = 1, padding: str = "SAME",
                 use_bias: bool = False, impl: str = "grouped",
                 name: str = "dwconv"):
        super().__init__()
        if impl not in DEPTHWISE_IMPLS:
            raise ValueError(f"impl must be grouped|taps|fused, got {impl!r}")
        if impl in ("taps", "fused") and padding != "SAME":
            raise ValueError(f"impl={impl!r} implements SAME padding only")
        kh, kw = ((kernel_size, kernel_size) if isinstance(kernel_size, int)
                  else kernel_size)
        self.name = name
        self.impl = impl
        self.features = features
        self.stride = (stride, stride) if isinstance(stride, int) else stride
        self.padding = padding
        self.kernel = nn.Parameter(torch.empty(kh, kw, 1, features))
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)

    def reset_parameters(self, g: torch.Generator) -> None:
        kh, kw = self.kernel.shape[:2]
        glorot_uniform_(self.kernel, kh * kw, kh * kw, g)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        w = self.kernel.to(x.dtype)
        kh, kw = w.shape[:2]
        if self.impl == "fused":
            ones = torch.ones(self.features, device=x.device)
            add = (self.bias.float() if self.bias is not None
                   else torch.zeros(self.features, device=x.device))
            return fused_conv.fused_depthwise_affine(
                x, w, ones, add, stride=self.stride,
                clamp6=False)
        if self.impl == "taps":
            sh, sw = self.stride
            h_out, w_out, (pt, pb), (pl, pr) = same_pads(
                x.shape[1], x.shape[2], kh, kw, sh, sw)
            xp = F.pad(x, (0, 0, pl, pr, pt, pb))
            y = None
            for i in range(kh):
                for j in range(kw):
                    xs = xp[:, i:i + (h_out - 1) * sh + 1:sh,
                            j:j + (w_out - 1) * sw + 1:sw, :]
                    t = xs * w[i, j, 0]
                    y = t if y is None else y + t
        else:
            pads = _conv_padding(x.shape[1], x.shape[2], kh, kw,
                                 *self.stride, self.padding)
            y = _nhwc_conv(x, w.permute(3, 2, 0, 1), self.stride, pads,
                           groups=self.features)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class _MeanSquare(torch.autograd.Function):
    """``mean(x^2)`` over `axes`, the one-pass second moment, whose
    backward takes x back as ``centered + mean`` and so saves no alias of
    x. A packed DenseNet block (models/densenet.py) feeds its BNs slices
    of a buffer that later layers write into; ``x.square()`` would save
    the slice, and the write would fail the backward's version check.
    The forward is the same arithmetic as ``x.square().mean(axes)``."""

    @staticmethod
    def forward(ctx, x, centered, mean, axes):
        ctx.save_for_backward(centered, mean)
        return x.square().mean(axes)

    @staticmethod
    def backward(ctx, grad):
        centered, mean = ctx.saved_tensors
        n = centered.numel() // mean.numel()
        return (grad * (2.0 / n)) * (centered + mean), None, None, None


class BatchNorm(nn.Module):
    """Keras BatchNormalization, which ``nn.BatchNorm2d`` is not:

    - the batch variance is biased, ``E[x^2] - E[x]^2``;
    - `momentum` weighs the OLD statistic (Keras: 0.99; MobileNetV2 0.999);
    - eps defaults to 1e-3;
    - ``frozen=True`` (Keras ``trainable=False``) always runs in
      inference mode with the moving statistics and never updates them,
      whatever the train flag.

    In train mode the moving statistics are updated in place (the JAX
    layer returns them as new state).

    ``group`` (set by `sync_batch_norm`) is the data-parallel group: train
    mode then takes the moments of the global batch, as GSPMD does in the
    JAX package -- the raw f32 moments (mean and mean square) averaged
    over the group before ``var = second - mean**2``, never the ranks'
    variances, and the same moving statistics on every rank."""

    def __init__(self, features: int, *, momentum: float = 0.99,
                 eps: float = 1e-3, frozen: bool = False, name: str = "bn"):
        super().__init__()
        self.name = name
        self.momentum = momentum
        self.eps = eps
        self.frozen = frozen
        self.group = None
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def reset_parameters(self, g: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x):
        xf = x.float()
        if self.training and not self.frozen:
            axes = tuple(range(x.dim() - 1))
            mean = xf.mean(axes)
            second = _MeanSquare.apply(xf, xf - mean, mean, axes)
            if self.group is not None:
                mean, second = collectives.mean_moments((mean, second),
                                                        self.group)
            var = second - mean ** 2
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + self.eps) * self.scale
        return ((xf - mean) * inv + self.bias).to(x.dtype)


def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def gelu(x):
    """GELU in the tanh approximation, ``jax.nn.gelu``'s default (torch's
    default is the exact erf form)."""
    return F.gelu(x, approximate="tanh")


def layer_norm(x, scale, bias, eps: float = 1e-6):
    """LayerNorm over the trailing axis with f32 statistics and the
    biased variance, cast back to x's dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


class LayerNorm(nn.Module):
    """Keras LayerNormalization over the trailing feature axis: params
    `scale` (ones) and `bias` (zeros), eps 1e-6."""

    def __init__(self, features: int, *, eps: float = 1e-6,
                 name: str = "ln"):
        super().__init__()
        self.name = name
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, g: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        return layer_norm(x, self.scale, self.bias, self.eps)


class ReLU(nn.Module):
    """A named ReLU layer, for `Sequential`."""

    def __init__(self, name: str = "relu"):
        super().__init__()
        self.name = name

    def forward(self, x):
        return torch.relu(x)


class MaxPool(nn.Module):
    """window x window max pooling on NHWC, ``lax.reduce_window(x, -inf,
    max, ...)``: padding ("VALID", TF-"SAME" or explicit ((lo_h, hi_h),
    (lo_w, hi_w)) pairs) holds -inf, so it never wins; "VALID" drops the
    ragged edge. `stride` defaults to `window`."""

    def __init__(self, window: int = 2, stride: int | None = None, *,
                 padding: str | tuple = "VALID", name: str = "maxpool"):
        super().__init__()
        self.name = name
        self.window = window
        self.stride = window if stride is None else stride
        self.padding = padding

    def forward(self, x):
        k, s = self.window, self.stride
        (pt, pb), (pl, pr) = _conv_padding(x.shape[1], x.shape[2], k, k, s,
                                           s, self.padding)
        if pt or pb or pl or pr:
            x = F.pad(x, (0, 0, pl, pr, pt, pb), value=-math.inf)
        y = F.max_pool2d(x.permute(0, 3, 1, 2), k, s)
        return y.permute(0, 2, 3, 1)


class AvgPool(nn.Module):
    """window x window average pooling on NHWC, as the JAX package's
    ``avg_pool``: "VALID" divides each window's sum by window^2, "SAME"
    by the count of real (unpadded) elements in it (Keras
    AveragePooling2D). The window sum may add in another order than
    ``lax.reduce_window``'s."""

    def __init__(self, window: int = 2, stride: int | None = None, *,
                 padding: str = "VALID", name: str = "avgpool"):
        super().__init__()
        self.name = name
        self.window = window
        self.stride = window if stride is None else stride
        self.padding = padding

    def forward(self, x):
        k, s = self.window, self.stride
        (pt, pb), (pl, pr) = _conv_padding(x.shape[1], x.shape[2], k, k, s,
                                           s, self.padding)
        xc = F.pad(x, (0, 0, pl, pr, pt, pb)).permute(0, 3, 1, 2)
        total = F.avg_pool2d(xc, k, s, divisor_override=1)
        if self.padding == "VALID":
            y = total / (k * k)
        else:
            ones = F.pad(torch.ones_like(x[:1, :, :, :1]),
                         (0, 0, pl, pr, pt, pb)).permute(0, 3, 1, 2)
            y = total / F.avg_pool2d(ones, k, s, divisor_override=1)
        return y.permute(0, 2, 3, 1)


class Flatten(nn.Module):
    """[N, ...] -> [N, -1] in the NHWC order, so the rows of a following
    dense kernel keep the JAX package's order."""

    def __init__(self, name: str = "flatten"):
        super().__init__()
        self.name = name

    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class Dropout(nn.Module):
    """Inverted dropout: in train mode keep each activation with
    probability 1 - rate and scale it by 1 / keep, else zero it.

    The mask is drawn from ``self.generator``, an explicit
    ``torch.Generator`` on the activations' device set by
    `use_generator`; train mode without one raises, as the JAX layer
    raises without an rng. (JAX's random stream cannot be reproduced:
    parity checks run in eval mode or without dropout.)"""

    def __init__(self, rate: float, name: str = "dropout"):
        super().__init__()
        if not 0.0 <= rate < 1.0:
            raise ValueError(
                f"dropout rate must be in [0, 1), got {rate} -- negative "
                f"rates silently rescale activations and rate >= 1 zeroes "
                f"the branch entirely")
        self.name = name
        self.rate = rate
        self.generator: torch.Generator | None = None
        # {dim: (this rank's block, blocks)} where x is a block of the
        # global activation (`shard_dropout`)
        self.blocks: dict[int, tuple[int, int]] = {}

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        if self.generator is None:
            raise ValueError(f"dropout({self.name}) needs a generator in "
                             f"train mode (core.use_generator)")
        keep = 1.0 - self.rate
        shape = list(x.shape)
        for dim, (_, parts) in self.blocks.items():
            shape[dim] *= parts
        mask = torch.rand(shape, generator=self.generator,
                          device=x.device) < keep
        for dim, (index, parts) in self.blocks.items():
            mask = mask.narrow(dim, index * x.shape[dim], x.shape[dim])
        return torch.where(mask, x / keep, torch.zeros_like(x))


def use_generator(module: nn.Module,
                  generator: torch.Generator | None) -> nn.Module:
    """Point every `Dropout` of `module` at `generator`. Returns
    `module`."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator
    return module


def shard_dropout(module: nn.Module,
                  blocks: dict[int, tuple[int, int]]) -> nn.Module:
    """Make every `Dropout` of `module` draw the mask of the global
    activation and keep this rank's block: `blocks` maps a dim of the
    activation to (this rank's block, blocks along it). Every rank draws
    from a generator seeded alike, so n ranks apply the masks one rank
    would (the JAX package draws one mask for the global batch). Dims
    set before and not named here keep their blocks. Returns
    `module`."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.blocks.update(blocks)
            m.blocks = {d: b for d, b in m.blocks.items() if b[1] > 1}
    return module


def sync_batch_norm(module: nn.Module, group) -> nn.Module:
    """Point every `BatchNorm` of `module` at the data-parallel `group`
    (None: this rank's batch alone). Returns `module`."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.group = group
    return module


# ---------------------------------------------------------------------------
# composition
# ---------------------------------------------------------------------------


class _LayerView:
    """``run.params[name]`` / ``run.state[name]``: one layer's parameters
    or buffers as a dict, read when a unit asks."""

    def __init__(self, layers: nn.Module, kind: str):
        self._layers, self._kind = layers, kind

    def __getitem__(self, name: str) -> dict[str, torch.Tensor]:
        layer = self._layers.get_submodule(name)
        return dict(getattr(layer, f"named_{self._kind}")(recurse=False))


class _Run:
    """The `run(layer_name, h)` handle a unit threads its activation
    through, with `run.params`, `run.state` and `run.train` views so a
    unit may lower a chain that spans layers (mobilenet's fused
    depthwise+BN+relu6). `run.entry` is True while the first unit of a
    forward runs: its input is the caller's tensor, which a unit must
    not write into (densenet's packed layers write into the buffer the
    unit before them returned)."""

    def __init__(self, layers: nn.Module):
        self._layers = layers
        self.params = _LayerView(layers, "parameters")
        self.state = _LayerView(layers, "buffers")
        self.train = layers.training
        self.entry = True

    def __call__(self, name: str, h):
        return self._layers.get_submodule(name)(h)


class UnitBackbone(nn.Module):
    """A backbone composed of topology *units* over a FLAT namespace of
    Keras-named layers (the counterpart of ``core.unit_backbone``).

    `units` is a list of (layer_names, unit_fn) where
    ``unit_fn(run, h) -> h`` applies the unit's layers through
    ``run(layer_name, h)``. A unit must be a pure function of its input
    (residual adds and dense concats live inside one unit), so every
    unit edge is a valid frozen-prefix cache point. A unit that lowers
    across layer boundaries must be value-equivalent to the per-layer
    composition, and may bypass `run` only for layers whose state it
    provably leaves unchanged (frozen/eval BN).

    With `layer_index` (Keras index per layer name), ``splitter(
    fine_tune_at)`` cuts at the first unit that holds a layer with index
    >= fine_tune_at and returns (prefix, suffix) sections that share this
    backbone's layers, so their parameters are this backbone's own."""

    def __init__(self, units: Sequence[tuple[list[str], Callable]],
                 layers: dict[str, nn.Module], name: str,
                 layer_index: dict[str, int] | None = None):
        super().__init__()
        self.name = name
        self._units = list(units)
        self._layer_index = layer_index
        for n, m in layers.items():
            self.add_module(n, m)

    @property
    def layer_names(self) -> tuple[str, ...]:
        return tuple(n for ns, _ in self._units for n in ns)

    def forward(self, x):
        run = _Run(self)
        for _, unit_fn in self._units:
            x = unit_fn(run, x)
            run.entry = False
        return x

    def section(self, lo: int, hi: int, name: str) -> "UnitBackbone":
        """Units [lo, hi) as a backbone of their own, over the same
        layer modules."""
        units = self._units[lo:hi]
        layers = {n: self.get_submodule(n) for ns, _ in units for n in ns}
        sec = UnitBackbone(units, layers, name)
        sec.training = self.training
        return sec

    def splitter(self, fine_tune_at: int):
        """(prefix, suffix) at the first unit holding a live layer (Keras
        index >= fine_tune_at); the prefix takes every unit when none is
        live. None when the first unit is live: nothing frozen to cache."""
        if self._layer_index is None:
            raise ValueError(f"{self.name} has no Keras layer index to "
                             f"split at")
        k = next((i for i, (names, _) in enumerate(self._units)
                  if any(self._layer_index[n] >= fine_tune_at
                         for n in names)), len(self._units))
        if k == 0:
            return None
        return (self.section(0, k, f"{self.name}[:{k}]"),
                self.section(k, len(self._units),
                             f"{self.name}[{k}:]"))


class Sequential(nn.Module):
    """Layers applied in order (the counterpart of ``core.sequential``).

    Each layer is registered under a unique key derived from its name as
    the JAX package derives it (a repeated ``relu`` becomes ``relu_0``,
    then ``relu_1``), so parameter names are the JAX tree paths
    (``fc1.kernel``). ``layer_names`` is the key order, the model's layer
    order that the secure `percent` selection ranks by. `keys` gives the
    keys instead (`subsequence` keeps a parent's)."""

    def __init__(self, layers: Sequence[nn.Module],
                 name: str = "sequential", *,
                 keys: Sequence[str] | None = None):
        super().__init__()
        self.name = name
        if keys is None:
            keys = []
            for m in layers:
                key, i = m.name, 0
                while key in keys:
                    key = f"{m.name}_{i}"
                    i += 1
                keys.append(key)
        for key, m in zip(keys, layers, strict=True):
            self.add_module(key, m)
        self.layer_names = tuple(keys)

    def forward(self, x):
        for key in self.layer_names:
            x = getattr(self, key)(x)
        return x


def subsequence(seq: Sequential, keys_subset: Sequence[str],
                name: str | None = None) -> Sequential:
    """A Sequential over a contiguous in-order run of `seq`'s layers (an
    empty run is the identity), KEEPING the parent's keys and sharing its
    layer modules, so its parameters are the parent's own. Any other
    subset would compute a different function than the parent."""
    parent_keys = list(seq.layer_names)
    if not parent_keys:
        raise ValueError(f"{seq.name} has no layers to slice")
    keys = list(keys_subset)
    if keys:
        if keys[0] not in parent_keys:
            raise KeyError(f"{seq.name} has no layer {keys[0]!r}")
        start = parent_keys.index(keys[0])
        if parent_keys[start:start + len(keys)] != keys:
            raise ValueError(
                f"keys_subset must be a contiguous in-order run of "
                f"{seq.name}'s layers; got {keys}")
    default = (f"{seq.name}[{keys[0]}:{keys[-1]}]" if keys
               else f"{seq.name}[empty]")
    sub = Sequential([seq.get_submodule(k) for k in keys], name or default,
                     keys=keys)
    sub.training = seq.training
    return sub


def split_sequential(seq: Sequential, at_key: str
                     ) -> tuple[Sequential, Sequential]:
    """(prefix, suffix) of `seq` at `at_key` (the suffix starts with it);
    ``suffix(prefix(x)) == seq(x)``, on the parent's parameters."""
    keys = list(seq.layer_names)
    if at_key not in keys:
        raise KeyError(f"{seq.name} has no layer {at_key!r}; have {keys}")
    i = keys.index(at_key)
    return (subsequence(seq, keys[:i], name=f"{seq.name}[:{at_key}]"),
            subsequence(seq, keys[i:], name=f"{seq.name}[{at_key}:]"))


class Classifier(nn.Module):
    """Backbone + GlobalAveragePooling + Dense head, the model shape every
    reference workload shares. Parameters: ``backbone.*`` and ``head.*``.
    `head` shares another classifier's head (the feature cache's suffix
    model trains the full model's own)."""

    def __init__(self, backbone: nn.Module, feature_dim: int,
                 num_outputs: int, name: str | None = None, *,
                 head: Dense | None = None):
        super().__init__()
        self.name = name or f"{backbone.name}_classifier"
        self.backbone = backbone
        self.head = head or Dense(feature_dim, num_outputs, name="head")

    @property
    def layer_names(self) -> tuple[str, ...]:
        """The backbone's layer order as dotted paths, then the head, so
        ordered-tensor consumers (the secure `percent` selection) see the
        Keras get_weights() enumeration."""
        bb = getattr(self.backbone, "layer_names", ())
        names = tuple(f"backbone.{n}" for n in bb) if bb else ("backbone",)
        return names + ("head",)

    def forward(self, x):
        h = self.backbone(x)
        return self.head(h.mean(dim=(1, 2)))   # GlobalAveragePooling2D


# ---------------------------------------------------------------------------
# trainability masks
# ---------------------------------------------------------------------------


def trainability_mask(module: nn.Module,
                      predicate: Callable[[tuple[str, ...]], bool]
                      ) -> dict[str, bool]:
    """{parameter name: trainable}. `predicate` receives the path as a
    tuple of keys, e.g. ("backbone", "Conv1", "kernel"), as in the JAX
    package. Feed the result to ``train.state.rmsprop``."""
    return {n: bool(predicate(tuple(n.split("."))))
            for n, _ in module.named_parameters()}


def count_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def head_only_mask(module: nn.Module) -> dict[str, bool]:
    """Phase-1 transfer-learning mask: only the "head" subtree trains."""
    return trainability_mask(module, lambda p: p[0] == "head")


def keras_fine_tune_mask(module: nn.Module, index_map: dict[str, int],
                         fine_tune_at: int) -> dict[str, bool]:
    """Phase-2 mask: head + backbone layers whose Keras layer index is
    >= fine_tune_at (Keras ``layers[:fine_tune_at].trainable = False``)."""

    def pred(path):
        if path[0] == "head":
            return True
        return index_map.get(path[1], -1) >= fine_tune_at

    return trainability_mask(module, pred)
