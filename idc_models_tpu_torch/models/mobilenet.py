"""MobileNetV2 backbone + transfer-learning head.

The counterpart of ``idc_models_tpu/models/mobilenet.py``: MobileNetV2
(alpha=1.0) without top, GlobalAveragePooling2D, Dense(num_outputs)
logits head, fine_tune_at=100. Stem conv(32, s2) -> 17 inverted-residual
blocks (expansion 6 except the first) -> conv(1280), with
BN(eps=1e-3, momentum=0.999) + ReLU6 throughout and residual adds on
stride-1 same-width blocks. Parameters plus BN statistics of the
backbone: 2,257,984, as Keras include_top=False.

`KERAS_LAYER_INDEX` reproduces Keras' flat layer numbering (ZeroPadding
and Add layers included), so `fine_tune_at` selects the same layers.
"""

from __future__ import annotations

from torch import nn

from idc_models_tpu_torch.models import core
from idc_models_tpu_torch.ops import fused_conv

# (expansion t, out channels c, stride s) per block, keras order
_BLOCKS = (
    [(1, 16, 1)]
    + [(6, 24, 2), (6, 24, 1)]
    + [(6, 32, 2), (6, 32, 1), (6, 32, 1)]
    + [(6, 64, 2), (6, 64, 1), (6, 64, 1), (6, 64, 1)]
    + [(6, 96, 1), (6, 96, 1), (6, 96, 1)]
    + [(6, 160, 2), (6, 160, 1), (6, 160, 1)]
    + [(6, 320, 1)]
)


def _build_index() -> dict[str, int]:
    """Keras MobileNetV2's layer ordering: param groups get the index of
    their conv/BN layer; activations/pads/adds only advance it."""
    i = 0
    idx = {}

    def layer(name=None):
        nonlocal i
        if name is not None:
            idx[name] = i
        i += 1

    layer()                      # InputLayer
    layer("Conv1")
    layer("bn_Conv1")
    layer()                      # Conv1_relu
    layer("expanded_conv_depthwise")
    layer("expanded_conv_depthwise_BN")
    layer()                      # relu
    layer("expanded_conv_project")
    layer("expanded_conv_project_BN")
    c_in = 16
    for b, (t, c, s) in enumerate(_BLOCKS[1:], start=1):
        layer(f"block_{b}_expand")
        layer(f"block_{b}_expand_BN")
        layer()                  # expand_relu
        if s == 2:
            layer()              # ZeroPadding2D
        layer(f"block_{b}_depthwise")
        layer(f"block_{b}_depthwise_BN")
        layer()                  # depthwise_relu
        layer(f"block_{b}_project")
        layer(f"block_{b}_project_BN")
        if s == 1 and c == c_in:
            layer()              # Add
        c_in = c
    layer("Conv_1")
    layer("Conv_1_bn")
    layer()                      # out_relu
    return idx


KERAS_LAYER_INDEX: dict[str, int] = _build_index()

_BN = dict(momentum=0.999, eps=1e-3)

FREEZE_ALL = 10**9  # bn_frozen_below value freezing every BN layer


def _units(in_channels: int, bn_frozen_below: int,
           depthwise_impl: str = "grouped"):
    """The backbone as topology units: unit 0 = stem (Conv1 + block 0),
    units 1..16 = inverted-residual blocks, unit 17 = the Conv_1 top.
    Each unit is (layer_names, fn(run, h) -> h).

    With depthwise_impl="fused" the CUDA kernel runs whole chains only;
    the depthwise layers of the chains it cannot take (unfrozen BN in
    train mode) are cuDNN's grouped conv, whose backward is a library
    kernel. (The JAX package runs its Pallas kernel there too, with an
    identity affine; the values are the same.)"""
    layers: dict[str, nn.Module] = {}
    layer_impl = "grouped" if depthwise_impl == "fused" else depthwise_impl

    def frozen(name):
        return KERAS_LAYER_INDEX[name] < bn_frozen_below

    def reg(m) -> str:
        layers[m.name] = m
        return m.name

    def bn(c, name):
        return core.BatchNorm(c, name=name, frozen=frozen(name), **_BN)

    relu6 = core.relu6

    def dw_chain(run, h, dw_name, bn_name, *, stride):
        """depthwise conv -> BN -> relu6. With depthwise_impl="fused" and
        the BN in inference mode (frozen -- fixed when the model is
        built -- or eval), the chain is one kernel launch, which folds
        the BN itself and takes h at the strides it has; both layers'
        states are untouched there, so bypassing `run` leaves them as
        they were. Unfrozen train mode needs batch statistics, so it
        keeps the per-layer composition."""
        if depthwise_impl == "fused" and (frozen(bn_name) or not run.train):
            p_bn = run.params[bn_name]
            s_bn = run.state[bn_name]
            return fused_conv.fused_depthwise_bn_relu6(
                h, run.params[dw_name]["kernel"].to(h.dtype),
                p_bn["scale"], p_bn["bias"], s_bn["mean"], s_bn["var"],
                eps=_BN["eps"], stride=stride)
        return relu6(run(bn_name, run(dw_name, h)))

    units = []
    stem_names = [
        reg(core.Conv2d(in_channels, 32, 3, stride=2, use_bias=False,
                        name="Conv1")),
        reg(bn(32, "bn_Conv1")),
        reg(core.DepthwiseConv2d(32, 3, use_bias=False, impl=layer_impl,
                                 name="expanded_conv_depthwise")),
        reg(bn(32, "expanded_conv_depthwise_BN")),
        reg(core.Conv2d(32, 16, 1, use_bias=False,
                        name="expanded_conv_project")),
        reg(bn(16, "expanded_conv_project_BN")),
    ]

    def stem(run, x):
        h = relu6(run("bn_Conv1", run("Conv1", x)))
        h = dw_chain(run, h, "expanded_conv_depthwise",
                     "expanded_conv_depthwise_BN", stride=1)
        return run("expanded_conv_project_BN",
                   run("expanded_conv_project", h))

    units.append((stem_names, stem))

    c_in = 16
    for b, (t, c, s) in enumerate(_BLOCKS[1:], start=1):
        hidden = t * c_in
        names = [
            reg(core.Conv2d(c_in, hidden, 1, use_bias=False,
                            name=f"block_{b}_expand")),
            reg(bn(hidden, f"block_{b}_expand_BN")),
            reg(core.DepthwiseConv2d(hidden, 3, stride=s, use_bias=False,
                                     impl=layer_impl,
                                     name=f"block_{b}_depthwise")),
            reg(bn(hidden, f"block_{b}_depthwise_BN")),
            reg(core.Conv2d(hidden, c, 1, use_bias=False,
                            name=f"block_{b}_project")),
            reg(bn(c, f"block_{b}_project_BN")),
        ]

        def block(run, h, *, b=b, s=s, residual=(s == 1 and c == c_in)):
            inp = h
            h = relu6(run(f"block_{b}_expand_BN", run(f"block_{b}_expand", h)))
            h = dw_chain(run, h, f"block_{b}_depthwise",
                         f"block_{b}_depthwise_BN", stride=s)
            h = run(f"block_{b}_project_BN", run(f"block_{b}_project", h))
            return h + inp if residual else h

        units.append((names, block))
        c_in = c

    top_names = [
        reg(core.Conv2d(320, 1280, 1, use_bias=False, name="Conv_1")),
        reg(bn(1280, "Conv_1_bn")),
    ]
    units.append((top_names,
                  lambda run, h: relu6(run("Conv_1_bn", run("Conv_1", h)))))
    return units, layers


def fused_call_shapes(batch: int, size: int) -> list[dict]:
    """The fused depthwise chain's call schedule at an input resolution:
    one dict of `ops.fused_conv.depthwise_call_cost` kwargs per
    depthwise layer (stem + 16 blocks)."""
    h = -(-size // 2)                      # after the stride-2 stem conv
    calls = [dict(n=batch, h_in=h, w_in=h, c=32, stride=1)]
    c_in = 16
    for t, c, s in _BLOCKS[1:]:
        calls.append(dict(n=batch, h_in=h, w_in=h, c=t * c_in, stride=s))
        if s == 2:
            h = -(-h // 2)
        c_in = c
    return calls


def fused_chain_count(bn_frozen_below: int, *, train: bool) -> int:
    """How many of the 17 depthwise chains run as the fused kernel in
    one forward of a ``depthwise_impl="fused"`` build: all of them in
    eval, only those whose BN is frozen in train mode."""
    names = ["expanded_conv_depthwise_BN"] + [
        f"block_{b}_depthwise_BN" for b in range(1, len(_BLOCKS))]
    if not train:
        return len(names)
    return sum(KERAS_LAYER_INDEX[n] < bn_frozen_below for n in names)


def mobilenet_v2_backbone(in_channels: int = 3, *, bn_frozen_below: int = 0,
                          depthwise_impl: str = "grouped"
                          ) -> core.UnitBackbone:
    """The backbone; layers keyed by Keras layer names.

    `bn_frozen_below`: BN layers with Keras index < this run in permanent
    inference mode (Keras ``trainable=False``) -- FREEZE_ALL for the
    head-only phase, the phase-2 `fine_tune_at` for fine-tuning. Its
    `splitter` cuts at unit edges (stem, 16 blocks, top), so a fused
    chain never straddles the feature cache's boundary."""
    units, layers = _units(in_channels, bn_frozen_below, depthwise_impl)
    bb = core.UnitBackbone(units, layers, "mobilenet_v2", KERAS_LAYER_INDEX)
    if bb.layer_names != tuple(KERAS_LAYER_INDEX):
        raise AssertionError("layer order drifted from Keras' numbering")
    return bb


def mobilenet_v2(num_outputs: int = 1, in_channels: int = 3, *,
                 bn_frozen_below: int = 0,
                 depthwise_impl: str = "grouped") -> core.Classifier:
    backbone = mobilenet_v2_backbone(in_channels,
                                     bn_frozen_below=bn_frozen_below,
                                     depthwise_impl=depthwise_impl)
    return core.Classifier(backbone, 1280, num_outputs,
                           name="mobilenet_v2_classifier")


head_only_mask = core.head_only_mask


def fine_tune_mask(module, fine_tune_at: int = 100):
    """Unfreeze backbone layers with Keras index >= fine_tune_at (100
    lands inside block 11)."""
    return core.keras_fine_tune_mask(module, KERAS_LAYER_INDEX, fine_tune_at)
