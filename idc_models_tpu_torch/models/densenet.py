"""DenseNet201 backbone + transfer-learning head.

The counterpart of ``idc_models_tpu/models/densenet.py`` (the reference's
``dense`` preset): DenseNet201 without top, GAP, Dense(10) logits head
for CIFAR-10, fine_tune_at=150. Stem conv(64, 7x7, s2, explicit
((3,3),(3,3)) padding) -> BN -> relu -> 3x3/2 max pool with padding 1
-> dense blocks [6, 12, 48, 32] (growth 32; each layer is
BN-relu-conv1x1(128) -> BN-relu-conv3x3(32), its output appended to the
feature map) with BN-relu-conv1x1 + 2x2 average transitions that halve
the channels -> final BN + relu. Every conv is bias-free; BN eps
1.001e-5, momentum 0.99. Parameters plus BN statistics: 18,321,984, as
Keras ``DenseNet201(include_top=False)``.

`block_impl` picks how a layer's 32 channels join the feature map; the
values are the same either way:

- "packed" (the default): the block's [N, H, W, C_final] buffer is
  allocated once, at its first layer; each layer reads the slice
  ``buf[..., :c_in]`` and writes its output into ``buf[..., c_in:c_in +
  32]``. Channels past the last write are zero and no layer reads them;
  after the block's last layer the buffer is full. A unit edge inside a
  block carries the partly filled buffer, so a split there (the feature
  cache at fine_tune_at=150, inside conv4_block2) caches
  [N, H, W, C_final].
- "concat": ``cat(h, f(h))``, which rewrites the whole growing map at
  every layer -- the reference the packed block is held against.

Why packed trains in place. The JAX block is functional
(``dynamic_update_slice``); here the writes are in place, and autograd
refuses a backward through any op that saved a view of the buffer
before a later layer wrote into it (the storage's version moved). Of
the ops that read the buffer, only a train-mode BN saved its input, for
the square of its one-pass second moment; ``core.BatchNorm`` now saves
the centred input instead (``core._MeanSquare``), so nothing keeps a
view of the buffer and phase 2's backward runs through packed blocks.
This is safe by construction as well: every channel range is written
once, before any layer reads it, so no value a backward needs is ever
overwritten. A block-level ``autograd.Function`` would need a
hand-written backward of the whole layer; packed-only-without-gradient
would leave phase 2 on concat; ``allow_mutation_on_saved_tensors``
clones every saved view, which is the copy packing removes. A section
that starts inside a block (the feature cache's suffix) copies its
input once instead of writing into the caller's tensor (``run.entry``).

`KERAS_LAYER_INDEX` reproduces Keras' flat numbering, so
``fine_tune_at=150`` selects the same parameters here.
"""

from __future__ import annotations

import torch

from idc_models_tpu_torch.models import core

_BLOCKS = [6, 12, 48, 32]
_GROWTH = 32
_BN = dict(eps=1.001e-5, momentum=0.99)

BLOCK_IMPLS = ("packed", "concat")
FREEZE_ALL = 10**9  # bn_frozen_below value freezing every BN layer
DENSENET201_FEATURES = 1920


def _build_index() -> dict[str, int]:
    """Keras DenseNet201's layer numbering: parameter groups get the
    index of their conv/BN layer; inputs, pads, activations, concats and
    pools only advance it."""
    i = 0
    idx = {}

    def layer(name=None):
        nonlocal i
        if name is not None:
            idx[name] = i
        i += 1

    layer()                       # InputLayer
    layer()                       # ZeroPadding2D
    layer("conv1_conv")
    layer("conv1_bn")
    layer()                       # conv1_relu
    layer()                       # ZeroPadding2D
    layer()                       # pool1
    for stage, n_layers in enumerate(_BLOCKS, start=2):
        for l in range(1, n_layers + 1):
            p = f"conv{stage}_block{l}"
            layer(f"{p}_0_bn")
            layer()               # 0_relu
            layer(f"{p}_1_conv")
            layer(f"{p}_1_bn")
            layer()               # 1_relu
            layer(f"{p}_2_conv")
            layer()               # concat
        if stage < 5:
            layer(f"pool{stage}_bn")
            layer()               # pool relu
            layer(f"pool{stage}_conv")
            layer()               # avgpool
    layer("bn")
    layer()                       # relu
    return idx


KERAS_LAYER_INDEX: dict[str, int] = _build_index()


def _units(in_channels: int, bn_frozen_below: int,
           block_impl: str = "packed"):
    """The backbone as topology units -- the stem, one unit per dense
    layer, one per transition, the final BN -- over the flat Keras-named
    layers. Each unit is (layer_names, fn(run, h) -> h)."""
    if block_impl not in BLOCK_IMPLS:
        raise ValueError(
            f"block_impl must be packed|concat, got {block_impl!r}")
    layers = {}

    def reg(m) -> str:
        layers[m.name] = m
        return m.name

    def bn(c, name):
        return core.BatchNorm(c, name=name,
                              frozen=KERAS_LAYER_INDEX[name] < bn_frozen_below,
                              **_BN)

    units = []
    # Keras: ZeroPadding2D(3) + valid 7x7/2 conv, ZeroPadding2D(1) + valid
    # 3x3/2 pool -- symmetric, where TF-SAME would shift by a pixel
    stem_names = [
        reg(core.Conv2d(in_channels, 64, 7, stride=2, use_bias=False,
                        padding=((3, 3), (3, 3)), name="conv1_conv")),
        reg(bn(64, "conv1_bn")),
    ]
    pool1 = core.MaxPool(3, 2, padding=((1, 1), (1, 1)), name="pool1")

    def stem(run, x):
        return pool1(torch.relu(run("conv1_bn", run("conv1_conv", x))))

    units.append((stem_names, stem))

    def bottleneck(run, x, p):
        y = torch.relu(run(f"{p}_0_bn", x))
        y = run(f"{p}_1_conv", y)
        y = torch.relu(run(f"{p}_1_bn", y))
        return run(f"{p}_2_conv", y)

    def dense_layer_packed(run, h, *, p, c_in, c_final, first):
        if first:
            buf = h.new_zeros(h.shape[:3] + (c_final,))
            buf[..., :c_in] = h
        elif run.entry:
            buf = h.clone()     # the caller's tensor (a cached feature)
        else:
            buf = h
        buf[..., c_in:c_in + _GROWTH] = bottleneck(run, buf[..., :c_in], p)
        return buf

    def dense_layer_concat(run, h, *, p):
        return torch.cat([h, bottleneck(run, h, p)], dim=-1)

    avg = core.AvgPool(2, name="avgpool")

    def transition(run, h, *, stage):
        h = torch.relu(run(f"pool{stage}_bn", h))
        return avg(run(f"pool{stage}_conv", h))

    c = 64
    for stage, n_layers in enumerate(_BLOCKS, start=2):
        for l in range(1, n_layers + 1):
            p = f"conv{stage}_block{l}"
            c_in = c + (l - 1) * _GROWTH
            names = [
                reg(bn(c_in, f"{p}_0_bn")),
                reg(core.Conv2d(c_in, 4 * _GROWTH, 1, use_bias=False,
                                name=f"{p}_1_conv")),
                reg(bn(4 * _GROWTH, f"{p}_1_bn")),
                reg(core.Conv2d(4 * _GROWTH, _GROWTH, 3, use_bias=False,
                                name=f"{p}_2_conv")),
            ]
            if block_impl == "packed":
                fn = (lambda run, h, p=p, c_in=c_in,
                      c_final=c + n_layers * _GROWTH, first=(l == 1):
                      dense_layer_packed(run, h, p=p, c_in=c_in,
                                         c_final=c_final, first=first))
            else:
                fn = (lambda run, h, p=p: dense_layer_concat(run, h, p=p))
            units.append((names, fn))
        c = c + n_layers * _GROWTH
        if stage < 5:
            names = [
                reg(bn(c, f"pool{stage}_bn")),
                reg(core.Conv2d(c, c // 2, 1, use_bias=False,
                                name=f"pool{stage}_conv")),
            ]
            units.append((names, lambda run, h, stage=stage:
                          transition(run, h, stage=stage)))
            c = c // 2
    units.append(([reg(bn(c, "bn"))],
                  lambda run, h: torch.relu(run("bn", h))))
    return units, layers


def densenet201_backbone(in_channels: int = 3, *, bn_frozen_below: int = 0,
                         block_impl: str = "packed") -> core.UnitBackbone:
    """The backbone; layers keyed by Keras layer names.

    `bn_frozen_below`: BN layers with Keras index < this run in permanent
    inference mode (Keras ``trainable=False``). `block_impl`: "packed"
    or "concat" (see the module docstring)."""
    units, layers = _units(in_channels, bn_frozen_below, block_impl)
    bb = core.UnitBackbone(units, layers, "densenet201", KERAS_LAYER_INDEX)
    if bb.layer_names != tuple(KERAS_LAYER_INDEX):
        raise AssertionError("layer order drifted from Keras' numbering")
    return bb


def densenet201(num_outputs: int = 10, in_channels: int = 3, *,
                bn_frozen_below: int = 0,
                block_impl: str = "packed") -> core.Classifier:
    backbone = densenet201_backbone(in_channels,
                                    bn_frozen_below=bn_frozen_below,
                                    block_impl=block_impl)
    return core.Classifier(backbone, DENSENET201_FEATURES, num_outputs,
                           name="densenet201_classifier")


head_only_mask = core.head_only_mask


def fine_tune_mask(module, fine_tune_at: int = 150):
    """Unfreeze backbone layers with Keras index >= fine_tune_at (150
    lands inside conv4_block2)."""
    return core.keras_fine_tune_mask(module, KERAS_LAYER_INDEX, fine_tune_at)
