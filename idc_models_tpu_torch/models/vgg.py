"""VGG16 backbone + transfer-learning head.

The counterpart of ``idc_models_tpu/models/vgg.py``, the reference's
flagship model: VGG16 without top (13 3x3 SAME convs with bias and ReLU,
a 2x2 max pool closing each of the 5 blocks), GlobalAveragePooling2D,
Dense(num_outputs) logits head. 14,714,688 backbone parameters, as
Keras ``VGG16(include_top=False)``.

Phase 1 trains the head only; phase 2 unfreezes the layers with Keras
index >= fine_tune_at=15, block 5's convolutions (`KERAS_LAYER_INDEX`
numbers the layers as Keras does, pools included). The backbone is a
``core.Sequential``, so the feature cache splits it at the first live
layer.
"""

from __future__ import annotations

from idc_models_tpu_torch.models import core

# (block, filters, convs-per-block) -- VGG16 topology
_CFG = [(1, 64, 2), (2, 128, 2), (3, 256, 3), (4, 512, 3), (5, 512, 3)]


def _build_index() -> dict[str, int]:
    """Keras VGG16(include_top=False).layers numbering of the conv
    layers: index 0 is the InputLayer, and each block's pooling layer
    takes an index too (it has no parameters, so no entry)."""
    idx, i = {}, 1
    for b, _, n in _CFG:
        for c in range(1, n + 1):
            idx[f"block{b}_conv{c}"] = i
            i += 1
        i += 1                     # the block's pooling layer
    return idx


KERAS_LAYER_INDEX: dict[str, int] = _build_index()


def vgg16_backbone(in_channels: int = 3) -> core.Sequential:
    layers = []
    c_in = in_channels
    for block, filters, n_convs in _CFG:
        for conv in range(1, n_convs + 1):
            layers.append(core.Conv2d(c_in, filters, 3,
                                      name=f"block{block}_conv{conv}"))
            layers.append(core.ReLU(name=f"block{block}_relu{conv}"))
            c_in = filters
        layers.append(core.MaxPool(2, name=f"block{block}_pool"))
    return core.Sequential(layers, name="vgg16")


def vgg16(num_outputs: int = 1, in_channels: int = 3) -> core.Classifier:
    """Backbone + GAP + Dense head; parameters ``backbone.*``, ``head.*``."""
    return core.Classifier(vgg16_backbone(in_channels), 512, num_outputs,
                           name="vgg16_classifier")


head_only_mask = core.head_only_mask


def fine_tune_mask(module, fine_tune_at: int = 15):
    """Phase-2 mask: head + backbone layers with Keras index >=
    fine_tune_at."""
    return core.keras_fine_tune_mask(module, KERAS_LAYER_INDEX, fine_tune_at)
