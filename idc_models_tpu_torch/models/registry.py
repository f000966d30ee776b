"""Model registry: name -> constructor, masks, fine-tune default, Keras
layer index.

The counterpart of ``idc_models_tpu/models/registry.py`` for the
classifier zoo (VGG16, MobileNetV2, DenseNet201, the small CNN). One
card, world size 1: no partition rules.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

from torch import nn

from idc_models_tpu_torch.models import core, densenet, mobilenet, vgg
from idc_models_tpu_torch.models import small_cnn as small_cnn_mod


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    build: Callable[..., nn.Module]   # (num_outputs, in_channels, **kw)
    head_only_mask: Callable          # module -> {name: bool}
    fine_tune_mask: Callable          # (module, fine_tune_at) -> {name: bool}
    default_fine_tune_at: int
    # Keras layer index per parameterized backbone layer, for the
    # fine-tune boundary of the frozen-prefix feature cache; None for
    # models without one
    layer_index: dict[str, int] | None = None


REGISTRY: dict[str, ModelSpec] = {
    "vgg16": ModelSpec(vgg.vgg16, vgg.head_only_mask, vgg.fine_tune_mask,
                       default_fine_tune_at=15,
                       layer_index=vgg.KERAS_LAYER_INDEX),
    "mobilenet_v2": ModelSpec(mobilenet.mobilenet_v2,
                              mobilenet.head_only_mask,
                              mobilenet.fine_tune_mask,
                              default_fine_tune_at=100,
                              layer_index=mobilenet.KERAS_LAYER_INDEX),
    "densenet201": ModelSpec(densenet.densenet201, densenet.head_only_mask,
                             densenet.fine_tune_mask,
                             default_fine_tune_at=150,
                             layer_index=densenet.KERAS_LAYER_INDEX),
    # no transfer learning: every parameter trains, as in the JAX package
    "small_cnn": ModelSpec(
        lambda num_outputs=1, in_channels=3: small_cnn_mod.small_cnn(
            10, in_channels, num_outputs),
        lambda module: core.trainability_mask(module, lambda p: True),
        lambda module, fine_tune_at=0: core.trainability_mask(
            module, lambda p: True),
        default_fine_tune_at=0),
}


def get_model(name: str) -> ModelSpec:
    if name not in REGISTRY:
        raise KeyError(f"unknown model {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]


# What "fused backbone" means per model: for MobileNetV2 the fused
# depthwise chain (the hand-written CUDA kernel) is opt-in, "grouped"
# (cuDNN) the default; for DenseNet201 the packed blocks are the
# default and "concat" the reference they are held against, as in the
# JAX package.
FUSED_BUILD_KWARGS: dict[str, dict] = {
    "mobilenet_v2": {"depthwise_impl": "fused"},
    "densenet201": {"block_impl": "packed"},
}
UNFUSED_BUILD_KWARGS: dict[str, dict] = {
    "mobilenet_v2": {"depthwise_impl": "grouped"},
    "densenet201": {"block_impl": "concat"},
}
