"""Model registry: name -> constructor, masks, fine-tune default, Keras
layer index, partition rules.

The counterpart of ``idc_models_tpu/models/registry.py`` for the
classifier zoo (VGG16, MobileNetV2, DenseNet201, the small CNN), and
each model's default partition rules (``partition.py``): replicated for
the zoo, `LM_RULES` for the LM.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

from torch import nn

from idc_models_tpu_torch import mesh as meshlib, partition
from idc_models_tpu_torch.mesh import PartitionSpec as P
from idc_models_tpu_torch.models import core, densenet, mobilenet, vgg
from idc_models_tpu_torch.models import small_cnn as small_cnn_mod

# The zoo replicates by default: data parallelism alone is fastest at the
# reference's 50x50.
REPLICATED_RULES = partition.PartitionRules.replicated()

_D, _M = meshlib.DATA_AXIS, meshlib.MODEL_AXIS

# The LM (models/lm.py): FSDP over "data" (the parameters and the RMSprop
# moments that mirror them), tensor parallelism over "model" in the
# Megatron orientation (qkv, fc1 and the head column-parallel, wo and fc2
# row-parallel), biases riding their kernel's output split. First match
# wins; the catch-all replicates the LayerNorms, bo, fc2/bias and the
# step counter. The JAX package's rules, pattern for pattern.
_LM_RULE_PAIRS = (
    (r"mha/w[qkv]$", P(_D, _M)),       # [E, E] column-parallel
    (r"mha/wo$", P(_M, _D)),           # [E, E] row-parallel
    (r"fc1/kernel$", P(_D, _M)),       # [E, mlp] column-parallel
    (r"fc1/bias$", P(_M)),             # [mlp] rides fc1's out split
    (r"fc2/kernel$", P(_M, _D)),       # [mlp, E] row-parallel
    (r"head/kernel$", P(_D, _M)),      # [E, vocab] column-parallel
    (r"head/bias$", P(_M)),            # [vocab] rides the head split
    (r"embed$", P(None, _D)),          # [vocab, E] FSDP on E
    (r"pos$", P(None, _D)),            # [T, E] FSDP on E
    (r".*", P()),                      # LN scale/bias, bo, fc2/bias,
    #                                    step counter: replicated
)
LM_RULES = partition.PartitionRules(_LM_RULE_PAIRS)
# the learned drafter's own rule set (the same schema; tuned apart)
DRAFT_LM_RULES = partition.PartitionRules(_LM_RULE_PAIRS)

PARTITION_RULES: dict[str, partition.PartitionRules] = {
    "replicated": REPLICATED_RULES,
    "lm": LM_RULES,
    "draft_lm": DRAFT_LM_RULES,
}


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
    # the model's default regex -> spec policy (partition.py)
    partition_rules: partition.PartitionRules = REPLICATED_RULES


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


def get_partition_rules(name: str) -> partition.PartitionRules:
    """Default partition rules for a registered model, or the "lm",
    "draft_lm" and "replicated" rule sets."""
    if name in PARTITION_RULES:
        return PARTITION_RULES[name]
    if name in REGISTRY:
        return REGISTRY[name].partition_rules
    raise KeyError(
        f"no partition rules for {name!r}; have "
        f"{sorted(set(PARTITION_RULES) | set(REGISTRY))}")


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
