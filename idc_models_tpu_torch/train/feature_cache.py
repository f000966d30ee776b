"""Frozen-backbone feature cache for phase-2 fine-tuning.

The counterpart of ``idc_models_tpu/train/feature_cache.py``. In phase 2
only the layers with Keras index >= fine_tune_at train, so the frozen
prefix of the backbone is a constant function of each image: the cache
runs it once over the train and validation sets, and phase 2 trains the
live suffix (+ GAP + head) on the cached activations. The prefix is
deterministic (no dropout in any zoo backbone; its BNs are built frozen,
in inference mode), so the cached phase computes the same function as
the uncached one.

Splitting: a ``core.Sequential`` backbone (VGG16) splits at its first
live layer; a ``core.UnitBackbone`` (MobileNetV2, DenseNet201) at the
first unit holding a live layer (``UnitBackbone.splitter``), so residual
adds, dense blocks and fused chains stay whole. `plan_feature_cache`
returns None where there is nothing to split (the small CNN, or a
boundary at the first layer).

Where the JAX package projects the full model's trees onto the suffix
(``suffix_variables``) and grafts the trained suffix back
(``merge_suffix_variables``), the port's prefix and suffix modules hold
the full model's own layers: training the suffix model trains the full
model in place, and no tree is copied either way.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from idc_models_tpu_torch.data.idc import ArrayDataset
from idc_models_tpu_torch.data.pipeline import eval_batches, to_device
from idc_models_tpu_torch.models import core


@dataclasses.dataclass(frozen=True)
class FeatureCachePlan:
    """The split: `prefix` (frozen, run once over the data) and
    `suffix_model` (the live suffix + GAP + the full model's head,
    trained on the cached features), both over the full model's
    layers."""

    prefix: nn.Module
    suffix_model: core.Classifier
    # first backbone layer of the suffix (None: empty suffix); on a unit
    # backbone it may be a frozen layer of the boundary unit
    boundary: str | None
    suffix_keys: tuple[str, ...]   # backbone layer keys the suffix owns


def plan_feature_cache(model: nn.Module, layer_index: dict[str, int],
                       fine_tune_at: int) -> FeatureCachePlan | None:
    """Split `model` (a ``core.Classifier``) at the fine-tune boundary,
    or None when it cannot be split or nothing frozen precedes the
    boundary."""
    backbone = getattr(model, "backbone", None)
    if isinstance(backbone, core.Sequential):
        keys = list(backbone.layer_names)
        live = [k for k in keys if layer_index.get(k, -1) >= fine_tune_at]
        if live:
            boundary = live[0]
            if boundary == keys[0]:
                return None          # nothing frozen before it: no win
            prefix, suffix_bb = core.split_sequential(backbone, boundary)
        else:
            # everything frozen: cache the backbone, train GAP + head
            boundary = None
            prefix = backbone
            suffix_bb = core.subsequence(backbone, [],
                                         name=f"{backbone.name}[empty]")
    elif isinstance(backbone, core.UnitBackbone):
        split = backbone.splitter(fine_tune_at)
        if split is None:
            return None
        prefix, suffix_bb = split
        boundary = (suffix_bb.layer_names[0] if suffix_bb.layer_names
                    else None)
    else:
        return None
    suffix_model = core.Classifier(suffix_bb, *model.head.kernel.shape,
                                   name=f"{model.name}_suffix",
                                   head=model.head)
    return FeatureCachePlan(prefix=prefix, suffix_model=suffix_model,
                            boundary=boundary,
                            suffix_keys=tuple(suffix_bb.layer_names))


def compute_features(plan: FeatureCachePlan, ds: ArrayDataset, *,
                     batch_size: int) -> ArrayDataset:
    """Run the frozen prefix over `ds` once, in eval mode with no
    gradient, on the model's device, and return its activations as a
    host f32 dataset with the same labels and order.

    The final partial batch is padded to `batch_size` with zeros (as the
    JAX package pads its mesh batches): convolution libraries pick their
    algorithm by batch size, and the uncached step only ever runs full
    batches, so a full batch gives the features it would compute."""
    device = plan.suffix_model.head.kernel.device
    plan.prefix.eval()
    parts = []
    with torch.no_grad():
        for x, _ in to_device(eval_batches(ds, batch_size), device):
            n = len(x)
            if n < batch_size:
                x = torch.cat([x, x.new_zeros((batch_size - n,)
                                              + x.shape[1:])])
            parts.append(plan.prefix(x)[:n].float())
    return ArrayDataset(torch.cat(parts).cpu().numpy(), ds.labels)
