"""Workload presets, as ``idc_models_tpu/configs.py`` holds them, for the
workloads ported so far (the ``mobile`` preset).

A copy, not an import: the port never imports the JAX package."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DistPreset:
    """Two-phase transfer learning of one backbone on IDC patches."""

    name: str
    model: str                   # registry key
    num_outputs: int
    image_size: int
    lr: float
    epochs: int                  # phase-1 epochs
    fine_tune_epochs: int
    batch_size: int              # global batch
    fine_tune_at: int
    dataset_limit: int | None    # balanced-subset size


PRESETS = {
    # the reference's dist_model_tf_mobile.py:8-16,130,146 -- MobileNetV2,
    # binary IDC, global batch 32, lr 1e-4, fine-tune at Keras index 100
    "mobile": DistPreset(
        name="mobile", model="mobilenet_v2", num_outputs=1, image_size=50,
        lr=1e-4, epochs=10, fine_tune_epochs=10, batch_size=32,
        fine_tune_at=100, dataset_limit=24257),
}


def get_preset(name: str) -> DistPreset:
    key = name.replace("-", "_")
    if key not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[key]
