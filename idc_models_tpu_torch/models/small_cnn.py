"""The small custom CNN of the secure-federated workload.

The counterpart of ``idc_models_tpu/models/small_cnn.py`` (the
reference's `create_model`, secure_fed_model.py:84-98): Conv2D(32, 3x3,
stride 2, SAME) -> relu -> MaxPool(2x2) -> Dropout(0.25) -> Flatten ->
Dense(8) -> relu -> Dropout(0.5) -> Dense(1), for 10x10x3 inputs,
binary logits. 1,937 parameters at the default size.
"""

from __future__ import annotations

from idc_models_tpu_torch.models import core


def small_cnn(input_size: int = 10, channels: int = 3,
              num_outputs: int = 1) -> core.Sequential:
    # stride-2 SAME conv: 10x10 -> 5x5; maxpool 2x2 VALID: 5x5 -> 2x2
    conv_out = (input_size + 1) // 2
    pooled = conv_out // 2
    flat = pooled * pooled * 32
    return core.Sequential(
        [
            core.Conv2d(channels, 32, 3, stride=2, padding="SAME",
                        name="conv1"),
            core.ReLU(),
            core.MaxPool(2, name="pool1"),
            core.Dropout(0.25, name="drop1"),
            core.Flatten(),
            core.Dense(flat, 8, name="fc1"),
            core.ReLU(name="relu_1"),
            core.Dropout(0.5, name="drop2"),
            core.Dense(8, num_outputs, name="head"),
        ],
        name="small_cnn",
    )
