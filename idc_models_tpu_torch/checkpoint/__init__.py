"""Sharded checkpoints, the counterpart of ``idc_models_tpu/checkpoint``
(its `sharded` module; the weight rollout, ``rollout.py``, waits for
ROADMAP A11)."""

from idc_models_tpu_torch.checkpoint.sharded import (  # noqa: F401
    FORMAT_VERSION, MANIFEST_NAME, CheckpointError, SaveHandle, barrier,
    checkpoint_info, restore_sharded, save_sharded,
)
