"""Sharded checkpoints and the zero-downtime weight rollout, the
counterpart of ``idc_models_tpu/checkpoint``.

`sharded` -- per-rank save and restore keyed on the partition rules, an
atomic MANIFEST.json as the completion contract, and a restore that
re-resolves the rules against the target mesh.

`rollout` -- the serving side's hot weight swap: stage a candidate,
spot-check it through the live engine, canary a fraction of the
traffic, compare its error and TTFT burn, then promote
(`SlotEngine.swap_params`) or roll back, with no request dropped or
duplicated.
"""

from idc_models_tpu_torch.checkpoint.rollout import (  # noqa: F401
    RolloutController, run_with_rollout,
)
from idc_models_tpu_torch.checkpoint.sharded import (  # noqa: F401
    FORMAT_VERSION, MANIFEST_NAME, CheckpointError, SaveHandle, barrier,
    checkpoint_info, restore_sharded, save_sharded,
)
