"""Observability: named wall-clock timers and the jsonl run log."""

from idc_models_tpu_torch.observe.logging import JsonlLogger
from idc_models_tpu_torch.observe.timer import Timer

__all__ = ["JsonlLogger", "Timer"]
