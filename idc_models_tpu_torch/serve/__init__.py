"""Continuous-batching LM serving, the counterpart of
``idc_models_tpu/serve`` (the contiguous engine, its scheduler, server,
metrics and the injected-failure exceptions; ROADMAP A9.0-A9.1)."""

from idc_models_tpu_torch.serve.api import (  # noqa: F401
    LMServer, Request, Result, load_trace, poisson_trace, save_trace,
)
from idc_models_tpu_torch.serve.engine import (  # noqa: F401
    HEALTH_KINDS, SlotEngine,
)
from idc_models_tpu_torch.serve.faults import (  # noqa: F401
    InjectedEngineCrash, InjectedPrefillError,
)
from idc_models_tpu_torch.serve.metrics import (  # noqa: F401
    ServingMetrics, aggregate_summaries,
)
from idc_models_tpu_torch.serve.scheduler import (  # noqa: F401
    AdmissionQueue, Entry, RetryPolicy, Scheduler,
)
