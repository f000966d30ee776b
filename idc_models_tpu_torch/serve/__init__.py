"""Continuous-batching LM serving, the counterpart of
``idc_models_tpu/serve`` (the contiguous and paged engines, the page
allocator, both prefix-cache flavours, the scheduler, server, metrics,
the resilience layer: the serve fault plan, the request journal and
the brownout controller, multi-tenant serving: the tenant registry,
quotas and adapter bank; ROADMAP A9.0-A9.4b, over the ranks of a mesh:
A9-dist), the serving cluster (``serve/cluster``: the prefix registry,
replicas, router, autoscaler and fleet telemetry; ROADMAP A10) and the
persistent compile cache (``serve/compile_cache.py``, A10)."""

from idc_models_tpu_torch.serve.api import (  # noqa: F401
    LMServer, Request, Result, load_trace, poisson_trace, save_trace,
)
from idc_models_tpu_torch.serve.brownout import (  # noqa: F401
    STAGES, BrownoutController,
)
from idc_models_tpu_torch.serve.compile_cache import (  # noqa: F401
    CompileCache, enable_persistent_kernel_cache,
)
from idc_models_tpu_torch.serve.engine import (  # noqa: F401
    HEALTH_KINDS, SlotEngine,
)
from idc_models_tpu_torch.serve.faults import (  # noqa: F401
    InjectedEngineCrash, InjectedPrefillError, ServeFault, ServeFaultPlan,
    parse_serve_fault_spec,
)
from idc_models_tpu_torch.serve.journal import (  # noqa: F401
    RequestJournal, load_journal, pending_requests,
)
from idc_models_tpu_torch.serve.metrics import (  # noqa: F401
    ServingMetrics, aggregate_summaries,
)
from idc_models_tpu_torch.serve.pages import (  # noqa: F401
    PageAllocator, PageExhausted,
)
from idc_models_tpu_torch.serve.prefix_cache import (  # noqa: F401
    PagedPrefixCache, PrefixCache,
)
from idc_models_tpu_torch.serve.scheduler import (  # noqa: F401
    AdmissionQueue, Entry, RetryPolicy, Scheduler,
)
from idc_models_tpu_torch.serve.tenancy import (  # noqa: F401
    AdapterBank, Tenancy, Tenant, TenantQuota, TenantRegistry,
)
from idc_models_tpu_torch.serve.cluster import (  # noqa: F401
    AutoscaleConfig, Autoscaler, ClusterTelemetry, ClusterWatchdog,
    PrefixRegistry, Replica, Router, WatchdogConfig, build_replica,
)
