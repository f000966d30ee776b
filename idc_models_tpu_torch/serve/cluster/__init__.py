"""The serving cluster, the counterpart of
``idc_models_tpu/serve/cluster``: the cross-replica prefix registry,
replicas, the router (placement, prefill -> decode handoff, hedging,
drain with live slot migration, failover, fleet rollout), the autoscaler
and the fleet telemetry and watchdogs, with the shared compile cache's
counters on the fleet /healthz (ROADMAP A10)."""

from idc_models_tpu_torch.serve.cluster.autoscaler import (  # noqa: F401
    AutoscaleConfig, Autoscaler,
)
from idc_models_tpu_torch.serve.cluster.registry import (  # noqa: F401
    PrefixRegistry,
)
from idc_models_tpu_torch.serve.cluster.replica import (  # noqa: F401
    Replica, build_replica,
)
from idc_models_tpu_torch.serve.cluster.router import Router  # noqa: F401
from idc_models_tpu_torch.serve.cluster.telemetry import (  # noqa: F401
    ClusterTelemetry, ClusterWatchdog, WatchdogConfig,
)
