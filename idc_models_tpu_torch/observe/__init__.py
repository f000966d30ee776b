"""Observability: trace spans, the metrics registry, SLOs, offline run
stats, performance attribution, timers and the jsonl run log (the
counterpart of ``idc_models_tpu/observe``)."""

from idc_models_tpu_torch.observe import profile, trace  # noqa: F401
from idc_models_tpu_torch.observe.exporter import MetricsExporter
from idc_models_tpu_torch.observe.logging import JsonlLogger
from idc_models_tpu_torch.observe.metrics_registry import (
    REGISTRY, Counter, Gauge, Histogram, MetricsRegistry, default_registry,
)
from idc_models_tpu_torch.observe.plots import plot_history
from idc_models_tpu_torch.observe.profile import (
    CompileWatchdog, DeviceTimeline, ProgramCost, RooflineSpec, arm_watchdog,
    disarm_watchdog, program_report, register_program, register_roof,
    roofline_for, roofline_verdict,
)
from idc_models_tpu_torch.observe.slo import SLO, SLOEngine
from idc_models_tpu_torch.observe.stats import (
    format_request_timeline, format_summary, summarize_jsonl,
)
from idc_models_tpu_torch.observe.timer import Timer, profile_trace
from idc_models_tpu_torch.observe.trace import (
    Tracer, get_tracer, set_tracer, tracing,
)

__all__ = [
    "CompileWatchdog", "Counter", "DeviceTimeline", "Gauge", "Histogram",
    "JsonlLogger", "MetricsExporter", "MetricsRegistry", "ProgramCost", "REGISTRY",
    "RooflineSpec", "SLO", "SLOEngine", "Timer", "Tracer", "arm_watchdog",
    "default_registry", "disarm_watchdog", "format_request_timeline",
    "format_summary", "get_tracer", "plot_history", "profile",
    "profile_trace", "program_report", "register_program", "register_roof",
    "roofline_for", "roofline_verdict", "set_tracer", "summarize_jsonl",
    "trace", "tracing",
]
