"""Unified telemetry layer (the reference's ``repro.observability``): span
tracer + metrics registry + autotune regret auditing.

Three pieces, one import surface:

- :mod:`repro_torch.observability.trace` — nested spans into a
  process-local ring buffer with a Chrome-trace/Perfetto exporter and
  ``torch.profiler.record_function`` bridging. Hot-path spans (kernel
  dispatch) are gated by ``REPRO_TELEMETRY`` (default off); structural
  spans (train step, serve wave, scheduler lifecycle) record
  unconditionally unless the emitting object is built ``telemetry=False``.
- :mod:`repro_torch.observability.metrics` — counters/gauges/fixed-bucket
  histograms with labeled series and a JSON-lines snapshot exporter;
  ``ServeMetrics`` and the trainer hooks sit on this registry.
- :mod:`repro_torch.observability.regret` — the autotune decision audit:
  predicted-vs-measured per (impl, workload-key), flagged regret, and
  would-have-won alternatives.
"""
from repro_torch.observability.metrics import (  # noqa: F401
    DEFAULT_TIME_BUCKETS,
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
)
from repro_torch.observability.trace import (  # noqa: F401
    ENV_VAR,
    TRACER,
    TraceEvent,
    Tracer,
    enabled,
    export_chrome_trace,
    sanitize_json,
    set_enabled,
    span,
    telemetry,
)

__all__ = [
    "AUDITOR", "Counter", "DEFAULT_TIME_BUCKETS", "ENV_VAR", "Gauge",
    "Histogram", "MetricsRegistry", "REGISTRY", "RegretAuditor",
    "RegretEntry", "TRACER", "TraceEvent", "Tracer", "default_auditor",
    "default_registry", "enabled", "export_chrome_trace", "sanitize_json",
    "set_enabled", "span", "telemetry",
]

# The regret auditor imports repro_torch.autotune (cost model + selector);
# loading it lazily keeps `kernels/ops.py`'s import of this package out of
# the autotune import graph.
_REGRET_NAMES = ("AUDITOR", "RegretAuditor", "RegretEntry",
                 "default_auditor")


def __getattr__(name: str):
    if name in _REGRET_NAMES:
        from repro_torch.observability import regret

        return getattr(regret, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")
