"""Continuous-batching graph-serving scheduler (the reference's
``repro.scheduler``).

Queue → geometry buckets → continuous-batching dispatcher → per-tier
engines (the program cache) → metrics. ``Scheduler`` is the front end;
``GraphServeEngine`` remains the per-wave executor underneath it.
"""
from repro_torch.scheduler.bucketing import GeometryTier, TierPolicy  # noqa: F401
from repro_torch.scheduler.dispatcher import (  # noqa: F401
    ContinuousDispatcher,
    Wait,
    WavePlan,
)
from repro_torch.scheduler.metrics import ServeMetrics, WaveRecord  # noqa: F401
from repro_torch.scheduler.programs import ProgramCache, TierProgram  # noqa: F401
from repro_torch.scheduler.queue import AdmissionQueue, PendingRequest  # noqa: F401
from repro_torch.scheduler.scheduler import (  # noqa: F401
    RealClock,
    Scheduler,
    SchedulerConfig,
    VirtualClock,
)

__all__ = [
    "AdmissionQueue", "ContinuousDispatcher", "GeometryTier", "PendingRequest",
    "ProgramCache", "RealClock", "Scheduler", "SchedulerConfig",
    "ServeMetrics", "TierPolicy", "TierProgram", "VirtualClock", "Wait",
    "WavePlan", "WaveRecord",
]
