"""The continuous-batching graph-serving scheduler (the reference's
``repro.scheduler.scheduler``).

Pipeline: ``submit()`` → :class:`~repro_torch.scheduler.queue.AdmissionQueue`
→ geometry buckets (:class:`~repro_torch.scheduler.bucketing.TierPolicy`) →
:class:`~repro_torch.scheduler.dispatcher.ContinuousDispatcher` picks the
next wave → the tier's cached
:class:`~repro_torch.serving.engine.GraphServeEngine` executes it →
:class:`~repro_torch.scheduler.metrics.ServeMetrics` accounts for it. ``drain()`` is an event loop over a pluggable clock:

- :class:`RealClock` — wall time; waiting sleeps.
- :class:`VirtualClock` — simulated time; waiting jumps to the next event
  and each wave advances the clock by its (measured or modeled) service
  time. This is what makes arrival-process benchmarks and latency tests
  deterministic and fast.

Numerics: the scheduler serves with ``bn_mode="sample"`` by default —
per-graph batch-norm statistics — because under continuous batching the set
of co-batched requests is a scheduling accident, and a request's logits must
not depend on it. With sample-mode BN every request's output equals
scoring it alone through a ``GraphServeEngine`` of the same tier geometry:
bitwise on the CPU, and to the kernels' f32 tolerance on the GPU (the
fused kernel's small branch adds a row's slots in integer-atomic order).

The reference's ``mesh=`` is ``device=`` here: the default engine factory
builds every tier's engine on that device (the current CUDA device unless
the caller asks for another; without a GPU the constructor raises).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Callable, Sequence

from repro_torch import resolve_device
from repro_torch.core.gcn import GCNConfig
from repro_torch.scheduler.bucketing import GeometryTier, TierPolicy
from repro_torch.scheduler.dispatcher import ContinuousDispatcher, Wait, WavePlan
from repro_torch.scheduler.metrics import ServeMetrics
from repro_torch.scheduler.programs import ProgramCache
from repro_torch.scheduler.queue import AdmissionQueue, PendingRequest
from repro_torch.serving.engine import GraphRequest, GraphServeEngine


class RealClock:
    """Wall time (monotonic); waiting really sleeps."""

    def now(self) -> float:
        return time.monotonic()

    def sleep_until(self, t: float) -> None:
        dt = t - time.monotonic()
        if dt > 0:
            time.sleep(dt)

    def on_service(self, dt: float) -> None:
        pass                        # wall time already advanced while serving


class VirtualClock:
    """Simulated time for deterministic scheduling runs: waiting jumps the
    clock forward, and each executed wave advances it by the wave's service
    time (measured wall time, or the caller's service model)."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def sleep_until(self, t: float) -> None:
        self._t = max(self._t, t)

    def on_service(self, dt: float) -> None:
        self._t += dt


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Knobs of the continuous-batching policy."""

    batch: int | None = None        # wave slots per tier; None inherits the
                                    # TierPolicy's batch (default 32). Setting
                                    # both this and an explicit `tiers=` to
                                    # different values is a config error.
    flush_after: float = 0.05       # straggler guard / deadline margin (s)
    bn_mode: str = "sample"         # wave-composition-invariant numerics;
                                    # "batch" restores legacy wave statistics
    default_slo: float | None = None  # deadline = arrival + slo when the
                                      # caller gives none (None: best effort)


class Scheduler:
    """Continuous-batching front end over per-tier ``GraphServeEngine``s.

    Either one-shot::

        sched = Scheduler(params, cfg, tiers=TierPolicy.for_sizes(...))
        sched.serve(requests)                  # everything, now

    or streaming::

        sched.submit(r, arrival=t, deadline=t + 0.2)
        ...
        sched.drain()                          # event loop until empty

    ``device=`` flows to every tier engine the default factory builds (the
    reference's ``mesh=``, which the port does not have yet).

    Telemetry: the request lifecycle —
    arrival → admit → dispatch → finish — lands in the span tracer as
    instants plus one complete span per request and per wave, stamped from
    the SCHEDULER's clock (virtual or wall) on the shared ``tid="clock"``
    track, with queue-depth counter samples at every admit/dispatch.
    ``telemetry=False`` silences the trace feed; ``registry=`` hands
    :class:`ServeMetrics` a shared metrics registry (plus ``instance``
    label) instead of its own.
    """

    def __init__(
        self,
        params,
        cfg: GCNConfig,
        *,
        tiers: TierPolicy | None = None,
        config: SchedulerConfig | None = None,
        device=None,
        clock=None,
        service_model: Callable[[GeometryTier, int], float] | None = None,
        engine_factory: Callable[[GeometryTier], GraphServeEngine]
        | None = None,
        telemetry: bool = True,
        registry=None,
        instance: str = "default",
    ):
        from repro_torch.observability import TRACER
        self.device = resolve_device(device)
        self.config = config or SchedulerConfig()
        if self.config.bn_mode != cfg.bn_mode:
            cfg = dataclasses.replace(cfg, bn_mode=self.config.bn_mode)
        self.cfg = cfg
        self.policy = tiers or TierPolicy(batch=self.config.batch or 32)
        if self.config.batch is not None and any(
                t.batch != self.config.batch for t in self.policy.tiers):
            raise ValueError(
                f"SchedulerConfig.batch={self.config.batch} disagrees with "
                f"the tier policy's wave size(s) "
                f"{sorted({t.batch for t in self.policy.tiers})}; wave "
                "geometry comes from the TierPolicy — set batch there, or "
                "leave SchedulerConfig.batch=None to inherit it")
        self.clock = clock or RealClock()
        self.service_model = service_model
        self.dispatcher = ContinuousDispatcher(
            flush_after=self.config.flush_after)
        self.queue = AdmissionQueue()
        self.buckets: dict[GeometryTier, collections.deque[PendingRequest]]
        self.buckets = {}
        self.telemetry = telemetry
        self.tracer = TRACER
        self._calibrated: set[GeometryTier] = set()
        self.metrics = ServeMetrics(
            registry=registry,
            labels=None if registry is None else {"instance": instance})
        # engine_factory lets several schedulers share warm engines (one
        # engine per geometry across e.g. a benchmark's policy variants);
        # a custom factory owns the engines' cfg, numerics and device
        self.programs = ProgramCache(
            engine_factory or (lambda tier: GraphServeEngine(
                params, self.cfg, batch=tier.batch, m_pad=tier.m_pad,
                nnz_pad=tier.nnz_pad, device=self.device)))
        self.completed: list[PendingRequest] = []

    # -- intake -------------------------------------------------------------
    def submit(self, request: GraphRequest, *, arrival: float | None = None,
               deadline: float | None = None) -> PendingRequest:
        """Queue one request. ``arrival`` defaults to the clock's now (a
        future arrival is admitted when the clock reaches it); ``deadline``
        defaults to ``arrival + default_slo`` when an SLO is configured."""
        if arrival is None:
            arrival = self.clock.now()
        if deadline is None and self.config.default_slo is not None:
            deadline = arrival + self.config.default_slo
        if self.telemetry:
            self.tracer.instant(
                "request/arrival", ts=arrival, cat="sched",
                args={"n_nodes": request.n_nodes,
                      "max_nnz": request.max_nnz, "deadline": deadline})
        return self.queue.submit(request, arrival=arrival, deadline=deadline)

    def _queue_depth(self) -> int:
        return sum(len(b) for b in self.buckets.values())

    def _admit(self, now: float) -> None:
        admitted = False
        for p in self.queue.due(now):
            tier = self.policy.assign(p.request)
            if tier is None:
                r = p.request
                r.failed, r.done = True, False
                r.error = (
                    f"no geometry tier fits n_nodes={r.n_nodes}, "
                    f"max_nnz={r.max_nnz} (top tier: {self.policy.tiers[-1]})")
                self.metrics.record_rejection(arrival=p.arrival)
                self.completed.append(p)
                if self.telemetry:
                    self.tracer.instant("request/reject", ts=now, cat="sched",
                                        args={"reason": r.error})
                continue
            p.tier = tier
            self.buckets.setdefault(tier, collections.deque()).append(p)
            admitted = True
            if self.telemetry:
                self.tracer.instant("request/admit", ts=now, cat="sched",
                                    args={"tier": tier.key})
        if admitted and self.telemetry:
            self.tracer.counter("queue_depth", self._queue_depth(), ts=now,
                                cat="sched")

    # -- execution ----------------------------------------------------------
    def warmup(self, requests: Sequence[GraphRequest]) -> int:
        """Build and warm the tier program of every geometry these requests
        would use (one empty wave each: every kernel the tier runs is built
        and loaded); returns the number of programs now cached. Call it so
        the kernels' build stays out of the timed run."""
        tiers = {self.policy.assign(r) for r in requests} - {None}
        for tier in sorted(tiers):
            self.programs.get(tier).warm()
        self.metrics.compile_count = self.programs.compile_count
        return self.programs.compile_count

    def _execute(self, plan: WavePlan) -> None:
        wave: list[PendingRequest] = []
        for src, count in plan.takes:
            bucket = self.buckets[src]
            wave.extend(bucket.popleft() for _ in range(count))
        # the chosen tier's own requests first, then top-ups (already the
        # takes order) — slot order inside one wave is irrelevant to outputs
        # (bn_mode="sample": per-slot numerics), but keep it deterministic
        program = self.programs.get(plan.tier)
        dispatch = self.clock.now()
        if self.telemetry:
            # the wall-clock sched/wave span wraps the engine's serve/wave
            # span (which wraps the kernel-dispatch spans): the nested
            # scheduler → wave → kernel structure the trace viewer shows
            span = self.tracer.span(
                "sched/wave", cat="sched",
                args={"tier": plan.tier.key, "n_requests":
                      sum(c for _, c in plan.takes)})
        else:
            span = contextlib.nullcontext()
        t0 = time.perf_counter()
        with span:
            report = program.engine.run_wave([p.request for p in wave])
        measured = time.perf_counter() - t0
        served = report.n_requests - report.n_failed
        service = (measured if self.service_model is None
                   else self.service_model(plan.tier, served))
        self.clock.on_service(service)
        finish = self.clock.now()
        self.metrics.record_wave(plan.tier.key, dispatch, service, report)
        if self.telemetry:
            self._feed_regret(plan.tier, program, measured)
        if self.telemetry:
            # clock-domain twin of the wall span: where the wave sits on the
            # scheduler's (possibly virtual) timeline
            self.tracer.complete(
                f"wave[{plan.tier.key}]", ts=dispatch, dur=service,
                cat="sched", args={"served": served,
                                   "n_failed": report.n_failed})
        for p in wave:
            p.served_tier = plan.tier
            p.dispatch, p.finish = dispatch, finish
            self.metrics.record_request(
                arrival=p.arrival, dispatch=dispatch, finish=finish,
                deadline=p.deadline, failed=p.request.failed)
            self.completed.append(p)
            if self.telemetry:
                self.tracer.complete(
                    "request", ts=p.arrival, dur=max(finish - p.arrival, 0.0),
                    tid="requests", cat="sched",
                    args={"tier": plan.tier.key,
                          "wait_s": dispatch - p.arrival,
                          "failed": bool(p.request.failed),
                          "deadline_missed": bool(
                              p.deadline is not None and finish > p.deadline)})
        if self.telemetry:
            self.tracer.counter("queue_depth", self._queue_depth(),
                                ts=finish, cat="sched")
        self.metrics.compile_count = self.programs.compile_count

    def _feed_regret(self, tier: GeometryTier, program, measured: float
                     ) -> None:
        """Wave-level calibration feed for the regret auditor: measured wave
        wall time vs the tier decision's predicted first-layer time. Each
        tier's FIRST wave is skipped, as in the reference, where it carries
        the compile (here: any first-call cost warmup did not pay). A
        pinned impl's decision has no prediction and records nothing; the
        fused layer dispatches outside ``batched_spmm``, so this is where
        its serve-side predicted-vs-measured provenance comes from."""
        if tier not in self._calibrated:
            self._calibrated.add(tier)      # compile wave: record nothing
            return
        d = program.decision
        w = getattr(d, "workload", None)
        predicted = dict(getattr(d, "scores", ()) or ()).get(d.impl)
        if predicted is None or predicted <= 0 or predicted != predicted \
                or predicted == float("inf"):
            return
        from repro_torch.observability import default_auditor

        default_auditor().record(
            w.key() if w is not None else tier.key, d.impl,
            predicted_s=predicted, measured_s=measured)

    def drain(self) -> list[PendingRequest]:
        """Event loop: admit arrivals, dispatch ready waves, wait (sleep or
        simulated jump) when batching longer is the better trade. Returns
        every request completed during this drain, completion order."""
        start = len(self.completed)
        while True:
            now = self.clock.now()
            self._admit(now)
            plan = self.dispatcher.next_wave(
                self.buckets, now, draining=len(self.queue) == 0)
            if isinstance(plan, WavePlan):
                self._execute(plan)
                continue
            nxt = self.queue.next_arrival()
            if isinstance(plan, Wait):
                target = plan.until if nxt is None else min(plan.until, nxt)
            elif nxt is not None:       # buckets empty, arrivals pending
                target = nxt
            else:                       # fully drained
                break
            self.clock.sleep_until(max(target, now))
        return self.completed[start:]

    def serve(self, requests: Sequence[GraphRequest], *,
              arrivals: Sequence[float] | None = None,
              deadlines: Sequence[float] | None = None,
              ) -> list[GraphRequest]:
        """Submit a whole stream (optionally with per-request arrival times
        and deadlines) and drain it. Returns the same request objects with
        ``logits``/``done`` (or ``failed``/``error``) filled in."""
        for i, r in enumerate(requests):
            self.submit(
                r,
                arrival=None if arrivals is None else arrivals[i],
                deadline=None if deadlines is None else deadlines[i])
        self.drain()
        return list(requests)

    # -- convenience constructors ------------------------------------------
    @classmethod
    def fixed_wave(cls, params, cfg: GCNConfig, *, batch: int = 32,
                   m_pad: int = 56, nnz_pad: int = 256,
                   **kw) -> "Scheduler":
        """The pre-scheduler baseline expressed in scheduler terms: ONE
        geometry tier at the worst-case padding, waves launch only when full
        (or at final drain) — exactly the old ``_serve_in_waves`` slicing,
        but measured by the same clock and metrics as the bucketed policy,
        so benchmark comparisons are apples-to-apples."""
        import math

        config = kw.pop("config", None) or SchedulerConfig(
            batch=batch, flush_after=math.inf)
        if not math.isinf(config.flush_after):
            config = dataclasses.replace(config, flush_after=math.inf)
        tiers = TierPolicy.single(m_pad=m_pad, nnz_pad=nnz_pad, batch=batch)
        return cls(params, cfg, tiers=tiers, config=config, **kw)
