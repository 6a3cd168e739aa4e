"""Span tracer: nested spans, a ring buffer, Chrome-trace export (DESIGN.md
§13).

One process-local :class:`Tracer` (the module singleton :data:`TRACER`)
collects three kinds of events into a bounded ring buffer:

- **complete spans** (Chrome ``ph="X"``) — a named interval with wall-clock
  ``ts``/``dur`` and structured ``args``; nested spans nest in the viewer by
  timestamp containment on the same track;
- **instant events** (``ph="i"``) — a point marker (request arrival, admit);
- **counter samples** (``ph="C"``) — a named scalar over time (queue depth).

Two clock domains share the file: spans opened with :meth:`Tracer.span` are
stamped from ``time.perf_counter`` (the process wall clock); scheduler
lifecycle events carry the *scheduler's* clock (possibly a
``VirtualClock``) and live on their own ``tid`` track so the two timelines
never interleave confusingly.

**Hot-path gating**: the module-level :func:`span` checks :func:`enabled`
(the ``REPRO_TELEMETRY`` env var, default off) before doing ANY work and
returns a shared null context when disabled — that one predicate is the
entire disabled-mode cost, which the overhead-guard test bounds at < 5% of
a single batched-SpMM dispatch. Structural spans (trainer steps, serve
waves, scheduler waves) call :meth:`Tracer.span` directly: they are
emitted unconditionally because their cost is negligible next to the work
they measure, and the emitting object takes ``telemetry=False`` to opt out.

**Profiler bridging**: every span also enters
``torch.profiler.record_function`` (the reference enters
``jax.profiler.TraceAnnotation``), so a concurrent ``torch.profiler``
capture shows our spans on the host-thread track, aligned with the CUDA
kernels they launch. The reference's second bridge, ``jax.named_scope``,
names traced ops in the HLO metadata; eager PyTorch has no such metadata,
so it has no counterpart here.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import pathlib
import threading
import time

ENV_VAR = "REPRO_TELEMETRY"
_TRUTHY = ("1", "true", "yes", "on")
_FALSY = ("0", "false", "no", "off")

# default ring capacity: ~64k events ≈ a few MB — long runs wrap instead of
# growing without bound, and `dropped` records how many fell off the front
DEFAULT_CAPACITY = 65536


def _env_default() -> bool:
    env = os.environ.get(ENV_VAR)
    if env is None:
        return False
    v = env.strip().lower()
    if v in _TRUTHY:
        return True
    if v in _FALSY:
        return False
    raise ValueError(
        f"{ENV_VAR}={env!r}: expected one of {_TRUTHY + _FALSY}")


class _State:
    enabled: bool = _env_default()


_STATE = _State()
_NULL = contextlib.nullcontext()


def enabled() -> bool:
    """Whether hot-path (kernel-dispatch) telemetry is on. This is the ONE
    check `kernels/ops.py` pays per dispatch when telemetry is off."""
    return _STATE.enabled


def set_enabled(value: bool) -> None:
    """Programmatic override of the ``REPRO_TELEMETRY`` default."""
    _STATE.enabled = bool(value)


@contextlib.contextmanager
def telemetry(value: bool = True):
    """Scoped :func:`set_enabled` — ``with telemetry(): ...``."""
    prev = _STATE.enabled
    _STATE.enabled = bool(value)
    try:
        yield
    finally:
        _STATE.enabled = prev


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One Chrome-trace event (the exporter serializes these verbatim)."""

    name: str
    ph: str                     # "X" complete | "i" instant | "C" counter
    ts: float                   # microseconds
    dur: float = 0.0            # microseconds, ph == "X" only
    tid: int | str = 0
    cat: str = "repro"
    args: dict | None = None


class Tracer:
    """Bounded ring buffer of trace events + the span context manager."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = capacity
        self._events: collections.deque[TraceEvent] = collections.deque(
            maxlen=capacity)
        self._lock = threading.Lock()
        self.dropped = 0

    # -- recording ----------------------------------------------------------
    def _append(self, ev: TraceEvent) -> None:
        with self._lock:
            if len(self._events) == self.capacity:
                self.dropped += 1
            self._events.append(ev)

    @contextlib.contextmanager
    def span(self, name: str, *, cat: str = "repro",
             args: dict | None = None, annotate: bool = True):
        """Record one complete span around the body. ``annotate=True`` also
        enters ``torch.profiler.record_function(name)`` so the span lines
        up with a profiler capture's CUDA kernels."""
        stack = contextlib.ExitStack()
        if annotate:
            import torch

            stack.enter_context(torch.profiler.record_function(name))
        t0 = time.perf_counter()
        try:
            with stack:
                yield self
        finally:
            t1 = time.perf_counter()
            self._append(TraceEvent(
                name=name, ph="X", ts=t0 * 1e6, dur=(t1 - t0) * 1e6,
                tid=threading.get_ident() & 0xFFFF, cat=cat, args=args))

    def complete(self, name: str, *, ts: float, dur: float,
                 tid: int | str = "clock", cat: str = "repro",
                 args: dict | None = None) -> None:
        """Record a complete span with CALLER-owned timestamps (seconds) —
        the scheduler's virtual-clock lifecycle track."""
        self._append(TraceEvent(name=name, ph="X", ts=ts * 1e6,
                                dur=dur * 1e6, tid=tid, cat=cat, args=args))

    def instant(self, name: str, *, ts: float | None = None,
                tid: int | str = "clock", cat: str = "repro",
                args: dict | None = None) -> None:
        ts = time.perf_counter() if ts is None else ts
        self._append(TraceEvent(name=name, ph="i", ts=ts * 1e6,
                                tid=tid, cat=cat, args=args))

    def counter(self, name: str, value: float, *, ts: float | None = None,
                tid: int | str = "clock", cat: str = "repro") -> None:
        ts = time.perf_counter() if ts is None else ts
        self._append(TraceEvent(name=name, ph="C", ts=ts * 1e6, tid=tid,
                                cat=cat, args={"value": float(value)}))

    # -- introspection / export --------------------------------------------
    def events(self) -> list[TraceEvent]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    def export_chrome(self, path: str | os.PathLike) -> pathlib.Path:
        """Write the buffer as STRICT Chrome-trace JSON (loads in Perfetto /
        chrome://tracing). ``allow_nan=False``: a NaN arg would render the
        file unparseable to strict readers, so args are sanitized first."""
        pid = os.getpid()
        out = []
        for ev in self.events():
            d = {"name": ev.name, "ph": ev.ph, "ts": ev.ts, "pid": pid,
                 "tid": ev.tid, "cat": ev.cat}
            if ev.ph == "X":
                d["dur"] = ev.dur
            if ev.ph == "i":
                d["s"] = "t"
            if ev.args is not None:
                d["args"] = sanitize_json(ev.args)
            out.append(d)
        doc = {"traceEvents": out, "displayTimeUnit": "ms",
               "otherData": {"dropped_events": self.dropped}}
        path = pathlib.Path(path)
        path.write_text(json.dumps(doc, allow_nan=False) + "\n")
        return path


def sanitize_json(obj):
    """Recursively map NaN/±Inf floats to None so a payload serializes under
    ``json.dumps(..., allow_nan=False)`` (strict JSON has no NaN literal).
    Shared by the trace exporter, the metrics snapshot, and
    ``benchmarks/common.write_bench_json``."""
    if isinstance(obj, dict):
        return {k: sanitize_json(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [sanitize_json(v) for v in obj]
    if isinstance(obj, float):
        return obj if obj == obj and abs(obj) != float("inf") else None
    return obj


TRACER = Tracer()


def span(name: str, *, cat: str = "repro", args: dict | None = None):
    """Gated hot-path span: a shared null context when telemetry is off —
    the kernels' per-dispatch cost is exactly this one predicate."""
    if not _STATE.enabled:
        return _NULL
    return TRACER.span(name, cat=cat, args=args)


def export_chrome_trace(path: str | os.PathLike) -> pathlib.Path:
    return TRACER.export_chrome(path)
