"""Admission queue: arrival-stamped, deadline-carrying request intake.

The queue is the scheduler's front door (the reference's): every
:class:`~repro_torch.serving.engine.GraphRequest` is wrapped in a
:class:`PendingRequest` carrying its arrival timestamp, optional completion
deadline and (after admission) its geometry tier. Requests whose arrival lies
in the future — a simulated Poisson stream, or a real producer submitting
ahead — sit in an arrival-ordered heap until the scheduler's clock reaches
them; ``due(now)`` releases exactly the arrived prefix, in (arrival, submit
order) so FIFO ties break deterministically.
"""
from __future__ import annotations

import dataclasses
import heapq

from repro_torch.serving.engine import GraphRequest


@dataclasses.dataclass
class PendingRequest:
    """One queued request plus its serving lifecycle timestamps."""

    seq: int                        # submission order (FIFO tiebreak)
    request: GraphRequest
    arrival: float                  # clock time the request entered the system
    deadline: float | None = None   # absolute completion deadline (None: best effort)
    tier: object | None = None      # GeometryTier once admitted to a bucket
    served_tier: object | None = None  # wave geometry it actually rode (may
                                       # be larger than `tier`: wave top-up)
    dispatch: float | None = None   # clock time its wave launched
    finish: float | None = None     # clock time its wave completed

    @property
    def latency(self) -> float | None:
        return None if self.finish is None else self.finish - self.arrival

    @property
    def wait(self) -> float | None:
        return None if self.dispatch is None else self.dispatch - self.arrival


class AdmissionQueue:
    """Arrival-ordered intake heap. ``submit`` is O(log n), ``due`` pops the
    arrived prefix; the scheduler drains it every event-loop tick."""

    def __init__(self) -> None:
        self._heap: list[tuple[float, int, PendingRequest]] = []
        self._seq = 0

    def __len__(self) -> int:
        return len(self._heap)

    def submit(self, request: GraphRequest, *, arrival: float,
               deadline: float | None = None) -> PendingRequest:
        p = PendingRequest(seq=self._seq, request=request, arrival=arrival,
                           deadline=deadline)
        self._seq += 1
        heapq.heappush(self._heap, (arrival, p.seq, p))
        return p

    def due(self, now: float) -> list[PendingRequest]:
        """Pop every request with ``arrival <= now`` (arrival, then FIFO)."""
        out = []
        while self._heap and self._heap[0][0] <= now:
            out.append(heapq.heappop(self._heap)[2])
        return out

    def next_arrival(self) -> float | None:
        """Arrival time of the earliest still-future request, or None."""
        return self._heap[0][0] if self._heap else None
