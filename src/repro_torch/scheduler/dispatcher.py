"""Continuous-batching dispatch policy: fill-rate vs. oldest-request wait.

Given the per-tier buckets of pending requests, decide — deterministically —
which tier launches the next wave, or how long to wait for a better one
(the reference's policy, its float arithmetic
copied as it is). A bucket becomes *ready* when any of:

- it can fill a full wave (``len(bucket) >= tier.batch``): maximal
  launch amortization, dispatch now;
- its oldest request has waited ``flush_after`` seconds: the straggler
  guard — a lone small molecule is never starved by an idle bucket;
- its tightest pending deadline's slack (anywhere in the bucket, not just
  the head) has shrunk to ``flush_after``: deadline-aware early flush, the
  request ships while it can still make its SLO;
- the scheduler is draining (no future arrivals remain): everything left
  must ship.

Among ready buckets the dispatcher launches the best ``fill + urgency``
score (fill = wave occupancy it would achieve, urgency = oldest wait or
deadline slack in units of ``flush_after``), tie-broken by oldest arrival
then tier key — no wall-clock or hash-order nondeterminism anywhere, which
is what makes scheduler runs replayable in tests and benchmarks.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Deque, Mapping

from repro_torch.scheduler.bucketing import GeometryTier
from repro_torch.scheduler.queue import PendingRequest


@dataclasses.dataclass(frozen=True)
class WavePlan:
    """Launch order for one wave of ``tier``'s geometry: pop the given
    number of oldest requests from each listed bucket (``takes`` is ordered
    ``(source_tier, count)``; sources other than ``tier`` are smaller-tier
    TOP-UPS — their requests fit the larger geometry, and riding a wave
    that is launching anyway beats waiting for their own bucket to fill)."""

    tier: GeometryTier
    takes: tuple[tuple[GeometryTier, int], ...]

    @property
    def count(self) -> int:
        return sum(c for _, c in self.takes)


@dataclasses.dataclass(frozen=True)
class Wait:
    """No bucket is ready; re-evaluate at ``until`` (earliest flush point)."""

    until: float


class ContinuousDispatcher:
    """Deterministic next-wave chooser over the geometry buckets.

    ``topup=True`` (default) fills a launching wave's spare slots with the
    globally-oldest requests from SMALLER tiers — they fit the larger
    geometry, so a wave that must launch anyway (flush, deadline, drain)
    leaves with maximal occupancy instead of empty slots. This is what lets
    bucketing win padding waste and tail latency simultaneously: small
    requests never wait on their own bucket when a larger wave is leaving.
    """

    def __init__(self, *, flush_after: float = 0.05, topup: bool = True):
        if flush_after <= 0:
            raise ValueError(f"flush_after must be > 0, got {flush_after}")
        self.flush_after = flush_after
        self.topup = topup

    def _urgency(self, oldest: PendingRequest, deadline: float | None,
                 now: float) -> float:
        """``deadline`` is the TIGHTEST deadline in the bucket, not the
        oldest request's — a younger request's SLO must pull the flush
        forward too."""
        wait = (now - oldest.arrival) / self.flush_after
        if deadline is not None and math.isfinite(self.flush_after):
            slack = deadline - now
            # slack <= flush_after ≡ urgency >= 1 (ready); overdue grows fast
            wait = max(wait, 2.0 - slack / self.flush_after)
        return wait

    def next_wave(
        self,
        buckets: Mapping[GeometryTier, Deque[PendingRequest]],
        now: float,
        *,
        draining: bool = False,
    ) -> WavePlan | Wait | None:
        """One scheduling decision. Returns a :class:`WavePlan` to launch, a
        :class:`Wait` when some bucket will become ready at a known future
        time, or None when every bucket is empty."""
        best = None         # (score, -arrival, -seq, tier) via explicit compare
        wait_until = math.inf
        tiers = sorted(buckets)                 # ascending geometry
        for i, tier in enumerate(tiers):
            q = buckets[tier]
            if not q:
                continue
            oldest = q[0]
            # achievable occupancy counts smaller-tier top-ups: the wave's
            # spare slots can carry any smaller-geometry request. Only a
            # tier with own pending requests is a launch candidate — no
            # request NEEDS a bigger geometry than its own tier.
            pool = len(q)
            if self.topup:
                pool += sum(len(buckets[t]) for t in tiers[:i])
            # the bucket's tightest deadline, wherever it sits in the queue
            # — a younger request's SLO pulls the flush forward too
            deadline = min((p.deadline for p in q if p.deadline is not None),
                           default=None)
            # readiness and the wait target MUST use the same arithmetic
            # (now >= flush_at), or float rounding can park the event loop
            # exactly on a flush point it never considers ready
            flush_at = oldest.arrival + self.flush_after
            if deadline is not None and math.isfinite(self.flush_after):
                flush_at = min(flush_at, deadline - self.flush_after)
            ready = pool >= tier.batch or now >= flush_at or draining
            if not ready:
                wait_until = min(wait_until, flush_at)
                continue
            urgency = self._urgency(oldest, deadline, now)
            fill = min(pool, tier.batch) / tier.batch
            score = fill + urgency
            cand = (score, -oldest.arrival, -oldest.seq, tier)
            if best is None or (cand[0], cand[1], cand[2]) > best[:3]:
                best = cand
        if best is not None:
            tier = best[3]
            return self._plan(buckets, tiers, tier)
        if math.isfinite(wait_until):
            return Wait(until=max(wait_until, now))
        return None

    def _plan(self, buckets, tiers, tier: GeometryTier) -> WavePlan:
        """Materialize the wave: the chosen tier's oldest requests first,
        spare slots topped up with the globally-oldest smaller-tier
        requests. The k oldest of arrival-sorted buckets are always bucket
        prefixes, so the plan is expressible as per-bucket pop counts."""
        own = min(len(buckets[tier]), tier.batch)
        takes = [(tier, own)]
        spare = tier.batch - own
        if spare > 0 and self.topup:
            smaller = [p for t in tiers if t < tier for p in buckets[t]]
            smaller.sort(key=lambda p: (p.arrival, p.seq))
            chosen = smaller[:spare]
            counts: dict[GeometryTier, int] = {}
            for p in chosen:
                counts[p.tier] = counts.get(p.tier, 0) + 1
            takes += [(t, counts[t]) for t in tiers if t in counts]
        return WavePlan(tier=tier, takes=tuple(takes))
