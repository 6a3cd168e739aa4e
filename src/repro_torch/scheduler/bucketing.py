"""Geometry-tier bucketing: stop 10-node molecules paying 50-node padding.

The paper's §IV-C pad-to-max policy gives every wave one geometry — but
ONE global (m_pad, nnz_pad) geometry means every small graph pays the worst
case. The bucketing policy quantizes request geometry onto a small ladder
of :class:`GeometryTier`s (derived through the same ``core/batching``
rounding the :class:`~repro_torch.core.batching.BatchPlan` constructors
use), so each wave still runs one fixed geometry — now per TIER, one engine
and one set of kernel plans each — while small molecules ride
small-geometry waves.

A request is assigned the SMALLEST tier that fits both its node count and its
largest per-channel edge count; anything too big for the top rung has no
bucket (``tier_for`` returns None) and the scheduler rejects it cleanly
instead of killing a wave.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.batching import SUBLANES, _round_up, tier_ladder
from repro_torch.serving.engine import GraphRequest


@dataclasses.dataclass(frozen=True, order=True)
class GeometryTier:
    """One wave geometry: every wave of this tier runs the SAME engine at
    the same shapes (``batch`` slots × ``m_pad`` node rows × ``nnz_pad``
    COO slots per channel), so the tier is also the program-cache key."""

    m_pad: int
    nnz_pad: int
    batch: int

    def fits(self, n_nodes: int, max_nnz: int) -> bool:
        return n_nodes <= self.m_pad and max_nnz <= self.nnz_pad

    @property
    def key(self) -> str:
        return f"m{self.m_pad}_nnz{self.nnz_pad}_b{self.batch}"


class TierPolicy:
    """The tier ladder plus the assignment rule (smallest fitting rung).

    ``m_pads``/``nnz_pads`` are parallel ladders — rung i is
    ``(m_pads[i], nnz_pads[i])`` — normally produced by
    :func:`repro_torch.core.batching.tier_ladder` from the dataset maxima.
    """

    def __init__(self, *, m_pads=(16, 32, 56), nnz_pads=(64, 128, 256),
                 batch: int = 32):
        if len(m_pads) != len(nnz_pads):
            raise ValueError(
                f"parallel ladders required: {len(m_pads)} m_pads vs "
                f"{len(nnz_pads)} nnz_pads")
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        rungs = sorted(
            {(_round_up(m, SUBLANES), _round_up(nz, 8))
             for m, nz in zip(m_pads, nnz_pads)})
        for (m0, z0), (m1, z1) in zip(rungs, rungs[1:]):
            if z1 < z0:
                # wave top-up assumes any smaller-tier request also fits a
                # bigger tier — that needs BOTH dims monotone up the ladder
                raise ValueError(
                    f"non-monotone ladder: rung ({m1}, {z1}) has smaller "
                    f"nnz_pad than rung ({m0}, {z0})")
        self.tiers: tuple[GeometryTier, ...] = tuple(
            GeometryTier(m_pad=m, nnz_pad=nz, batch=batch)
            for m, nz in rungs)

    @staticmethod
    def for_sizes(*, m_max: int, nnz_max: int, levels: int = 3,
                  batch: int = 32) -> "TierPolicy":
        """Ladder halving down from the dataset maxima (``tier_ladder``)."""
        rungs = tier_ladder(m_max=m_max, nnz_max=nnz_max, levels=levels)
        return TierPolicy(m_pads=[m for m, _ in rungs],
                          nnz_pads=[nz for _, nz in rungs], batch=batch)

    @staticmethod
    def from_requests(geometries, *, levels: int = 3,
                      batch: int = 32) -> "TierPolicy":
        """Data-driven ladder from observed ``(n_nodes, max_nnz)`` pairs
        (e.g. a calibration sample of the traffic): m rungs halve down from
        the observed max, and each rung's nnz_pad is the LARGEST nnz among
        requests that fit the rung's node count — so the nnz dimension never
        bounces a request to a bigger tier than its node count demands
        (node count and edge count are strongly correlated in molecular
        graphs; the paper's Table I degree bound makes nnz ≈ O(nodes))."""
        geoms = list(geometries)
        if not geoms:
            raise ValueError("need at least one (n_nodes, max_nnz) sample")
        m_max = max(n for n, _ in geoms)
        nnz_max = max(z for _, z in geoms)
        rungs = tier_ladder(m_max=m_max, nnz_max=nnz_max, levels=levels,
                            nnz_min=8)
        m_pads = [m for m, _ in rungs]
        nnz_pads = []
        for m in m_pads:
            fits = [z for n, z in geoms if n <= m]
            nnz_pads.append(_round_up(max(fits, default=8), 8))
        return TierPolicy(m_pads=m_pads, nnz_pads=nnz_pads, batch=batch)

    @staticmethod
    def single(*, m_pad: int, nnz_pad: int, batch: int = 32) -> "TierPolicy":
        """Degenerate one-rung policy: the fixed-wave baseline geometry."""
        return TierPolicy(m_pads=(m_pad,), nnz_pads=(nnz_pad,), batch=batch)

    def tier_for(self, n_nodes: int, max_nnz: int) -> GeometryTier | None:
        """Smallest tier fitting (n_nodes, max_nnz); None when even the top
        rung is too small (the scheduler rejects such requests cleanly)."""
        for t in self.tiers:
            if t.fits(n_nodes, max_nnz):
                return t
        return None

    def assign(self, request: GraphRequest) -> GeometryTier | None:
        return self.tier_for(request.n_nodes, request.max_nnz)
