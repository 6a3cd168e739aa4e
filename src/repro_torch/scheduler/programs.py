"""Per-tier program cache: each wave geometry gets one engine, built once.

Every :class:`~repro_torch.scheduler.bucketing.GeometryTier` maps to one
:class:`~repro_torch.serving.engine.GraphServeEngine` at the tier's
geometry: the port's counterpart of the reference's one jitted program
per tier. The port runs eagerly, so a tier's "compilation" is what its
first wave pays: the kernel libraries its impls launch are built (``nvcc``,
once per process) and loaded, and their plans fixed by the tier's shapes.
The cache also records the layer decision (``repro_torch.autotune`` via
``engine.layer_decision()``) the tier's wave workload resolves to, so ops
can audit WHICH kernel each geometry runs without re-deriving it.
``compile_count`` is the invariant the metrics module surfaces: number of
programs == number of tiers actually used.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.scheduler.bucketing import GeometryTier
from repro_torch.serving.engine import GraphServeEngine


@dataclasses.dataclass
class TierProgram:
    """One tier's executor + its audited autotune layer decision."""

    tier: GeometryTier
    engine: GraphServeEngine
    decision: object            # repro_torch.autotune.Decision of the tier
    warmed: bool = False

    def warm(self) -> None:
        """Pay the tier's first-wave costs now: one empty wave (all slots
        empty, at the full geometry) launches every kernel the tier runs,
        so their libraries are built and loaded before any timed wave.
        Idempotent — repeated warms don't re-execute."""
        if not self.warmed:
            self.engine.run_wave([])
            self.warmed = True


class ProgramCache:
    """Lazy tier → TierProgram map; ``factory(tier)`` builds the engine."""

    def __init__(self, factory: Callable[[GeometryTier], GraphServeEngine]):
        self._factory = factory
        self._programs: dict[GeometryTier, TierProgram] = {}

    def get(self, tier: GeometryTier) -> TierProgram:
        prog = self._programs.get(tier)
        if prog is None:
            engine = self._factory(tier)
            prog = TierProgram(tier=tier, engine=engine,
                               decision=engine.layer_decision())
            self._programs[tier] = prog
        return prog

    @property
    def compile_count(self) -> int:
        """Distinct wave programs (tier engines) — equals the number of
        geometry tiers that have served (or been warmed)."""
        return len(self._programs)

    def tiers(self) -> tuple[GeometryTier, ...]:
        return tuple(sorted(self._programs))

    def decisions(self) -> dict[str, object]:
        """tier key → autotune Decision, for audit/metrics."""
        return {t.key: p.decision for t, p in self._programs.items()}

    def jit_cache_sizes(self) -> dict[str, int]:
        """tier key → entries in the tier engine's jit cache, the
        reference's one-compilation-per-tier check. Tiers whose engine
        cannot report a count are omitted rather than guessed; the port's
        engines run eagerly and report none, so this is ``{}``."""
        sizes = {t.key: p.engine.compiled_programs()
                 for t, p in self._programs.items()}
        return {k: v for k, v in sizes.items() if v is not None}
