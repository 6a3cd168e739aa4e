"""Autotune regret auditor: predicted-vs-measured per (impl, workload-key)
and would-have-won alternatives (DESIGN.md §13).

``impl="auto"`` trusts a two-layer oracle — the analytic cost model, overlaid
by the measured tuning cache. Neither is audited anywhere once a decision
ships: a stale cache entry or a mis-calibrated roofline constant silently
taxes every dispatch. This module closes that loop:

- :meth:`RegretAuditor.audit` takes one workload plus its measured per-impl
  times (from ``autotune.cache.measure_workload`` or a tuning-cache record),
  replays the decision ``select_impl`` makes for that workload, and records
  *regret*: ``measured[chosen] / measured[best]`` — 1.0 means the dispatcher
  picked the measured winner, 1.4 means every call pays 40% over the
  would-have-won alternative.
- Per-impl **misprediction ratios** ``measured / predicted`` accumulate
  across workloads; a geometric mean far from 1.0 localizes which roofline
  branch is mis-calibrated (the constants are relative knobs — ordering is
  what matters, so only *spread* between impls is actionable, not a common
  scale factor).
- :meth:`RegretAuditor.record` is the online feed: the kernel-dispatch spans
  (``kernels/ops.py``, telemetry on) report (key, impl, predicted, measured
  wall) per dispatch — on the card the wall between two
  ``torch.cuda.synchronize()`` calls, so the kernel's own time is in it —
  and the scheduler reports each tier's waves after the first.

``report()`` rolls everything into one strict-JSON-able dict; entries whose
regret ratio exceeds ``flag_threshold`` land in ``flagged`` — the
deliberately mis-cached decision test asserts exactly that path.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.analysis.roofline import HW
from repro_torch.autotune.cost_model import Workload, estimate
from repro_torch.autotune.selector import select_impl

# a chosen impl measuring >20% over the measured best is a flagged decision:
# comfortably above timing jitter at the medians the cache stores, small
# enough to catch real cost-model inversions
FLAG_THRESHOLD = 1.2


@dataclasses.dataclass(frozen=True)
class RegretEntry:
    """One audited decision for one workload key."""

    key: str                    # Workload.key()
    chosen: str                 # what the dispatcher picked
    source: str                 # "model" | "cache" | "forced" | "span"
    best: str                   # measured winner among the candidates
    measured: dict              # impl -> measured seconds
    predicted: dict             # impl -> cost-model seconds
    regret_ratio: float         # measured[chosen] / measured[best]
    regret_s: float             # measured[chosen] - measured[best]

    @property
    def flagged(self) -> bool:
        return self.regret_ratio > FLAG_THRESHOLD

    def mispredictions(self) -> dict:
        """measured/predicted ratio per impl present in both maps."""
        out = {}
        for impl, m in self.measured.items():
            p = self.predicted.get(impl)
            if p and p > 0 and m > 0:
                out[impl] = m / p
        return out


class RegretAuditor:
    def __init__(self, *, hw: HW = HW(),
                 flag_threshold: float = FLAG_THRESHOLD):
        self.hw = hw
        self.flag_threshold = flag_threshold
        self.entries: list[RegretEntry] = []

    # -- feeds --------------------------------------------------------------
    def audit(self, w: Workload, times: dict, *,
              chosen: str | None = None, source: str | None = None,
              allow_pallas: bool = True, cache=None) -> RegretEntry:
        """Audit one workload against its measured per-impl ``times``.

        ``chosen=None`` replays the production decision — ``select_impl``
        with the SAME cache precedence the dispatcher uses, so a poisoned
        cache entry is audited as the decision it actually causes."""
        if not times:
            raise ValueError(f"workload {w.key()}: no measured times")
        if chosen is None:
            d = select_impl(w, allow_pallas=allow_pallas, cache=cache,
                            hw=self.hw)
            chosen, source = d.impl, d.source
        predicted = {}
        for impl in times:
            try:
                t = estimate(w, impl, self.hw)
            except ValueError:
                continue
            if t != float("inf"):
                predicted[impl] = t
        best = min(times, key=times.get)
        m_chosen = times.get(chosen)
        if m_chosen is None:
            # the chosen impl was never measured (e.g. case-3 forced ref on
            # a sweep that skipped it): regret vs best is unknowable — treat
            # the entry as maximally informative by flagging it
            m_chosen = float("inf")
        entry = RegretEntry(
            key=w.key(), chosen=chosen, source=source or "caller",
            best=best, measured=dict(times), predicted=predicted,
            regret_ratio=(m_chosen / times[best] if times[best] > 0
                          else float("inf")),
            regret_s=m_chosen - times[best])
        self.entries.append(entry)
        return entry

    def audit_cache(self, cache, workloads, *,
                    allow_pallas: bool = True) -> list[RegretEntry]:
        """Audit every ``workloads`` member that has a tuning-cache record:
        the cache's measured times vs the decision the cache+model produce.
        A record whose pinned ``best`` is NOT the measured argmin (stale or
        poisoned entry) comes out flagged."""
        out = []
        for w in workloads:
            times = cache.times(w.key())
            if not times:
                continue
            out.append(self.audit(w, times, allow_pallas=allow_pallas,
                                  cache=cache))
        return out

    def record(self, key: str, impl: str, *, predicted_s: float,
               measured_s: float) -> RegretEntry:
        """Online single-impl observation (the kernel-span feed): no
        alternatives were measured, so regret is definitionally 1.0 and the
        value is the measured/predicted calibration point."""
        entry = RegretEntry(
            key=key, chosen=impl, source="span", best=impl,
            measured={impl: measured_s}, predicted={impl: predicted_s},
            regret_ratio=1.0, regret_s=0.0)
        self.entries.append(entry)
        return entry

    # -- rollup -------------------------------------------------------------
    def per_impl_ratios(self) -> dict:
        """impl → {n, geomean} of measured/predicted across all entries."""
        logs: dict[str, list[float]] = {}
        for e in self.entries:
            for impl, r in e.mispredictions().items():
                logs.setdefault(impl, []).append(math.log(r))
        return {impl: {"n": len(ls),
                       "geomean_measured_over_predicted":
                           math.exp(sum(ls) / len(ls))}
                for impl, ls in sorted(logs.items())}

    def report(self, top: int = 10) -> dict:
        """The regret report (strict-JSON-able): flagged decisions, the top
        mispredictions, and per-impl calibration ratios."""
        flagged = [e for e in self.entries
                   if e.regret_ratio > self.flag_threshold]
        flagged.sort(key=lambda e: -e.regret_ratio)
        mis = []
        for e in self.entries:
            for impl, r in e.mispredictions().items():
                mis.append({"key": e.key, "impl": impl,
                            "measured_over_predicted": r})
        mis.sort(key=lambda d: -abs(math.log(
            d["measured_over_predicted"])))
        return {
            "n_entries": len(self.entries),
            "n_flagged": len(flagged),
            "flag_threshold": self.flag_threshold,
            "flagged": [{
                "key": e.key, "chosen": e.chosen, "source": e.source,
                "would_have_won": e.best,
                "regret_ratio": e.regret_ratio,
                "regret_s": e.regret_s,
            } for e in flagged[:top]],
            "top_mispredictions": mis[:top],
            "per_impl": self.per_impl_ratios(),
        }

    def format_report(self, top: int = 10) -> str:
        r = self.report(top)
        lines = [f"regret audit: {r['n_entries']} decision(s), "
                 f"{r['n_flagged']} flagged (> {r['flag_threshold']:.2f}x)"]
        for f in r["flagged"]:
            lines.append(
                f"  FLAG {f['key']}: chose {f['chosen']} ({f['source']}), "
                f"measured best {f['would_have_won']} — "
                f"{f['regret_ratio']:.2f}x / +{f['regret_s']:.2e}s per call")
        for impl, s in r["per_impl"].items():
            lines.append(
                f"  model {impl}: measured/predicted geomean "
                f"{s['geomean_measured_over_predicted']:.2f} "
                f"(n={s['n']})")
        return "\n".join(lines)


# Process-default auditor — the kernel-span feed reports here; benchmarks
# and tests construct their own for isolation.
AUDITOR = RegretAuditor()


def default_auditor() -> RegretAuditor:
    return AUDITOR
