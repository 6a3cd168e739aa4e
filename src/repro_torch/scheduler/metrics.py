"""Serving metrics: throughput, latency percentiles, padding waste, compiles.

One :class:`ServeMetrics` instance accumulates per-wave and per-request
records over a scheduler run and reduces them to the numbers the benchmarks
compare:

- **throughput** — served requests per second of clock time between the
  first arrival and the last wave completion (a zero-width clock span —
  e.g. one request under a service model that never advances the clock —
  falls back to the summed wave service time instead of returning NaN);
- **p50/p99 latency** — request completion latency (finish − arrival), the
  continuous-batching headline number;
- **padding-waste ratio** — 1 − (real node rows) / (padded node-row capacity)
  over all executed waves (and the same for nnz slots): what the §IV-C
  pad-to-max policy costs, and what bucketing claws back;
- **compile count** — distinct wave programs built (tier engines, in the
  port), which must equal the number of geometry tiers used (the
  program-cache invariant).

Storage sits on a :class:`repro_torch.observability.MetricsRegistry`
instead of private lists: counts are registry counters, latency/wait
distributions are ``keep_samples`` histograms (p50/p99 stay sample-exact),
and wave service times land in a per-tier labeled histogram — so one
``registry.snapshot()``/``export_jsonl()`` carries the whole serve run.
Each instance defaults to its OWN registry (concurrent schedulers in one
process must not sum each other's counters); pass a shared ``registry``
plus a distinguishing ``labels`` dict to aggregate deliberately.
"""
from __future__ import annotations

import dataclasses

from repro_torch.observability.metrics import MetricsRegistry
from repro_torch.serving.engine import GraphWaveReport


@dataclasses.dataclass(frozen=True)
class WaveRecord:
    tier_key: str
    dispatch: float
    service_time: float
    report: GraphWaveReport


class ServeMetrics:
    def __init__(self, *, registry: MetricsRegistry | None = None,
                 labels: dict | None = None) -> None:
        self.registry = registry if registry is not None else \
            MetricsRegistry()
        self.labels = dict(labels or {})
        self.waves: list[WaveRecord] = []
        self.first_arrival: float | None = None
        self.last_finish: float | None = None
        self._c_requests = self.registry.counter(
            "serve_requests_total", "requests by outcome (served/rejected)")
        self._c_misses = self.registry.counter(
            "serve_deadline_misses_total", "served past their deadline")
        self._c_waves = self.registry.counter(
            "serve_waves_total", "executed waves per geometry tier")
        self._h_latency = self.registry.histogram(
            "serve_latency_seconds", "finish - arrival per served request",
            keep_samples=True)
        self._h_wait = self.registry.histogram(
            "serve_wait_seconds", "dispatch - arrival per served request",
            keep_samples=True)
        self._h_service = self.registry.histogram(
            "serve_wave_service_seconds", "wave service time per tier")
        self._g_compiles = self.registry.gauge(
            "serve_compile_count", "distinct wave programs built")

    # -- registry-backed views ----------------------------------------------
    @property
    def served(self) -> int:
        return int(self._c_requests.value(outcome="served", **self.labels))

    @property
    def rejected(self) -> int:
        return int(self._c_requests.value(outcome="rejected", **self.labels))

    @property
    def deadline_misses(self) -> int:
        return int(self._c_misses.value(**self.labels))

    @property
    def compile_count(self) -> int:
        v = self._g_compiles.value(**self.labels)
        return 0 if v != v else int(v)      # gauge is NaN until first set

    @compile_count.setter
    def compile_count(self, value: int) -> None:
        self._g_compiles.set(value, **self.labels)

    # -- recording ----------------------------------------------------------
    def record_wave(self, tier_key: str, dispatch: float,
                    service_time: float, report: GraphWaveReport) -> None:
        self.waves.append(WaveRecord(tier_key, dispatch, service_time,
                                     report))
        self._c_waves.inc(tier=tier_key, **self.labels)
        self._h_service.observe(service_time, tier=tier_key, **self.labels)

    def record_request(self, *, arrival: float, dispatch: float,
                       finish: float, deadline: float | None = None,
                       failed: bool = False) -> None:
        if self.first_arrival is None or arrival < self.first_arrival:
            self.first_arrival = arrival
        if self.last_finish is None or finish > self.last_finish:
            self.last_finish = finish
        if failed:
            self._c_requests.inc(outcome="rejected", **self.labels)
            return
        self._c_requests.inc(outcome="served", **self.labels)
        self._h_latency.observe(finish - arrival, **self.labels)
        self._h_wait.observe(dispatch - arrival, **self.labels)
        if deadline is not None and finish > deadline:
            self._c_misses.inc(**self.labels)

    def record_rejection(self, *, arrival: float) -> None:
        if self.first_arrival is None or arrival < self.first_arrival:
            self.first_arrival = arrival
        self._c_requests.inc(outcome="rejected", **self.labels)

    # -- reductions ---------------------------------------------------------
    def latency_percentile(self, p: float) -> float:
        return self._h_latency.percentile(p, **self.labels)

    @property
    def p50(self) -> float:
        return self.latency_percentile(50.0)

    @property
    def p99(self) -> float:
        return self.latency_percentile(99.0)

    @property
    def throughput(self) -> float:
        if (self.served == 0 or self.first_arrival is None
                or self.last_finish is None):
            return float("nan")
        span = self.last_finish - self.first_arrival
        if span <= 0:
            # zero-width clock span (e.g. ONE request whose finish stamps at
            # its arrival under a zero-cost service model): the wave service
            # time is the honest denominator, not NaN
            span = sum(w.service_time for w in self.waves)
        if span <= 0:
            return float("nan")
        return self.served / span

    @property
    def padding_waste_nodes(self) -> float:
        cap = sum(w.report.node_capacity for w in self.waves)
        real = sum(w.report.real_nodes for w in self.waves)
        return float("nan") if cap == 0 else 1.0 - real / cap

    @property
    def padding_waste_nnz(self) -> float:
        cap = sum(w.report.nnz_capacity for w in self.waves)
        real = sum(w.report.real_nnz for w in self.waves)
        return float("nan") if cap == 0 else 1.0 - real / cap

    @property
    def fill_rate(self) -> float:
        slots = sum(w.report.slots for w in self.waves)
        real = sum(w.report.n_requests - w.report.n_failed
                   for w in self.waves)
        return float("nan") if slots == 0 else real / slots

    def summary(self) -> dict:
        """Machine-readable rollup, the reference's keys."""
        n_wait = self._h_wait.count(**self.labels)
        return {
            "served": self.served,
            "rejected": self.rejected,
            "deadline_misses": self.deadline_misses,
            "waves": len(self.waves),
            "compile_count": self.compile_count,
            "throughput_rps": self.throughput,
            "latency_p50_s": self.p50,
            "latency_p99_s": self.p99,
            "mean_wait_s": (self._h_wait.sum(**self.labels) / n_wait
                            if n_wait else float("nan")),
            "padding_waste_nodes": self.padding_waste_nodes,
            "padding_waste_nnz": self.padding_waste_nnz,
            "fill_rate": self.fill_rate,
        }
