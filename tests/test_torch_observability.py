"""Port parity: the telemetry layer (repro_torch.observability) against the
JAX reference's (repro.observability) on the CPU.

The same calls drive both packages' Tracer, MetricsRegistry and
RegretAuditor: the events (names, phases, tids, cats, args; timestamps the
caller gave), the snapshot rows, and the audit report are equal. The
port's hooks hold as the reference's tests hold them: a kernel span carries
its geometry and prediction and feeds the auditor, the disabled hook costs
under 5% of one CPU dispatch, a telemetry serve run nests scheduler → wave
→ kernel spans and exports strict JSON, and the trainer's metrics and
``telemetry=False`` behave as the reference's.
"""
import dataclasses
import json
import math
import time

import jax
import numpy as np
import pytest
import torch

from repro import observability as jobs
from repro import scheduler as jsched
from repro.autotune import TuningCache as JCache
from repro.autotune import Workload as JWorkload
from repro.core import batched_spmm as jbatched_spmm
from repro.core import gcn as jgcn
from repro.core import random_batch as jrandom_batch
from repro.data import graphs as jgraphs
from repro.observability import trace as jtrace
from repro.serving.engine import GraphRequest as JRequest
from repro_torch import observability as tobs
from repro_torch import scheduler as tsched
from repro_torch.autotune import TuningCache as TCache
from repro_torch.autotune import Workload as TWorkload
from repro_torch.convert import params_from_jax
from repro_torch.core import gcn as tgcn
from repro_torch.core.formats import BatchedCOO
from repro_torch.data.graphs import GraphDatasetSpec, batches, generate
from repro_torch.kernels import ops
from repro_torch.observability import trace as ttrace
from repro_torch.serving.engine import GraphRequest
from repro_torch.training.trainer import GCNTrainer, TrainerConfig

SPAN_ARG_KEYS = {"impl", "key", "batch", "m_pad", "nnz_pad", "k_pad", "n_b",
                 "dtype", "op", "reduce", "predicted_s", "predicted_bytes",
                 "source", "case"}


def _strict(text: str):
    def boom(tok):
        raise AssertionError(f"non-strict literal {tok}")

    return json.loads(text, parse_constant=boom)


def _batch(seed=0, batch=2, dim=16, nnz_per_row=2, n_b=8):
    """The same random batch for both packages: the reference's COO and
    the port's, and B."""
    rng = np.random.default_rng(seed)
    a, m_pad = jrandom_batch(rng, batch=batch, dim=dim,
                             nnz_per_row=nnz_per_row)
    b = rng.standard_normal((batch, m_pad, n_b)).astype(np.float32)
    ta = BatchedCOO(*(torch.from_numpy(np.asarray(x).copy()) for x in (
        a.row_ids, a.col_ids, a.values, a.nnz, a.n_rows)))
    return a, jax.numpy.asarray(b), ta, torch.from_numpy(b)


def _drive_tracer(pkg, capacity=64):
    """One script of calls on a fresh Tracer of ``pkg``: nested spans with
    args, caller-stamped complete spans, instants and counters, and enough
    events to wrap a small ring."""
    tr = pkg.Tracer(capacity=capacity)
    with tr.span("outer", cat="sched", args={"tier": "m16_nnz64_b4",
                                             "bad": float("nan")}):
        with tr.span("inner", args={"n": 3}, annotate=False):
            pass
    tr.complete("wave[m16]", ts=1.5, dur=0.25, cat="sched",
                args={"served": 4, "n_failed": 0})
    tr.complete("request", ts=1.0, dur=0.75, tid="requests", cat="sched",
                args={"inf": float("inf")})
    tr.instant("request/arrival", ts=0.5, cat="sched",
               args={"n_nodes": 7, "deadline": None})
    tr.counter("queue_depth", 3, ts=2.0, cat="sched")
    for i in range(64):
        tr.instant(f"tick{i}", ts=float(i))
    return tr


def _event_view(tr):
    """Everything but the wall-clock stamps of the ``span`` events."""
    out = []
    for e in tr.events():
        wall = e.name in ("outer", "inner")
        out.append((e.name, e.ph, e.tid, e.cat,
                    json.dumps(tobs.sanitize_json(e.args), sort_keys=True),
                    None if wall else (e.ts, e.dur)))
    return out


def test_tracer_events_and_export_match_reference(tmp_path):
    for capacity in (64, 200):
        tt, jt = _drive_tracer(tobs, capacity), _drive_tracer(jobs, capacity)
        assert _event_view(tt) == _event_view(jt)
        assert tt.dropped == jt.dropped
    assert tt.dropped == 0 and _drive_tracer(tobs, 64).dropped == 6
    tt, jt = _drive_tracer(tobs, 200), _drive_tracer(jobs, 200)
    names = [e.name for e in tt.events()]
    assert names.index("inner") < names.index("outer")   # inner ends first
    spans = {e.name: e for e in tt.events()}
    outer, inner = spans["outer"], spans["inner"]
    assert outer.ts <= inner.ts and \
        inner.ts + inner.dur <= outer.ts + outer.dur
    docs = []
    for tr, name in ((tt, "t.json"), (jt, "j.json")):
        doc = _strict(tr.export_chrome(tmp_path / name).read_text())
        for ev in doc["traceEvents"]:
            ev.pop("pid")
            if ev["name"] in ("outer", "inner"):
                ev.pop("ts"), ev.pop("dur")
        docs.append(doc)
    assert docs[0] == docs[1]
    outer = next(e for e in docs[0]["traceEvents"] if e["name"] == "outer")
    assert outer["args"]["bad"] is None                  # NaN → null
    assert tobs.sanitize_json({"a": [float("nan"), -math.inf, 1.0]}) == \
        jobs.sanitize_json({"a": [float("nan"), -math.inf, 1.0]}) == \
        {"a": [None, None, 1.0]}


def test_telemetry_gate_matches_reference(monkeypatch):
    for value, want in (("1", True), ("off", False), (" YES ", True)):
        monkeypatch.setenv(ttrace.ENV_VAR, value)
        assert ttrace._env_default() == jtrace._env_default() == want
    monkeypatch.setenv(ttrace.ENV_VAR, "maybe")
    for mod in (ttrace, jtrace):
        with pytest.raises(ValueError, match="REPRO_TELEMETRY"):
            mod._env_default()
    monkeypatch.delenv(ttrace.ENV_VAR)
    assert ttrace._env_default() is False
    assert ttrace.ENV_VAR == jtrace.ENV_VAR
    prev = tobs.enabled()
    with tobs.telemetry():
        assert tobs.enabled()
        with tobs.telemetry(False):
            assert not tobs.enabled()
            assert tobs.span("x") is ttrace._NULL    # the shared null
        assert tobs.span("x") is not ttrace._NULL
    assert tobs.enabled() == prev
    tobs.set_enabled(True)
    assert tobs.enabled()
    tobs.set_enabled(prev)


def _drive_registry(pkg):
    reg = pkg.MetricsRegistry()
    c = reg.counter("requests_total", "by outcome")
    c.inc(outcome="served")
    c.inc(2.0, outcome="served")
    c.inc(outcome="rejected", instance="a")
    with pytest.raises(ValueError, match="negative"):
        c.inc(-1.0)
    g = reg.gauge("loss")
    g.set(0.5, impl="fused")
    g.add(0.25, impl="fused")
    g.add(1.0, impl="coo")
    reg.gauge("never_set").set(float("nan"))
    h = reg.histogram("latency_seconds", keep_samples=True)
    for v in (1e-6, 1e-5, 3e-5, 0.01, 0.5, 2.0, 500.0):
        h.observe(v, tier="m16")
    h2 = reg.histogram("sizes", buckets=(1.0, 2.0, 4.0))
    for v in (0.5, 1.0, 1.5, 4.0, 9.0):
        h2.observe(v)
    assert reg.counter("requests_total") is c        # same name shares
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("requests_total")
    with pytest.raises(ValueError, match="ascending"):
        reg.histogram("bad", buckets=(2.0, 1.0))
    stats = [c.value(outcome="served"), c.total(),
             g.value(impl="fused"), g.value(impl="none"),
             h.count(tier="m16"), h.sum(tier="m16"),
             h.percentile(50, tier="m16"), h.percentile(99, tier="m16"),
             h2.percentile(50), h2.percentile(99), h.percentile(50)]
    return reg, stats


def test_registry_snapshot_and_export_match_reference(tmp_path):
    (treg, tstats), (jreg, jstats) = _drive_registry(tobs), \
        _drive_registry(jobs)
    assert json.dumps(tobs.sanitize_json(tstats)) == \
        json.dumps(jobs.sanitize_json(jstats))
    assert treg.names() == jreg.names()
    assert json.dumps(tobs.sanitize_json(treg.snapshot())) == \
        json.dumps(jobs.sanitize_json(jreg.snapshot()))
    assert tobs.DEFAULT_TIME_BUCKETS == jobs.DEFAULT_TIME_BUCKETS
    tp = treg.export_jsonl(tmp_path / "t.jsonl", extra={"run": "x"})
    jp = jreg.export_jsonl(tmp_path / "j.jsonl", extra={"run": "x"})
    assert tp.read_text() == jp.read_text()
    lines = [_strict(ln) for ln in tp.read_text().splitlines()]
    assert lines[0] == {"type": "meta", "run": "x"}
    assert {ln["metric"]: ln for ln in lines[1:]}["never_set"]["value"] \
        is None
    assert tobs.default_registry() is tobs.REGISTRY


def _record_stream(pkg):
    aud = pkg.RegretAuditor()
    rng = np.random.default_rng(7)
    for i in range(30):
        impl = ("fused", "pallas_coo", "ref")[i % 3]
        pred = float(rng.uniform(1e-5, 1e-3))
        aud.record(f"b{i % 4}_m56", impl, predicted_s=pred,
                   measured_s=pred * float(rng.uniform(0.2, 40.0)))
    return aud


def test_regret_report_matches_reference_from_one_record_stream():
    taud, jaud = _record_stream(tobs), _record_stream(jobs)
    assert taud.per_impl_ratios() == jaud.per_impl_ratios()
    assert taud.report() == jaud.report()
    assert taud.report(top=3) == jaud.report(top=3)
    assert taud.format_report() == jaud.format_report()
    assert set(taud.per_impl_ratios()) == {"fused", "pallas_coo", "ref"}
    assert tobs.default_auditor() is tobs.AUDITOR
    assert tobs.RegretEntry is tobs.RegretAuditor().record(
        "k", "ref", predicted_s=1.0, measured_s=2.0).__class__


def test_audit_cache_flags_the_same_poisoned_record(tmp_path):
    """One cache file, whose record pins a measured loser as ``best``:
    each package reads it, replays the cache-driven decision and flags it
    with the same would-have-won impl and ratio."""
    path = tmp_path / "tune.json"
    shape = dict(batch=4, m_pad=16, nnz_pad=64, k_pad=4, n_b=8)
    key = JWorkload(**shape).key()
    assert TWorkload(**shape).key() == key
    clean = JWorkload(batch=8, m_pad=16, nnz_pad=64, k_pad=4, n_b=8)
    path.write_text(json.dumps({"version": 1, "records": {
        key: {"best": "ref", "interpret": True,
              "times": {"ref": 5e-4, "csr": 1e-4, "dense": 2e-4}},
        clean.key(): {"best": "csr", "interpret": True,
                      "times": {"ref": 5e-4, "csr": 1e-4}}}}))
    out = []
    for pkg, cache, wl in ((tobs, TCache, TWorkload),
                           (jobs, JCache, JWorkload)):
        aud = pkg.RegretAuditor()
        entries = aud.audit_cache(
            cache(str(path)),
            [wl(**shape), wl(**dataclasses.asdict(clean)),
             wl(batch=2, m_pad=16, nnz_pad=64, k_pad=4, n_b=8)],
            allow_pallas=False)
        rep = aud.report()
        json.dumps(pkg.sanitize_json(rep), allow_nan=False)
        out.append(([(e.key, e.chosen, e.source, e.best, e.regret_ratio,
                      e.flagged) for e in entries],
                    rep["n_flagged"], rep["flagged"]))
    assert out[0] == out[1]
    (poisoned, clean_e), n_flagged, flagged = out[0]
    assert poisoned[1:] == ("ref", "cache", "csr", pytest.approx(5.0), True)
    assert not clean_e[-1] and n_flagged == 1
    assert flagged[0]["would_have_won"] == "csr"


def test_kernel_span_carries_geometry_and_prediction_as_the_reference():
    """``batched_spmm`` under telemetry: one ``spmm/{impl}`` span whose
    args are the reference's (the prediction and the planner's case are
    the port's own), one auditor record; a g-SpMM dispatch spans too."""
    ja, jb, ta, tb = _batch(seed=0)
    tobs.TRACER.clear()
    jobs.TRACER.clear()
    aud = tobs.default_auditor()
    n0 = len(aud.entries)
    with tobs.telemetry(), jobs.telemetry():
        c = ops.batched_spmm(ta, tb, impl="csr")
        jbatched_spmm(ja, jb, impl="csr")
        g = ops.batched_gspmm(ta, tb, op="add", reduce="max", impl="auto")
    with tobs.telemetry(False):
        torch.testing.assert_close(c, ops.batched_spmm(ta, tb, impl="csr"),
                                   rtol=0, atol=0)
        torch.testing.assert_close(
            g, ops.batched_gspmm(ta, tb, op="add", reduce="max",
                                 impl="auto"), rtol=0, atol=0)
    tev = [e for e in tobs.TRACER.events() if e.cat == "kernel"]
    jev = [e for e in jobs.TRACER.events() if e.name.startswith("spmm/")]
    assert [e.name for e in tev] == ["spmm/csr", f"spmm/{tev[1].args['impl']}"]
    targs, jargs = dict(tev[0].args), dict(jev[0].args)
    assert set(targs) == set(jargs) == SPAN_ARG_KEYS
    for k in ("predicted_s", "case"):
        targs.pop(k), jargs.pop(k)
    assert targs == jargs
    assert tev[0].args["predicted_s"] > 0 and tev[0].args["source"] == \
        "forced"
    assert tev[1].args["op"] == "add" and tev[1].args["reduce"] == "max"
    assert tev[1].args["source"] == "model"
    new = aud.entries[n0:]
    assert [e.chosen for e in new] == [e.args["impl"] for e in tev]
    assert all(e.source == "span" and e.regret_ratio == 1.0 for e in new)
    assert new[0].key == tev[0].args["key"]
    tobs.TRACER.clear()
    jobs.TRACER.clear()


def test_disabled_telemetry_overhead_under_5pct_of_a_dispatch():
    """With telemetry off the per-dispatch hook (one predicate, the shared
    null context) costs under 5% of one port ``batched_spmm(impl="csr")``
    dispatch on the CPU, and records nothing."""
    tobs.set_enabled(False)
    _, _, ta, tb = _batch(seed=2, batch=4, dim=32, nnz_per_row=2, n_b=16)
    n_ev, n_aud = len(tobs.TRACER.events()), len(tobs.default_auditor()
                                                 .entries)
    ops.batched_spmm(ta, tb, impl="csr")
    ts = []
    for _ in range(30):
        t0 = time.perf_counter()
        ops.batched_spmm(ta, tb, impl="csr")
        ts.append(time.perf_counter() - t0)
    dispatch_s = float(np.median(ts))
    n = 2000
    t0 = time.perf_counter()
    for _ in range(n):
        with tobs.span("x"):
            pass
        tobs.enabled()
    hook_s = (time.perf_counter() - t0) / n
    assert hook_s < 0.05 * dispatch_s, (hook_s, dispatch_s)
    assert len(tobs.TRACER.events()) == n_ev
    assert len(tobs.default_auditor().entries) == n_aud


def _serve_setup(n=6):
    spec = jgraphs.GraphDatasetSpec.tox21_like(
        n_samples=n, n_features=8, channels=2, seed=3)
    data = jgraphs.generate(spec)
    jcfg = jgcn.GCNConfig(n_features=8, channels=2, conv_widths=(8,),
                          n_tasks=3, impl="ref")
    np_params = jax.tree.map(np.asarray, jgcn.init_gcn(jax.random.key(0),
                                                       jcfg))
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(tgcn.GCNConfig)}
    pcfg = tgcn.GCNConfig(**fields)
    geoms = [(s.n_nodes, max(len(r) for r in s.rows)) for s in data]
    return data, jcfg, np_params, pcfg, geoms


def _reqs(cls, data):
    return [cls(rows=list(s.rows), cols=list(s.cols), features=s.features,
                n_nodes=s.n_nodes) for s in data]


def test_scheduler_lifecycle_trace_matches_reference():
    """A VirtualClock serve under a fixed service model: the scheduler's
    lifecycle events (arrivals, admits, queue depths, wave and request
    spans on the clock tracks) and the wall spans' names and args are the
    reference's, event for event."""
    data, jcfg, np_params, pcfg, geoms = _serve_setup(8)
    arrivals = [0.0, 0.0, 0.01, 0.02, 0.2, 0.2, 0.21, 0.5]

    def run(pkg, params, cfg, **kw):
        pkg_obs = tobs if pkg is tsched else jobs
        pkg_obs.TRACER.clear()
        sched = pkg.Scheduler(
            params, cfg, clock=pkg.VirtualClock(),
            tiers=pkg.TierPolicy.from_requests(geoms, levels=2, batch=4),
            service_model=lambda tier, n: 1e-3 * tier.m_pad / 16,
            config=pkg.SchedulerConfig(flush_after=0.05, default_slo=0.03),
            **kw)
        sched.serve(_reqs(GraphRequest if pkg is tsched else JRequest, data),
                    arrivals=arrivals)
        evs = [(e.name, e.ph, e.tid, e.cat,
                json.dumps(pkg_obs.sanitize_json(e.args), sort_keys=True),
                None if e.tid not in ("clock", "requests") else (e.ts, e.dur))
               for e in pkg_obs.TRACER.events() if e.cat != "kernel"]
        pkg_obs.TRACER.clear()
        return evs

    tev = run(tsched, params_from_jax(np_params, pcfg, device="cpu"), pcfg,
              device="cpu")
    jev = run(jsched, jax.tree.map(jax.numpy.asarray, np_params), jcfg)
    assert tev == jev
    names = {e[0] for e in tev}
    assert {"request/arrival", "request/admit", "request", "queue_depth",
            "sched/wave", "serve/wave"} <= names
    assert any(e[0].startswith("wave[") for e in tev)


def test_telemetry_serve_run_nests_spans_and_exports_strict_json(tmp_path):
    """Telemetry on, ``pallas_coo`` (the stacked SpMM dispatches through
    ``batched_spmm``): every ``serve/wave`` lies inside a ``sched/wave``,
    every kernel span inside a ``serve/wave``, the Chrome export is strict
    JSON and the regret report has per-impl ratios."""
    data, _, np_params, pcfg, geoms = _serve_setup()
    pcfg = dataclasses.replace(pcfg, impl="pallas_coo")
    params = params_from_jax(np_params, pcfg, device="cpu")
    tobs.TRACER.clear()
    aud = tobs.default_auditor()
    n0 = len(aud.entries)
    with tobs.telemetry():
        sched = tsched.Scheduler(
            params, pcfg, clock=tsched.VirtualClock(), device="cpu",
            tiers=tsched.TierPolicy.from_requests(geoms, levels=1, batch=4))
        out = sched.serve(_reqs(GraphRequest, data))
    assert all(r.done and not r.failed for r in out)
    evs = tobs.TRACER.events()
    sched_spans = [e for e in evs if e.name == "sched/wave"]
    wave_spans = [e for e in evs if e.name == "serve/wave"]
    kern_spans = [e for e in evs if e.name.startswith("spmm/")]
    assert len(sched_spans) == len(wave_spans) == len(sched.metrics.waves)
    assert len(kern_spans) == len(wave_spans)        # one conv layer

    def contains(outer, inner):
        return (outer.ts <= inner.ts
                and inner.ts + inner.dur <= outer.ts + outer.dur)

    assert all(any(contains(s, w) for s in sched_spans) for w in wave_spans)
    assert all(any(contains(w, k) for w in wave_spans) for k in kern_spans)
    assert {k.args["impl"] for k in kern_spans} == {"pallas_coo"}
    assert wave_spans[0].args["impl"] == "pallas_coo"
    path = tobs.export_chrome_trace(tmp_path / "trace.json")
    doc = _strict(path.read_text())
    assert len(doc["traceEvents"]) == len(evs)
    assert doc["otherData"] == {"dropped_events": 0}
    rep = aud.report()
    assert len(aud.entries) > n0 and "pallas_coo" in rep["per_impl"]
    json.dumps(tobs.sanitize_json(rep), allow_nan=False)
    tobs.TRACER.clear()


def _train_data(n):
    spec = GraphDatasetSpec.tox21_like(n_samples=n, n_features=8,
                                       channels=2, seed=4)
    return spec, generate(spec)


TRAIN_METRICS = ["train_accuracy", "train_grad_norm", "train_graphs_per_s",
                 "train_loss", "train_step_seconds", "train_steps_total"]


def test_trainer_metrics_hooks(tmp_path):
    """Steps counted, timed and spanned; gauges synced every ``log_every``
    steps and at the epoch's end, labelled ``{layer, impl}``."""
    spec, data = _train_data(12)
    cfg = tgcn.GCNConfig(n_features=8, channels=2, conv_widths=(8,),
                         n_tasks=12, impl="pallas_coo")
    reg = tobs.MetricsRegistry()
    trainer = GCNTrainer(
        cfg, tcfg=TrainerConfig(str(tmp_path), checkpoint_every=1000,
                                log_every=2),
        registry=reg, device="cpu")
    assert reg.names() == TRAIN_METRICS
    tobs.TRACER.clear()
    synced = []
    loss_gauge = reg.get("train_loss")
    orig = loss_gauge.set
    loss_gauge.set = lambda v, **kw: (synced.append(v), orig(v, **kw))
    _, _, last = trainer.fit(lambda e: batches(data, spec, 4, seed=e),
                             epochs=1)
    labels = {"layer": "gcn", "impl": "pallas_coo"}
    assert reg.get("train_steps_total").value(**labels) == 3   # 12 / 4
    assert reg.get("train_step_seconds").count(**labels) == 3
    assert len(synced) == 2                      # step 2, then epoch end
    assert reg.get("train_loss").value(**labels) == last["loss"]
    assert np.isfinite(last["loss"]) and last["grad_norm"] > 0
    assert reg.get("train_grad_norm").value(**labels) == last["grad_norm"]
    assert reg.get("train_graphs_per_s").value(**labels) > 0
    steps = [e for e in tobs.TRACER.events() if e.name == "train/step"]
    assert [e.args for e in steps] == [{"step": i, **labels}
                                       for i in (1, 2, 3)]
    assert TrainerConfig("x").log_every == 10
    tobs.TRACER.clear()


def test_trainer_telemetry_opt_out(tmp_path):
    spec, data = _train_data(4)
    cfg = tgcn.GCNConfig(n_features=8, channels=2, conv_widths=(8,),
                         n_tasks=12, impl="csr")
    reg = tobs.MetricsRegistry()
    tobs.TRACER.clear()
    GCNTrainer(cfg, tcfg=TrainerConfig(str(tmp_path), checkpoint_every=1000),
               registry=reg, telemetry=False, device="cpu").fit(
        lambda e: batches(data, spec, 4, seed=e), epochs=1)
    assert reg.get("train_steps_total").total() == 0
    assert reg.get("train_step_seconds").count(layer="gcn", impl="csr") == 0
    assert not any(e.name == "train/step" for e in tobs.TRACER.events())
    assert GCNTrainer(cfg, tcfg=TrainerConfig(str(tmp_path)),
                      device="cpu").registry is tobs.default_registry()


def test_reference_import_surface():
    assert sorted(tobs.__all__) == sorted(jobs.__all__)
    for name in jobs.__all__:
        assert hasattr(tobs, name), name
    with pytest.raises(AttributeError):
        tobs.no_such_name
