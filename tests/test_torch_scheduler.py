"""Port parity: the continuous-batching scheduler (repro_torch.scheduler)
against the JAX reference's (repro.scheduler) on the CPU.

The same numpy requests, arrival times and service model go through both
packages: the tier ladders and policies, the dispatcher's plans, the waves
a VirtualClock run composes (tier, requests, dispatch and finish times) and
``metrics.summary()`` are equal; logits agree within tests/oracle.py
TOLS["f32"]; and the port's own invariants (bitwise wave-composition
invariance on the CPU, per-request soft failures, ``fixed_wave``, the
RealClock) hold as the reference's tests hold them.
"""
import collections
import dataclasses
import functools
import math

import jax
import numpy as np
import pytest
import torch

from oracle import TOLS
from repro.core import batching as jbatching
from repro.core import gcn as jgcn
from repro.data import graphs as jgraphs
from repro import scheduler as jsched
from repro.serving.engine import GraphRequest as JRequest
from repro_torch.convert import params_from_jax
from repro_torch.core import batching as tbatching
from repro_torch.core import gcn as tgcn
from repro_torch import scheduler as tsched
from repro_torch.scheduler import scheduler as tsched_mod
from repro_torch.serving.engine import GraphRequest, GraphServeEngine

ATOL, RTOL = TOLS["f32"]


@functools.lru_cache(maxsize=None)
def _setup(impl: str = "ref"):
    """(data, reference cfg, reference params, port cfg, port params): a
    small ChemGCN (8 features, 2 channels, one 8-wide conv layer) over 24
    skewed Tox21-like molecules, the port's weights copied from the
    reference's seed-0 draw."""
    spec = jgraphs.GraphDatasetSpec.tox21_like(
        n_samples=24, n_features=8, channels=2, size_dist="skewed", seed=1)
    data = jgraphs.generate(spec)
    jcfg = jgcn.GCNConfig(n_features=8, channels=2, conv_widths=(8,),
                          n_tasks=3, impl=impl)
    np_params = jax.tree.map(np.asarray, jgcn.init_gcn(jax.random.key(0),
                                                       jcfg))
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(tgcn.GCNConfig)}
    pcfg = tgcn.GCNConfig(**fields)
    return data, jcfg, np_params, pcfg, params_from_jax(np_params, pcfg,
                                                        device="cpu")


def _reqs(cls, data):
    return [cls(rows=list(s.rows), cols=list(s.cols), features=s.features,
                n_nodes=s.n_nodes) for s in data]


def _geoms(data):
    return [(s.n_nodes, max(len(r) for r in s.rows)) for s in data]


def _jax_params(np_params):
    return jax.tree.map(jax.numpy.asarray, np_params)


def _same(a, b) -> bool:
    """Equal, NaN equal to NaN."""
    if isinstance(a, float) and isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or a == b
    return a == b


def _run_both(policy_kw, *, arrivals=None, deadlines=None, config=None,
              service=None, impl="ref", n=None, data_fn=None):
    """One VirtualClock serve of the same stream in both packages; returns
    (reference scheduler, port scheduler, reference requests, port
    requests)."""
    data, jcfg, np_params, pcfg, tparams = _setup(impl)
    data = data if n is None else data[:n]
    jpol = (jsched.TierPolicy.from_requests(_geoms(data), **policy_kw)
            if "m_pads" not in policy_kw
            else jsched.TierPolicy(**policy_kw))
    tpol = (tsched.TierPolicy.from_requests(_geoms(data), **policy_kw)
            if "m_pads" not in policy_kw
            else tsched.TierPolicy(**policy_kw))
    jreqs = data_fn(JRequest) if data_fn else _reqs(JRequest, data)
    treqs = data_fn(GraphRequest) if data_fn else _reqs(GraphRequest, data)
    kw = dict(arrivals=arrivals, deadlines=deadlines)
    js = jsched.Scheduler(
        _jax_params(np_params), jcfg, tiers=jpol, clock=jsched.VirtualClock(),
        service_model=service,
        config=None if config is None else jsched.SchedulerConfig(**config))
    js.serve(jreqs, **kw)
    ts = tsched.Scheduler(
        tparams, pcfg, tiers=tpol, clock=tsched.VirtualClock(),
        service_model=service, device="cpu",
        config=None if config is None else tsched.SchedulerConfig(**config))
    ts.serve(treqs, **kw)
    return js, ts, jreqs, treqs


def _waves(sched):
    """The run's composition: every completed request in completion order
    with the tier it rode and its dispatch and finish times."""
    return [(p.seq, None if p.served_tier is None else p.served_tier.key,
             p.dispatch, p.finish, p.request.failed, p.request.error)
            for p in sched.completed]


# ---------------------------------------------------------------------------
# pure policy pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("levels", (1, 2, 3, 5))
def test_tier_ladder_and_policies_match_reference(levels):
    for m_max in (1, 7, 16, 50, 56, 131):
        for nnz_max in (1, 30, 64, 300, 1000):
            for kw in ({}, {"m_min": 8, "nnz_min": 8}):
                assert tbatching.tier_ladder(
                    m_max=m_max, nnz_max=nnz_max, levels=levels, **kw) == \
                    jbatching.tier_ladder(m_max=m_max, nnz_max=nnz_max,
                                          levels=levels, **kw)
            for batch in (1, 4, 32):
                tp = tsched.TierPolicy.for_sizes(
                    m_max=m_max, nnz_max=nnz_max, levels=levels, batch=batch)
                jp = jsched.TierPolicy.for_sizes(
                    m_max=m_max, nnz_max=nnz_max, levels=levels, batch=batch)
                assert [dataclasses.astuple(t) for t in tp.tiers] == \
                    [dataclasses.astuple(t) for t in jp.tiers]
    rng = np.random.default_rng(levels)
    geoms = [(int(n), int(2.5 * n + rng.integers(0, 10)))
             for n in rng.integers(1, 60, 200)]
    tp = tsched.TierPolicy.from_requests(geoms, levels=levels, batch=8)
    jp = jsched.TierPolicy.from_requests(geoms, levels=levels, batch=8)
    assert [t.key for t in tp.tiers] == [t.key for t in jp.tiers]
    for n, z in geoms + [(200, 3), (3, 5000)]:
        tt, jt = tp.tier_for(n, z), jp.tier_for(n, z)
        assert (tt and tt.key) == (jt and jt.key)
    tone = tsched.TierPolicy.single(m_pad=50, nnz_pad=250, batch=4)
    assert [t.key for t in tone.tiers] == [
        t.key for t in jsched.TierPolicy.single(m_pad=50, nnz_pad=250,
                                                batch=4).tiers]
    with pytest.raises(ValueError, match="non-monotone"):
        tsched.TierPolicy(m_pads=(16, 32), nnz_pads=(128, 64), batch=4)
    with pytest.raises(ValueError, match="parallel ladders"):
        tsched.TierPolicy(m_pads=(16, 32), nnz_pads=(128,), batch=4)
    with pytest.raises(ValueError, match="at least one"):
        tsched.TierPolicy.from_requests([])
    with pytest.raises(ValueError, match="levels"):
        tbatching.tier_ladder(m_max=8, nnz_max=8, levels=0)


def test_admission_queue_orders_by_arrival_then_fifo():
    z = [np.zeros(0, np.int32)]
    q = tsched.AdmissionQueue()

    def r():
        return GraphRequest(rows=z, cols=z, n_nodes=1,
                            features=np.zeros((1, 4), np.float32))

    q.submit(r(), arrival=2.0)
    a = q.submit(r(), arrival=1.0)
    b = q.submit(r(), arrival=1.0)
    assert q.next_arrival() == 1.0
    assert [p.seq for p in q.due(1.5)] == [a.seq, b.seq]
    assert len(q) == 1 and q.next_arrival() == 2.0
    assert q.due(2.5)[0].arrival == 2.0 and len(q) == 0


def _bucket_states():
    """(batch, flush_after, topup, now, draining, entries) where entries
    are (rung, arrival, deadline) per pending request."""
    rng = np.random.default_rng(5)
    states = [
        (2, 10.0, True, 0.0, False, [(0, 0.0, None), (0, 0.0, None)]),
        (4, 10.0, True, 0.0, False, [(0, 0.0, None)] * 3 + [(1, 0.0, None)]),
        (4, 10.0, False, 0.0, False, [(0, 0.0, None)] * 3 + [(1, 0.0, None)]),
        (4, 1.0, True, 0.5, False, [(0, 0.0, None)]),
        (4, 1.0, True, 1.0, False, [(0, 0.0, None)]),
        (4, 100.0, True, 0.0, True, [(0, 0.0, None)]),
        (4, 1.0, True, 0.0, False, [(0, 0.0, 1.2)]),
        (4, 1.0, True, 0.2, False, [(0, 0.0, 1.2)]),
        (4, 1.0, True, 0.0, False, [(0, 0.0, None), (0, 0.1, 0.5)]),
        (4, math.inf, True, 3.0, False, [(1, 0.0, None), (2, 1.0, None)]),
    ]
    for _ in range(40):
        k = int(rng.integers(1, 12))
        entries = sorted(
            [(int(rng.integers(0, 3)), float(rng.uniform(0, 1)),
              None if rng.uniform() < 0.5 else float(rng.uniform(0.1, 2)))
             for _ in range(k)], key=lambda e: e[1])
        states.append((int(rng.integers(1, 6)),
                       float(rng.choice([0.05, 0.3, 1.0])),
                       bool(rng.uniform() < 0.8), float(rng.uniform(0, 1.5)),
                       bool(rng.uniform() < 0.2), entries))
    return states


def _plan_of(pkg, batch, flush_after, topup, now, draining, entries):
    pol = pkg.TierPolicy(m_pads=(16, 32, 56), nnz_pads=(64, 128, 256),
                         batch=batch)
    buckets = {t: collections.deque() for t in pol.tiers}
    for seq, (rung, arrival, deadline) in enumerate(entries):
        tier = pol.tiers[rung]
        p = pkg.PendingRequest(seq=seq, request=None, arrival=arrival,
                               deadline=deadline)
        p.tier = tier
        buckets[tier].append(p)
    out = pkg.ContinuousDispatcher(flush_after=flush_after,
                                   topup=topup).next_wave(
        buckets, now, draining=draining)
    if isinstance(out, pkg.WavePlan):
        return ("plan", out.tier.key,
                tuple((t.key, c) for t, c in out.takes), out.count)
    if isinstance(out, pkg.Wait):
        return ("wait", out.until)
    return out


def test_dispatcher_plans_match_reference():
    for state in _bucket_states():
        assert _plan_of(tsched, *state) == _plan_of(jsched, *state), state
    with pytest.raises(ValueError, match="flush_after"):
        tsched.ContinuousDispatcher(flush_after=0.0)


# ---------------------------------------------------------------------------
# whole runs, both packages
# ---------------------------------------------------------------------------

def test_virtual_clock_run_matches_reference_waves_summary_and_logits():
    """A Poisson stream with deadlines under a fixed service model: the
    same waves (tier, requests, dispatch and finish times), the same
    summary key for key, logits within TOLS["f32"]."""
    data = _setup()[0]
    rng = np.random.default_rng(3)
    arrivals = list(np.cumsum(rng.exponential(4e-4, len(data))))
    deadlines = [a + float(d) for a, d in
                 zip(arrivals, rng.choice([8e-4, 0.05], len(data)))]

    def svc(tier, n):
        return 1e-3 * tier.m_pad / 56 + 1e-5 * n

    js, ts, jreqs, treqs = _run_both(
        dict(levels=3, batch=4), arrivals=arrivals, deadlines=deadlines,
        service=svc, config=dict(batch=4, flush_after=1.2e-3))
    assert _waves(ts) == _waves(js)
    assert len({k for _, k, *_ in _waves(ts)}) > 1      # several tiers used
    assert [(w.tier_key, w.dispatch, w.service_time,
             dataclasses.asdict(w.report)) for w in ts.metrics.waves] == [
        (w.tier_key, w.dispatch, w.service_time,
         dataclasses.asdict(w.report)) for w in js.metrics.waves]
    tsum, jsum = ts.metrics.summary(), js.metrics.summary()
    assert list(tsum) == list(jsum)
    for k in jsum:
        assert _same(tsum[k], jsum[k]), (k, tsum[k], jsum[k])
    assert tsum["deadline_misses"] > 0 and tsum["served"] == len(data)
    for rt, rj in zip(treqs, jreqs):
        assert rt.done and rj.done
        np.testing.assert_allclose(rt.logits, rj.logits, atol=ATOL,
                                   rtol=RTOL)
    # the registry rows: one snapshot carries the whole run
    names = {r["metric"] for r in ts.metrics.registry.snapshot()}
    assert {"serve_requests_total", "serve_latency_seconds",
            "serve_waves_total", "serve_compile_count"} <= names


@pytest.mark.parametrize("impl", ("pallas_coo", "fused", "pallas_csr"))
def test_scheduler_logits_match_reference_and_per_request_engines(impl):
    """Port impls (their plain versions on the CPU) under the scheduler
    against the reference's ``ref`` within TOLS["f32"], and bitwise equal
    to scoring each request alone through a port engine of the tier it
    rode (wave-composition invariance)."""
    data, jcfg, np_params, _, _ = _setup()
    _, _, _, pcfg, tparams = _setup(impl)
    policy = tsched.TierPolicy.from_requests(_geoms(data), levels=3, batch=4)
    sched = tsched.Scheduler(tparams, pcfg, tiers=policy,
                             clock=tsched.VirtualClock(), device="cpu")
    out = sched.serve(_reqs(GraphRequest, data))
    assert all(r.done and not r.failed for r in out)
    used = {w.tier_key for w in sched.metrics.waves}
    assert sched.metrics.compile_count == len(used) == \
        sched.programs.compile_count
    assert sched.programs.jit_cache_sizes() == {}
    assert set(sched.programs.decisions()) == used
    assert all(d.impl == impl for d in sched.programs.decisions().values())
    jreqs = _reqs(JRequest, data)
    jsched.Scheduler(_jax_params(np_params), jcfg,
                     tiers=jsched.TierPolicy.from_requests(
                         _geoms(data), levels=3, batch=4),
                     clock=jsched.VirtualClock()).serve(jreqs)
    for rt, rj in zip(out, jreqs):
        np.testing.assert_allclose(rt.logits, rj.logits, atol=ATOL,
                                   rtol=RTOL)
    cfg_sample = dataclasses.replace(pcfg, bn_mode="sample")
    engines = {}
    for p in sched.completed:
        tier = p.served_tier
        if tier not in engines:
            engines[tier] = GraphServeEngine(
                tparams, cfg_sample, batch=tier.batch, m_pad=tier.m_pad,
                nnz_pad=tier.nnz_pad, device="cpu")
        solo = _reqs(GraphRequest, [data[p.seq]])
        engines[tier].run(solo)
        np.testing.assert_array_equal(solo[0].logits, p.request.logits)


def _bad(cls, kind, cfg):
    ch, nf = cfg.channels, cfg.n_features
    if kind == "oversize":
        return cls(rows=[np.zeros(2, np.int32)] * ch,
                   cols=[np.zeros(2, np.int32)] * ch,
                   features=np.zeros((200, nf), np.float32), n_nodes=200)
    if kind == "malformed":
        return cls(rows=[np.asarray([-1, 0], np.int32)] * ch,
                   cols=[np.asarray([0, 1], np.int32)] * ch,
                   features=np.zeros((4, nf), np.float32), n_nodes=4)
    deg = cfg.k_pad + 2                     # one node with deg out-edges
    return cls(rows=[np.zeros(deg, np.int32)] * ch,
               cols=[np.arange(deg, dtype=np.int32)] * ch,
               features=np.zeros((deg + 1, nf), np.float32), n_nodes=deg + 1)


@pytest.mark.parametrize("kind,reason", (
    ("oversize", "no geometry tier fits"),
    ("malformed", "edge ids outside"),
    ("degree", "max row degree")))
def test_bad_request_fails_alone_as_in_the_reference(kind, reason):
    """An oversize (no tier), malformed-id or degree-overflow (ELL guard)
    request fails with the reference's reason; its wave is served."""
    data, _, _, pcfg, _ = _setup("ell")

    def stream(cls):
        return [_bad(cls, kind, pcfg)] + _reqs(cls, data[:3])

    js, ts, jreqs, treqs = _run_both(
        dict(m_pads=(16, 56), nnz_pads=(64, 128), batch=4), impl="ell",
        data_fn=stream, service=lambda tier, n: 1e-3)
    assert treqs[0].failed and not treqs[0].done
    assert reason in treqs[0].error and treqs[0].error == jreqs[0].error
    assert all(r.done and not r.failed for r in treqs[1:])
    assert _waves(ts) == _waves(js)
    tsum, jsum = ts.metrics.summary(), js.metrics.summary()
    assert all(_same(tsum[k], jsum[k]) for k in jsum)
    assert (tsum["rejected"], tsum["served"]) == (1, 3)


def test_fixed_wave_equals_engine_run():
    """``Scheduler.fixed_wave``: one tier at the worst-case geometry, waves
    of 4 + 4 + 2 in FIFO order, bitwise the logits of
    ``GraphServeEngine.run``."""
    data, _, _, pcfg, tparams = _setup("pallas_coo")
    legacy = GraphServeEngine(tparams, dataclasses.replace(
        pcfg, bn_mode="sample"), batch=4, m_pad=56, nnz_pad=128,
        device="cpu")
    legacy_reqs = legacy.run(_reqs(GraphRequest, data[:10]))
    sched = tsched.Scheduler.fixed_wave(tparams, pcfg, batch=4, m_pad=56,
                                        nnz_pad=128, device="cpu",
                                        clock=tsched.VirtualClock())
    sched_reqs = sched.serve(_reqs(GraphRequest, data[:10]))
    assert sched.metrics.compile_count == 1
    assert [w.report.n_requests for w in sched.metrics.waves] == [4, 4, 2]
    assert math.isinf(sched.config.flush_after)
    for a, b in zip(legacy_reqs, sched_reqs):
        np.testing.assert_array_equal(a.logits, b.logits)


class _FakeTime:
    """The ``time`` module inside the port's scheduler.py: monotonic() and
    perf_counter() read a counter that sleep() advances (recording every
    sleep), so RealClock's own code runs without wall-clock flakiness."""

    def __init__(self):
        self.t = 0.0
        self.sleeps = []

    def monotonic(self):
        return self.t

    def perf_counter(self):
        return self.t

    def sleep(self, dt):
        assert dt >= 0
        self.sleeps.append(dt)
        self.t += dt


def test_real_clock_composes_the_virtual_waves(monkeypatch):
    """The same arrival trace gives the same waves under RealClock (time
    stubbed) and VirtualClock, in the port and in the reference; RealClock
    really sleeps to future arrivals."""
    data, _, _, pcfg, tparams = _setup()
    policy = tsched.TierPolicy.from_requests(_geoms(data), levels=2, batch=4)
    arrivals = [0.0, 0.0, 0.1, 0.1, 0.4, 0.4, 0.4, 1.0]
    ft = _FakeTime()
    monkeypatch.setattr(tsched_mod, "time", ft)

    def run(clock):
        sched = tsched.Scheduler(
            tparams, pcfg, tiers=policy, clock=clock, device="cpu",
            service_model=lambda tier, n: 0.0,
            config=tsched.SchedulerConfig(batch=4, flush_after=0.05))
        sched.serve(_reqs(GraphRequest, data[:8]), arrivals=list(arrivals))
        assert all(p.dispatch >= p.arrival for p in sched.completed)
        return sched, [(w.tier_key, w.report.n_requests)
                       for w in sched.metrics.waves]

    real_sched, real = run(None)
    assert isinstance(real_sched.clock, tsched.RealClock)
    assert ft.sleeps and ft.t >= 1.0
    virtual = run(tsched.VirtualClock())[1]
    assert real == virtual and sum(n for _, n in real) == 8
    js, _, _, _ = _run_both(dict(levels=2, batch=4), arrivals=arrivals,
                            n=8, service=lambda tier, n: 0.0,
                            config=dict(batch=4, flush_after=0.05))
    assert real == [(w.tier_key, w.report.n_requests)
                    for w in js.metrics.waves]


def test_scheduler_contract(monkeypatch):
    """``device=`` reaches every tier engine, ``warmup`` builds each tier
    once with an empty wave, a custom factory and a conflicting batch
    behave as in the reference, and no device without a GPU raises."""
    data, _, _, pcfg, tparams = _setup()
    policy = tsched.TierPolicy.from_requests(_geoms(data), levels=3, batch=4)
    sched = tsched.Scheduler(tparams, pcfg, tiers=policy, device="cpu",
                             clock=tsched.VirtualClock())
    reqs = _reqs(GraphRequest, data)
    n = sched.warmup(reqs)
    assert n == len({policy.assign(r) for r in reqs}) == \
        sched.metrics.compile_count
    assert all(p.warmed and p.engine.device.type == "cpu"
               for p in map(sched.programs.get, sched.programs.tiers()))
    assert all(e.compiled_programs() is None for e in
               (sched.programs.get(t).engine
                for t in sched.programs.tiers()))
    assert sched.cfg.bn_mode == "sample" and pcfg.bn_mode == "batch"
    with pytest.raises(ValueError, match="disagrees"):
        tsched.Scheduler(tparams, pcfg, tiers=policy, device="cpu",
                         config=tsched.SchedulerConfig(batch=8))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsched.Scheduler(tparams, pcfg, tiers=policy)
    with pytest.raises(TypeError, match="mesh"):
        tsched.Scheduler(tparams, pcfg, tiers=policy, mesh=object(),
                         device="cpu")


def test_reference_import_surface():
    assert sorted(tsched.__all__) == sorted(jsched.__all__)
    for name in jsched.__all__:
        assert hasattr(tsched, name), name
