"""Port parity: the autotune (``impl="auto"``) against the JAX reference's on
the CPU.

The machinery must agree with the reference's: workload keys letter for
letter, the tuning-cache document (each package reads the other's file,
merge-on-save), the ladders and tables, forced and case-3 decisions, and
the same measured cache giving the same choice. The cost model's ranks
differ by design (the port's constants are an H100's, the reference's a
TPU's), so they are checked for completeness and order only. End to end,
ChemGCN with ``impl="auto"`` (graph conv, GAT, R-GCN) serves and trains on
the CPU within the f32 tolerance of the reference's ``impl="ref"``, and
bit for bit as the port pinned to the impl it resolved to.
"""
import dataclasses
import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

from oracle import TOLS
from repro import autotune as jat
from repro.autotune import cost_model as jcm
from repro.autotune import selector as jsel
from repro.core import gcn as jgcn
from repro.data import graphs as jgraphs
from repro.kernels import ops as j_ops
from repro.serving.engine import GraphRequest as JRequest
from repro.serving.engine import GraphServeEngine as JEngine
from repro.training import GCNTrainer as JTrainer
from repro.training import TrainerConfig as JTrainerConfig
from repro_torch import autotune as tat
from repro_torch.autotune import cost_model as tcm
from repro_torch.autotune import selector as tsel
from repro_torch.convert import params_from_jax
from repro_torch.core import gcn as tgcn
from repro_torch.core.formats import BatchedCOO
from repro_torch.core.graph_conv import resolve_graph_conv_impl
from repro_torch.data import graphs as tgraphs
from repro_torch.kernels import ops
from repro_torch.serving.engine import GraphRequest, GraphServeEngine
from repro_torch.training.trainer import GCNTrainer, TrainerConfig
from test_torch_serving import GEOM, _requests

ATOL, RTOL = TOLS["f32"]
KERNEL_PREFIXES = ("pallas", "fused")
TOX = dict(batch=128, m_pad=56, nnz_pad=256, k_pad=8, n_b=64)
LAYER = dict(TOX, channels=4, n_in=62)


def _both(**kw):
    return tat.Workload(**kw), jat.Workload(**kw)


# ---------------------------------------------------------------------------
# keys, ladders and tables

KEY_CASES = [dict(TOX), dict(TOX, k_pad=None), dict(LAYER),
             dict(LAYER, nnz_avg=100), dict(LAYER, dtype="bf16"),
             dict(TOX, dtype="i8"), dict(TOX, itemsize=2),
             dict(TOX, max_deg=12), dict(TOX, block=24),
             dict(LAYER, dtype="bf16", max_deg=9, block=32)]
KEY_CASES += [dict(TOX, n_b=16, op=op, reduce=reduce, d_e=d_e)
              for op in ops.GSPMM_OPS for reduce in ops.GSPMM_REDUCES
              for d_e in (None, 16)]


@pytest.mark.parametrize("kw", KEY_CASES, ids=lambda kw: jat.Workload(
    **kw).key())
def test_workload_keys_match_letter_for_letter(kw):
    t, j = _both(**kw)
    assert t.key() == j.key()
    assert t.is_gspmm == j.is_gspmm


def test_ladders_and_tables_match_reference():
    assert tsel.KINDS == jsel.KINDS
    assert tcm.PRECISION_IMPLS == jcm.PRECISION_IMPLS
    assert tcm.GSPMM_IMPLS == jcm.GSPMM_IMPLS == ops.GSPMM_IMPLS
    assert set(ops.IMPLS) == set(j_ops.IMPLS)
    for impl in ops.IMPLS:
        assert tcm.supports_gspmm(impl) == jcm.supports_gspmm(impl), impl
        assert tcm.precision_of(impl) == jcm.precision_of(impl), impl
    for dtype in tcm.POLICIES:
        for allow in (False, True):
            assert tcm._candidates(dtype, allow) == \
                jcm._candidates(dtype, allow)
    assert set(tat.__all__) == set(jat.__all__)
    assert tat.ENV_VAR == "REPRO_TORCH_TUNE_CACHE" != jat.ENV_VAR
    # the CPU posture ranks no kernel impl; a g-SpMM workload ranks only
    # the capable impls; without k_pad the ELL class is out
    for kw in (TOX, dict(TOX, dtype="i8")):
        w = tat.Workload(**kw)
        assert not [i for i, _ in tcm.rank(w, allow_pallas=False)
                    if i.startswith(KERNEL_PREFIXES)]
    w = tat.Workload(**LAYER)
    assert not [i for i, _ in tcm.rank_layer(w, allow_pallas=False)
                if i.startswith(KERNEL_PREFIXES)]
    for op, reduce in (("copy_lhs", "mean"), ("add", "max")):
        w = tat.Workload(**dict(TOX, op=op, reduce=reduce))
        assert all(tcm.supports_gspmm(i) for i, _ in tcm.rank(w))
    w = tat.Workload(**dict(TOX, n_b=16, d_e=16))
    assert {i for i, _ in tcm.rank(w)} == set(tcm.GSPMM_IMPLS)
    w = tat.Workload(**dict(TOX, k_pad=None))
    assert not [i for i, _ in tcm.rank(w)
                if tcm.precision_of(i)[0] in ("ell", "pallas_ell")]


@pytest.mark.parametrize("kw", [TOX, dict(TOX, dtype="bf16"),
                                dict(TOX, dtype="i8"), LAYER,
                                dict(LAYER, dtype="bf16"),
                                dict(TOX, batch=2, m_pad=2048),
                                dict(TOX, max_deg=40, nnz_pad=2048,
                                     m_pad=256)])
def test_model_ranks_are_complete_and_sorted(kw):
    """Every candidate of the ladder that can run is ranked, finite and in
    order (the estimates themselves are the H100's, not compared)."""
    w = tat.Workload(**kw)
    layer = w.channels is not None
    for allow in (False, True):
        ranked = (tcm.rank_layer if layer else tcm.rank)(w,
                                                         allow_pallas=allow)
        cands = tcm._candidates(w.dtype, allow)
        if layer and allow:
            cands += ["fused", "fused_hybrid"] + (
                ["fused_bf16"] if w.dtype != "f32" else [])
        est = tcm.estimate_layer if layer else tcm.estimate
        assert [i for i, _ in ranked] == sorted(
            cands, key=lambda i: est(w, i))
        times = [t for _, t in ranked]
        assert times == sorted(times) and all(
            0 < t < float("inf") for t in times)
        assert "loop" in dict(ranked)


# ---------------------------------------------------------------------------
# the tuning cache, across packages

KEY = tat.Workload(**TOX).key()


def test_cache_files_are_read_by_the_other_package(tmp_path):
    path = str(tmp_path / "tune.json")
    t = tat.TuningCache(path)
    assert t.put(KEY, {"pallas_coo": 1e-4, "ref": 3e-4},
                 interpret=False) == "pallas_coo"
    j = jat.TuningCache(path)
    assert j.best(KEY) == "pallas_coo" and j.records == t.records
    assert j.times(KEY) == {"pallas_coo": 1e-4, "ref": 3e-4}
    key2 = jat.Workload(**LAYER).key()
    j.put(key2, {"fused": 2e-4, "csr": 1e-4}, interpret=True)
    t2 = tat.TuningCache(path)
    assert t2.best(key2) == "csr" and t2.best(KEY) == "pallas_coo"
    assert t2.records == jat.TuningCache(path).records
    # the same records give the same document, byte for byte
    ja, ta = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    jat.TuningCache(ja).put(KEY, {"ref": 2e-4, "csr": 1e-4},
                            interpret=True)
    tat.TuningCache(ta).put(KEY, {"ref": 2e-4, "csr": 1e-4},
                            interpret=True)
    assert open(ja).read() == open(ta).read()
    doc = json.loads(open(ta).read())
    assert doc["version"] == 1 and doc["records"][KEY]["best"] == "csr"
    # another version or an unreadable file is an empty cache in both
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"version": 2, "records": {KEY: {}}}))
    assert tat.TuningCache(str(bad)).records == {} == \
        jat.TuningCache(str(bad)).records
    bad.write_text("{torn")
    assert tat.TuningCache(str(bad)).records == {}
    assert tat.TuningCache(None).best(KEY) is None


@pytest.mark.parametrize("writers", ["port", "mixed"])
def test_merge_on_save_unions_two_writers(tmp_path, writers):
    """Two caches opened on one path before either writes: the second save
    unions the first's records, shared keys at the per-impl minimum with
    ``best`` recomputed; the reference merges to the same document."""
    key2 = tat.Workload(**LAYER).key()

    def run(path, second):
        a = tat.TuningCache(path)
        b = second.TuningCache(path)
        a.put(KEY, {"ref": 2e-4, "csr": 3e-4}, interpret=True)
        b.put(KEY, {"ref": 4e-4, "pallas_coo": 1e-4}, interpret=False)
        b.put(key2, {"fused": 1e-4}, interpret=False)
        return json.loads(open(path).read())["records"], b

    second = tat if writers == "port" else jat
    got, b = run(str(tmp_path / "t.json"), second)
    assert got[KEY] == {"best": "pallas_coo", "interpret": False,
                        "times": {"ref": 2e-4, "csr": 3e-4,
                                  "pallas_coo": 1e-4}}
    assert got[key2]["best"] == "fused" and b.records == got
    j = tmp_path / "j.json"
    ja, jb = jat.TuningCache(str(j)), jat.TuningCache(str(j))
    ja.put(KEY, {"ref": 2e-4, "csr": 3e-4}, interpret=True)
    jb.put(KEY, {"ref": 4e-4, "pallas_coo": 1e-4}, interpret=False)
    jb.put(key2, {"fused": 1e-4}, interpret=False)
    assert json.loads(j.read_text())["records"] == got
    assert tat.cache._merge_records(
        {KEY: {"best": "ref", "times": {"ref": 1.0}, "interpret": True}},
        {KEY: {"best": "csr", "times": {"csr": 2.0}, "interpret": False}}
    ) == jat.cache._merge_records(
        {KEY: {"best": "ref", "times": {"ref": 1.0}, "interpret": True}},
        {KEY: {"best": "csr", "times": {"csr": 2.0}, "interpret": False}})


def test_torn_file_loses_the_merge_not_the_save(tmp_path):
    path = tmp_path / "tune.json"
    c = tat.TuningCache(str(path))
    path.write_text('{"version": 1, "records": {"b1_m')
    assert c.put(KEY, {"ref": 1e-4}, interpret=True) == "ref"
    assert json.loads(path.read_text())["records"] == {
        KEY: {"best": "ref", "times": {"ref": 1e-4}, "interpret": True}}
    assert [p.name for p in tmp_path.iterdir()] == ["tune.json"]


def test_default_cache_follows_the_ports_own_variable(tmp_path,
                                                      monkeypatch):
    monkeypatch.delenv(tat.ENV_VAR, raising=False)
    monkeypatch.setenv(jat.ENV_VAR, str(tmp_path / "jax.json"))
    assert tat.default_cache() is None
    monkeypatch.setenv(tat.ENV_VAR, str(tmp_path / "torch.json"))
    assert tat.default_cache() is tat.default_cache()
    assert tat.default_cache().path == str(tmp_path / "torch.json")


# ---------------------------------------------------------------------------
# decisions

@pytest.mark.parametrize("allow", (False, True))
def test_same_cache_in_same_choice_out(tmp_path, allow):
    """A measured winner that both ladders hold is the choice of both
    packages, from the cache; a winner outside the allowed ladder is
    ignored by both."""
    spmm, layer = _both(**TOX), _both(**LAYER)
    gspmm = _both(**dict(TOX, op="copy_lhs", reduce="mean"))
    win = {spmm[1].key(): "pallas_csr" if allow else "csr",
           layer[1].key(): "fused" if allow else "ell",
           gspmm[1].key(): "pallas_coo" if allow else "ref"}
    path = str(tmp_path / "tune.json")
    c = jat.TuningCache(path)
    for key, impl in win.items():
        c.put(key, {impl: 1e-5, "loop": 1.0}, interpret=not allow)
    tc, jc = tat.TuningCache(path), jat.TuningCache(path)
    for (tw, jw), select in ((spmm, "select_impl"),
                             (gspmm, "select_impl"),
                             (layer, "select_graph_conv_impl")):
        t = getattr(tsel, select)(tw, allow_pallas=allow, cache=tc)
        j = getattr(jsel, select)(jw, allow_pallas=allow, cache=jc)
        assert (t.impl, t.kind, t.source) == (j.impl, j.kind, "cache")
        assert t.impl == win[jw.key()] and t.reason == j.reason
        assert t.workload.key() == j.workload.key()
    # outside the ladder: a kernel impl on the CPU posture, a layer impl or
    # a GEMM impl for a bare or g-SpMM workload
    out = {spmm[1].key(): "fused" if allow else "pallas_csr",
           layer[1].key(): "pallas_coo_bf16" if allow else "fused",
           gspmm[1].key(): "pallas_gemm"}
    path2 = str(tmp_path / "out.json")
    c = tat.TuningCache(path2)
    for key, impl in out.items():
        c.put(key, {impl: 1e-5}, interpret=not allow)
    tc, jc = tat.TuningCache(path2), jat.TuningCache(path2)
    for (tw, jw), select in ((spmm, "select_impl"),
                             (gspmm, "select_impl"),
                             (layer, "select_graph_conv_impl")):
        assert getattr(tsel, select)(tw, allow_pallas=allow,
                                     cache=tc).source == "model"
        assert getattr(jsel, select)(jw, allow_pallas=allow,
                                     cache=jc).source == "model"


@pytest.mark.parametrize("impl", ("ref", "csr", "pallas_csr", "pallas_coo",
                                  "pallas_ell_i8", "pallas_hybrid_bf16",
                                  "dense", "fused", "fused_bf16"))
def test_forced_decisions_agree(impl):
    """A pinned impl: the same impl, kind, source and reason in both
    packages, for bare and layer workloads. The plan is each package's own
    planner's (the port's panels are Hopper shared memory's)."""
    for kw in (TOX, LAYER):
        t, j = (m.forced_decision(w, impl) for m, w in
                zip((tsel, jsel), _both(**kw)))
        assert (t.impl, t.kind, t.source, t.reason, t.scores) == \
            (j.impl, j.kind, j.source, j.reason, j.scores)
        assert t.workload.key() == j.workload.key()
        assert t.case == t.plan.case


def test_ref_is_forced_only_past_large_m_in_both_packages():
    """Past LARGE_M both packages force ``ref`` (f32, bare and layer
    workloads). Below it neither does: at m_pad 2048 and n_b 64 the port's
    plan is case 3 (one 32-column f32 panel of 2048 rows is 256 KB, more
    than a block's 227 KB of shared memory) while the reference's VMEM plan
    keeps batching, and in both packages the model decides. Each package
    picks its own model's cheapest (the two cost models differ); on the
    card the port's pick there is a kernel impl, which runs its
    large-matrix entry."""
    for kw in (dict(TOX, batch=2, m_pad=9000),
               dict(LAYER, batch=2, m_pad=9000)):
        t, j = _both(**kw)
        select = "select_graph_conv_impl" if t.channels else "select_impl"
        for allow in (False, True):
            td = getattr(tsel, select)(t, allow_pallas=allow)
            jd = getattr(jsel, select)(j, allow_pallas=allow)
            assert (td.impl, td.kind, td.source, td.case) == \
                (jd.impl, jd.kind, jd.source, jd.case) == \
                ("ref", "scatter", "forced", 3)
            assert td.reason.split(":")[0] == jd.reason.split(":")[0]
            assert tsel.forces_ref(t)
    for kw in (dict(TOX, batch=2, m_pad=2048),
               dict(LAYER, batch=2, m_pad=2048)):
        t, j = _both(**kw)
        select = "select_graph_conv_impl" if t.channels else "select_impl"
        ranker = tat.rank_layer if t.channels else tat.rank
        j_ranker = jat.rank_layer if t.channels else jat.rank
        assert not tsel.forces_ref(t)
        td = getattr(tsel, select)(t, allow_pallas=False)
        jd = getattr(jsel, select)(j, allow_pallas=False)
        assert td.source == jd.source == "model"
        assert td.impl == ranker(t, allow_pallas=False)[0][0]
        assert jd.impl == j_ranker(j, allow_pallas=False)[0][0]
        assert tsel.spmm_plan(t).case == 3     # the port's plan, reported
        on_card = getattr(tsel, select)(t, allow_pallas=True)
        assert on_card.source == "model"
        assert on_card.impl.startswith(("pallas_", "fused")), on_card
        assert on_card.impl == ranker(t, allow_pallas=True)[0][0]


def test_resolvers_mirror_the_reference_on_pinned_impls():
    """resolve_impl / resolve_gspmm_impl / resolve_graph_conv_impl /
    resolve_conv_impls on a pinned impl: the reference's forced Decision."""
    from repro.core.graph_conv import resolve_graph_conv_impl as j_gc
    from test_torch_formats import case

    _, coo, m_pad, b, k_pad = case("uniform")
    bt = torch.from_numpy(b)
    jcoo = jax.tree.map(jax.numpy.asarray, _j_coo(coo))
    for impl in ("pallas_csr", "ell_bf16"):
        t = ops.resolve_impl(coo, bt, impl=impl, k_pad=k_pad)
        j = j_ops.resolve_impl(jcoo, jax.numpy.asarray(b), impl=impl,
                               k_pad=k_pad)
        assert (t.impl, t.source, t.workload.key()) == \
            (j.impl, j.source, j.workload.key())
    t = resolve_graph_conv_impl([coo, coo], bt, 24, impl="fused", k_pad=4)
    j = j_gc([jcoo, jcoo], jax.numpy.asarray(b), 24, impl="fused", k_pad=4)
    assert (t.impl, t.source, t.workload.key()) == \
        (j.impl, j.source, j.workload.key())
    for layer in ("gcn", "gat", "rgcn"):
        jc = jgcn.GCNConfig.tox21(layer=layer, impl="pallas_csr")
        tc = _port_cfg(jc)
        td = tgcn.resolve_conv_impls(tc, 4, 16, 64, device="cpu")
        jd = jgcn.resolve_conv_impls(jc, 4, 16, 64)
        assert [(d.impl, d.source, d.workload.key()) for d in td] == \
            [(d.impl, d.source, d.workload.key()) for d in jd]


def _j_coo(coo):
    from repro.core.formats import BatchedCOO as JCOO

    return JCOO(*(t.numpy() for t in (coo.row_ids, coo.col_ids, coo.values,
                                      coo.nnz, coo.n_rows)))


def _port_cfg(jcfg, **kw):
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(tgcn.GCNConfig)}
    return dataclasses.replace(tgcn.GCNConfig(**fields), **kw)


# ---------------------------------------------------------------------------
# measurement on the CPU

SMALL = dict(batch=2, m_pad=8, nnz_pad=16, k_pad=4, n_b=8)


def test_measure_workload_times_what_it_is_asked_on_the_cpu(monkeypatch):
    w = tat.Workload(**SMALL)
    times = tat.measure_workload(w, ("ref", "csr", "ell"), device="cpu",
                                 iters=2)
    assert set(times) == {"ref", "csr", "ell"}
    assert all(t > 0 for t in times.values())
    assert set(tat.measure_workload(w, device="cpu", iters=1)) == {
        i for i, _ in tcm.rank(w, allow_pallas=False)}
    lossy = tat.Workload(**dict(SMALL, nnz_pad=40))      # 40 > 8 * 4 cells
    with pytest.raises(ValueError, match="losslessly"):
        tat.measure_workload(lossy, ("ref", "ell"), device="cpu")
    assert "ell" not in tat.measure_workload(lossy, device="cpu", iters=1)
    # a layer workload is timed as whole graph_conv_batched calls
    from repro_torch.core import graph_conv

    calls = []
    real = graph_conv.graph_conv_batched

    def counted(params, adj, x, **kw):
        calls.append((len(adj), tuple(x.shape), params["w"].shape, kw))
        return real(params, adj, x, **kw)

    monkeypatch.setattr(graph_conv, "graph_conv_batched", counted)
    layer = tat.Workload(**dict(SMALL, channels=3, n_in=5))
    tat.measure_workload(layer, ("ref", "csr"), device="cpu", warmup=1,
                         iters=2)
    assert len(calls) == 6 and calls[0][:3] == (3, (2, 8, 5), (3, 5, 8))
    assert {c[3]["impl"] for c in calls} == {"ref", "csr"}
    # a g-SpMM workload is timed as its (op, reduce) with vector edges
    g = tat.Workload(**dict(SMALL, d_e=8, reduce="max"))
    assert set(tat.measure_workload(g, device="cpu", iters=1)) == \
        {i for i, _ in tcm.rank(g, allow_pallas=False)}
    with pytest.raises(ValueError, match="cannot run g-SpMM"):
        tat.measure_workload(g, ("dense",), device="cpu", iters=1)


def test_measure_workload_times_contenders_in_rotated_blocks(monkeypatch):
    """The timed calls of each candidate come in blocks of at least 3 in a
    row, each after the warm-up calls, one block of every candidate a
    round, the order rotated a step a round, with the garbage collector
    paused (and restored after). A candidate whose first block took more
    than ``contend`` times the fastest sits out the later rounds; a time
    is the median of the candidate's blocks' medians, so one slow block of
    three does not decide it. Timed on a fake clock that each call moves
    by its impl's cost."""
    import gc
    import time

    import repro_torch.autotune.cache as cache_mod

    seen, now = [], [0.0]

    def cost(impl):
        if impl == "csr" and 3 < sum(i == "csr" for i, _ in seen) <= 6:
            return 10.0                  # csr's second block: a slow stretch
        return {"ref": 1.0, "csr": 1.0, "ell": 3.0}[impl]

    def fake_call(w, *, device, seed=0):
        def call(impl):
            seen.append((impl, gc.isenabled()))
            now[0] += cost(impl)
        return call

    monkeypatch.setattr(cache_mod, "workload_call", fake_call)
    monkeypatch.setattr(time, "perf_counter", lambda: now[0])
    w = tat.Workload(**SMALL)
    impls = ("ref", "csr", "ell")
    # every candidate every round: 7 timed calls over 2 rounds, blocks of 3
    # then 4, each after 1 warm call
    tat.measure_workload(w, impls, device="cpu", warmup=1, iters=7,
                         contend=None)
    run = lambda impl, n: [impl] * (1 + n)
    assert [i for i, _ in seen] == (
        run("ref", 3) + run("csr", 3) + run("ell", 3)
        + run("csr", 4) + run("ell", 4) + run("ref", 4))
    assert not any(on for _, on in seen)
    assert gc.isenabled()
    # ell (3x the fastest) runs only the first round; csr's slow block is
    # outvoted by its other two
    seen.clear()
    times = tat.measure_workload(w, impls, device="cpu", warmup=0, iters=9)
    assert [i for i, _ in seen] == (["ref"] * 3 + ["csr"] * 3 + ["ell"] * 3
                                    + ["csr"] * 3 + ["ref"] * 3
                                    + ["ref"] * 3 + ["csr"] * 3)
    assert times == {"ref": 1.0, "csr": 1.0, "ell": 3.0}


def test_autotune_fills_the_cache_then_answers_from_it(tmp_path,
                                                       monkeypatch):
    w = tat.Workload(**SMALL)
    cache = tat.TuningCache(str(tmp_path / "tune.json"))
    best = tat.autotune(w, cache=cache, impls=("ref", "csr"), device="cpu")
    rec = jat.TuningCache(cache.path).records[w.key()]
    assert rec["best"] == best and rec["interpret"] is True
    assert set(rec["times"]) == {"ref", "csr"}

    def fail(*a, **k):
        raise AssertionError("measured again")

    monkeypatch.setattr(tat.cache, "measure_workload", fail)
    assert tat.autotune(w, cache=cache, device="cpu") == best
    d = tsel.select_impl(w, allow_pallas=False, cache=cache)
    assert (d.impl, d.source) == (best, "cache")


# ---------------------------------------------------------------------------
# end to end: serving and training with impl="auto"

@functools.lru_cache(maxsize=None)
def _model(layer: str):
    cfg = jgcn.GCNConfig.tox21(impl="ref", layer=layer, bn_mode="sample",
                               interpret=True)
    return cfg, jax.tree.map(np.asarray, jgcn.init_gcn(jax.random.key(1),
                                                       cfg))


@functools.lru_cache(maxsize=None)
def _j_served(layer: str) -> tuple:
    cfg, np_params = _model(layer)
    reqs = _requests(JRequest)
    JEngine(jax.tree.map(jax.numpy.asarray, np_params), cfg, **GEOM).run(
        reqs)
    return tuple(r.logits for r in reqs)


def _engine(layer: str, impl: str = "auto", **cfg_kw):
    cfg, np_params = _model(layer)
    pcfg = _port_cfg(cfg, impl=impl, **cfg_kw)
    return GraphServeEngine(params_from_jax(np_params, pcfg, device="cpu"),
                            pcfg, **GEOM, device="cpu")


@pytest.mark.parametrize("layer", ("gcn", "gat", "rgcn"))
def test_auto_serves_like_the_reference_and_the_pinned_impl(layer,
                                                            monkeypatch):
    monkeypatch.delenv(tat.ENV_VAR, raising=False)
    eng = _engine(layer)
    d = eng.layer_decision()
    decisions = tgcn.resolve_conv_impls(eng.cfg, GEOM["batch"],
                                        GEOM["m_pad"], GEOM["nnz_pad"],
                                        device="cpu")
    assert d == decisions[0] and d.source == "model"
    assert not d.impl.startswith(KERNEL_PREFIXES)
    if layer == "gcn":
        z = torch.zeros((GEOM["batch"], GEOM["nnz_pad"]), dtype=torch.int32)
        adj = [BatchedCOO(z, z, z.float(), z[:, 0], z[:, 0] + 16)] * 4
        x = torch.zeros((GEOM["batch"], GEOM["m_pad"], 62))
        assert resolve_graph_conv_impl(adj, x, 64, k_pad=8) == d
    assert len({x.impl for x in decisions}) == 1
    got = [r.logits for r in eng.run(_requests(GraphRequest))]
    for g, w in zip(got, _j_served(layer)):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL)
    pinned = _engine(layer, d.impl).run(_requests(GraphRequest))
    for g, p in zip(got, pinned):
        np.testing.assert_array_equal(g, p.logits)


def _losses(trainer, batches):
    losses = []
    trainer.fit(lambda e: [batches[e]], epochs=len(batches),
                on_metrics=lambda _, rec: losses.append(rec["loss"]))
    return losses


@pytest.mark.parametrize("layer", ("gcn", "gat", "rgcn"))
def test_auto_trains_like_the_reference_and_the_pinned_impl(layer, tmp_path,
                                                            monkeypatch):
    """Two steps of ``fit`` from the reference's seed-0 state (its step-0
    checkpoint, restored by both packages): the port's ``auto`` within the
    f32 tolerance of the reference's ``ref``, and bit for bit the port
    pinned to the impl it resolved to."""
    monkeypatch.delenv(tat.ENV_VAR, raising=False)
    jcfg = dataclasses.replace(_model(layer)[0], bn_mode="batch")
    jb = list(jgraphs.batches(*_spec_data(jgraphs), 4))[:2]
    tb = list(tgraphs.batches(*_spec_data(tgraphs), 4))[:2]
    ck = str(tmp_path / "ck")
    jt = JTrainer(jcfg, tcfg=JTrainerConfig(checkpoint_dir=ck),
                  telemetry=False)
    params, state, _ = jt.restore_or_init()
    jt.manager.save(0, (params, state))
    runs = {}
    for impl in ("auto", "pinned"):
        d = str(tmp_path / impl)
        os.makedirs(d)
        os.symlink(os.path.join(ck, "step_0000000000"),
                   os.path.join(d, "step_0000000000"))
        pcfg = _port_cfg(jcfg, impl="auto" if impl == "auto"
                         else runs["decision"].impl)
        tr = GCNTrainer(pcfg, tcfg=TrainerConfig(d), device="cpu")
        if impl == "auto":
            runs["decision"] = tr.layer_decision(tb[0])
            assert runs["decision"] == tgcn.resolve_conv_impls(
                pcfg, 4, tb[0]["x"].shape[1], tb[0]["adj"][0].nnz_pad,
                device="cpu")[0]
        runs[impl] = _losses(tr, tb)
    want = _losses(jt, jb)
    np.testing.assert_allclose(runs["auto"], want, atol=ATOL, rtol=RTOL)
    assert runs["auto"] == runs["pinned"] and len(want) == 2


def _spec_data(pkg):
    spec = pkg.GraphDatasetSpec.tox21_like(n_samples=8, seed=0)
    return pkg.generate(spec), spec


@pytest.mark.parametrize("winner", ("ell", "csr"))
def test_degree_guards_follow_the_cache_as_the_references_do(
        winner, tmp_path, monkeypatch):
    """With a measured cache whose layer winner is ELL-class, the engine's
    and the trainer's degree guards are on, as the reference's are; with a
    CSR winner they are off in both."""
    path = str(tmp_path / "tune.json")
    monkeypatch.setenv(tat.ENV_VAR, path)
    monkeypatch.setenv(jat.ENV_VAR, path)
    # the engine: waves of GEOM, k_pad 8
    c = tat.TuningCache(path)
    tb = list(tgraphs.batches(*_spec_data(tgraphs), 4))
    for n_in in (62, 64):
        for batch, m_pad, nnz_pad, k_pad in (
                (4, 16, 64, 8),
                (4, tb[0]["x"].shape[1], tb[0]["adj"][0].nnz_pad, 1)):
            w = tat.Workload(batch=batch, m_pad=m_pad, nnz_pad=nnz_pad,
                             k_pad=k_pad, n_b=64, channels=4, n_in=n_in)
            c.put(w.key(), {winner: 1e-5, "ref": 1e-4}, interpret=True)
    eng = _engine("gcn")
    cfg, np_params = _model("gcn")
    j_eng = JEngine(jax.tree.map(jax.numpy.asarray, np_params),
                    dataclasses.replace(cfg, impl="auto"), **GEOM)
    assert eng.layer_decision().source == "cache"
    assert eng._ell_degree_guard == j_eng._ell_degree_guard == \
        (winner == "ell")
    # the trainer: k_pad 1, under which every Tox21 batch has a row over it
    jcfg = dataclasses.replace(cfg, impl="auto", k_pad=1)
    tr = GCNTrainer(_port_cfg(jcfg), tcfg=TrainerConfig(
        str(tmp_path / "t")), device="cpu")
    jt = JTrainer(jcfg, tcfg=JTrainerConfig(
        checkpoint_dir=str(tmp_path / "j"), checkpoint_every=1000),
        telemetry=False)
    jb = list(jgraphs.batches(*_spec_data(jgraphs), 4))
    assert tr.layer_decision(tb[0]).impl == winner
    if winner == "ell":
        with pytest.raises(ValueError, match="max row degree"):
            tr.fit(tb[:1])
        with pytest.raises(ValueError, match="max row degree"):
            jt.fit(lambda e: jb[:1])
    else:
        tr.fit(tb[:1])
        jt.fit(lambda e: jb[:1])
