"""Port parity: GraphServeEngine (repro_torch.serving) against the JAX
reference engine on the same requests, on the CPU: logits to 1e-4, the
same per-slot soft-fail reasons and wave accounting, bitwise
wave-composition invariance, and the port's device and impl contract.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import gcn as jgcn
from repro.data import graphs as jgraphs
from repro.serving.engine import GraphRequest as JRequest
from repro.serving.engine import GraphServeEngine as JEngine
from repro_torch.convert import params_from_jax
from repro_torch.core import gcn as tgcn
from repro_torch.serving.engine import GraphRequest, GraphServeEngine

GEOM = dict(batch=4, m_pad=16, nnz_pad=64)
PORT_IMPLS = ("ref", "ell", "dense", "loop", "pallas_ell", "pallas_coo",
              "fused", "hybrid", "pallas_hybrid", "pallas_gemm",
              "fused_hybrid")


def _requests(cls, n=7):
    """Tox21-like molecules that fit the 16-row geometry, as ``cls``."""
    spec = jgraphs.GraphDatasetSpec.tox21_like(n_samples=n, max_nodes=14,
                                               seed=2)
    return [cls(rows=list(s.rows), cols=list(s.cols), features=s.features,
                n_nodes=s.n_nodes) for s in jgraphs.generate(spec)]


def _bad_requests(cls):
    """One request per soft-fail reason, in the reference's check order."""
    z = np.zeros(0, np.int32)
    f = np.zeros((3, 62), np.float32)
    ring = np.arange(3, dtype=np.int32)
    star_r = np.zeros(9, np.int32)                      # row 0: degree 9
    star_c = np.arange(1, 10, dtype=np.int32)
    return [
        cls(rows=[z] * 4, cols=[z] * 4, features=np.zeros((20, 62),
            np.float32), n_nodes=20),                   # oversize
        cls(rows=[z] * 3, cols=[z] * 3, features=f, n_nodes=3),  # channels
        cls(rows=[ring, z, z, z], cols=[ring + 5, z, z, z], features=f,
            n_nodes=3),                                 # ids out of range
        cls(rows=[star_r, z, z, z], cols=[star_c, z, z, z],
            features=np.zeros((10, 62), np.float32), n_nodes=10),  # degree
    ]


@functools.lru_cache(maxsize=None)
def _params(bn_mode: str):
    cfg = jgcn.GCNConfig.tox21(impl="ref", bn_mode=bn_mode)
    return cfg, jax.tree.map(np.asarray, jgcn.init_gcn(jax.random.key(1),
                                                       cfg))


def _port_engine(impl: str, bn_mode: str = "sample", **kw):
    cfg, np_params = _params(bn_mode)
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(tgcn.GCNConfig)}
    pcfg = dataclasses.replace(tgcn.GCNConfig(**fields), impl=impl)
    params = params_from_jax(np_params, pcfg, device="cpu")
    return GraphServeEngine(params, pcfg, **{**GEOM, "device": "cpu", **kw})


def _jax_engine(impl: str, bn_mode: str = "sample"):
    cfg, np_params = _params(bn_mode)
    params = jax.tree.map(jax.numpy.asarray, np_params)
    return JEngine(params, dataclasses.replace(cfg, impl=impl), **GEOM)


@functools.lru_cache(maxsize=None)
def _jax_served(bn_mode: str) -> tuple:
    reqs = _requests(JRequest)
    _jax_engine("ref", bn_mode).run(reqs)
    return tuple(r.logits for r in reqs)


@pytest.mark.parametrize("impl", PORT_IMPLS)
def test_engine_logits_match_reference(impl):
    reqs = _requests(GraphRequest)
    _port_engine(impl).run(reqs)
    assert all(r.done and not r.failed for r in reqs)
    for r, want in zip(reqs, _jax_served("sample")):
        np.testing.assert_allclose(r.logits, want, atol=1e-4, err_msg=impl)


def test_engine_batch_bn_matches_reference():
    reqs = _requests(GraphRequest)
    _port_engine("fused", bn_mode="batch").run(reqs)
    for r, want in zip(reqs, _jax_served("batch")):
        np.testing.assert_allclose(r.logits, want, atol=1e-4)


def test_soft_fail_reasons_and_wave_report_match_reference():
    """Every defect fails its own slot with the reference's reason; the
    wave's good request is served and the accounting agrees."""
    good_j, good_t = _requests(JRequest, 1), _requests(GraphRequest, 1)
    wave_j = _bad_requests(JRequest)[:3] + good_j
    wave_t = _bad_requests(GraphRequest)[:3] + good_t
    rep_j = _jax_engine("ell").run_wave(wave_j)
    rep_t = _port_engine("ell").run_wave(wave_t)
    assert dataclasses.asdict(rep_t) == dataclasses.asdict(rep_j)
    assert rep_t.n_failed == 3
    for rj, rt in zip(wave_j, wave_t):
        assert (rt.failed, rt.done, rt.error) == (rj.failed, rj.done,
                                                   rj.error)
    np.testing.assert_allclose(wave_t[-1].logits, wave_j[-1].logits,
                               atol=1e-4)
    # the ELL degree guard fails the star only under an ELL-class impl
    star_j, star_t = _bad_requests(JRequest)[3], _bad_requests(GraphRequest)[3]
    _jax_engine("ell").run_wave([star_j])
    _port_engine("pallas_ell").run_wave([star_t])
    assert star_t.failed and star_t.error == star_j.error
    assert "k_pad" in star_t.error
    star_t = _bad_requests(GraphRequest)[3]
    _port_engine("pallas_coo").run_wave([star_t])
    assert star_t.done and not star_t.failed


@pytest.mark.parametrize("impl", ("fused", "pallas_coo"))
def test_wave_composition_invariance_bitwise_on_cpu(impl):
    """bn_mode='sample': a request's logits are bitwise the same alone and
    inside a full wave with other molecules."""
    eng = _port_engine(impl)
    alone = _requests(GraphRequest, 4)
    eng.run_wave(alone[:1])
    crowd = _requests(GraphRequest, 4)
    eng.run_wave(crowd[::-1])
    np.testing.assert_array_equal(alone[0].logits, crowd[0].logits)


def test_engine_contract_raises(monkeypatch):
    cfg, np_params = _params("sample")
    # impl="auto" serves with the impl its first layer resolves to on the
    # CPU, bit for bit
    auto = _port_engine("auto")
    d = auto.layer_decision()
    assert d.source == "model" and not d.impl.startswith(("pallas", "fused"))
    served = auto.run(_requests(GraphRequest))
    pinned = _port_engine(d.impl).run(_requests(GraphRequest))
    for a, p in zip(served, pinned):
        np.testing.assert_array_equal(a.logits, p.logits)
    with pytest.raises(TypeError, match="mesh"):
        _port_engine("fused", mesh=object())
    eng = _port_engine("fused")
    # a storage policy is accepted, in the config or as the engine's
    # override; an unknown one raises
    for kw, cfg in (({}, dataclasses.replace(eng.cfg, precision="bf16")),
                    ({"precision": "i8"}, eng.cfg)):
        e2 = GraphServeEngine(eng.params, cfg, **GEOM, device="cpu", **kw)
        assert e2.cfg.precision in ("bf16", "i8")
    assert eng.cfg.precision == "f32"
    with pytest.raises(ValueError, match="precision"):
        GraphServeEngine(eng.params, eng.cfg, **GEOM, precision="fp8",
                         device="cpu")
    d = eng.layer_decision()
    assert (d.impl, d.source, d.workload.key()) == (
        "fused", "forced", "b4_m16_nnz64_k8_n64_i4_c4_nin62")
    with pytest.raises(NotImplementedError):
        eng.compiled_programs()
    with pytest.raises(ValueError, match="slots"):
        eng.run_wave(_requests(GraphRequest, 5))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _port_engine("fused", device=None)


def test_engine_assemble_forward_split_and_device():
    eng = _port_engine("fused")
    phases = []
    reqs = _requests(GraphRequest, 2)
    eng.run_wave(reqs, on_phase=phases.append)
    assert phases == ["assembled", "forward"]
    assert all(r.done for r in reqs)
    w = eng.assemble(_requests(GraphRequest, 2))
    assert w.x.device.type == "cpu" and w.x.shape == (4, 16, 62)
    assert [s for s, _ in w.served] == [0, 1]
    assert all(int(a.nnz[2:].sum()) == 0 for a in w.adj)   # empty slots
    logits = eng.forward(w)
    assert logits.shape == (4, 12) and torch.isfinite(logits).all()
    assert not logits.requires_grad
