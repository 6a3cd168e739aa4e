"""Port parity: ChemGCN end to end (params_from_jax + apply_gcn, the data
generator, the graph-conv layer) against the JAX reference on the CPU.

The reference runs ``impl="ref"`` (XLA) and ``impl="fused"`` (its Pallas
kernel in interpret mode); the port runs every impl of its registry, which
on CPU tensors means the kernels' plain versions. Logits agree to 1e-4.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gcn as jgcn
from repro.core.graph_conv import graph_conv_nonbatched as j_nonbatched
from repro.data import graphs as jgraphs
from repro_torch.convert import params_from_jax
from repro_torch.core import gcn as tgcn
from repro_torch.core.graph_conv import graph_conv_nonbatched
from repro_torch.data import graphs as tgraphs
from test_torch_formats import to_np, torch_coo

ATOL = 1e-4
PORT_IMPLS = ("ref", "ell", "csr", "dense", "loop", "pallas_ell",
              "pallas_csr", "pallas_coo", "fused", "hybrid", "pallas_hybrid",
              "pallas_gemm", "fused_hybrid")


@functools.lru_cache(maxsize=None)
def _setup(kind: str):
    """(cfg_jax, np_params, jax batch, port batch) for a small Tox21 wave or
    a narrow Reaction100-shaped multiclass one (three layers)."""
    if kind == "tox21":
        spec = jgraphs.GraphDatasetSpec.tox21_like(n_samples=8)
        cfg = jgcn.GCNConfig.tox21(impl="ref")
    else:
        spec = jgraphs.GraphDatasetSpec.reaction100_like(
            n_samples=6, max_nodes=20, size_dist="skewed")
        cfg = dataclasses.replace(jgcn.GCNConfig.reaction100(impl="ref"),
                                  conv_widths=(24,) * 3)
    params = jgcn.init_gcn(jax.random.key(5), cfg)
    # non-trivial BN affine parameters, so the BN path is really compared
    rng = np.random.default_rng(6)
    for bn in params["bns"]:
        bn["scale"] = jnp.asarray(rng.uniform(0.5, 1.5, bn["scale"].shape),
                                  jnp.float32)
        bn["bias"] = jnp.asarray(rng.normal(size=bn["bias"].shape),
                                 jnp.float32)
    np_params = jax.tree.map(np.asarray, params)
    tspec = tgraphs.GraphDatasetSpec(**dataclasses.asdict(spec))
    bj = next(jgraphs.batches(jgraphs.generate(spec), spec, spec.n_samples))
    bt = next(tgraphs.batches(tgraphs.generate(tspec), tspec, spec.n_samples))
    return cfg, np_params, bj, bt


def _port_cfg(cfg, **kw):
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(tgcn.GCNConfig)}
    return dataclasses.replace(tgcn.GCNConfig(**fields), **kw)


@functools.lru_cache(maxsize=None)
def _jax_logits(kind: str, bn_mode: str, impl: str) -> np.ndarray:
    cfg, np_params, bj, _ = _setup(kind)
    cfg = dataclasses.replace(cfg, bn_mode=bn_mode, impl=impl,
                              interpret=True)
    params = jax.tree.map(jnp.asarray, np_params)
    return to_np(jgcn.apply_gcn(params, cfg, bj["adj"], bj["x"],
                                bj["n_nodes"]))


def _port_logits(kind: str, bn_mode: str, impl: str, **cfg_kw):
    cfg, np_params, _, bt = _setup(kind)
    pcfg = _port_cfg(cfg, bn_mode=bn_mode, impl=impl, **cfg_kw)
    params = params_from_jax(np_params, pcfg, device="cpu")
    return tgcn.apply_gcn(params, pcfg, bt["adj"], bt["x"],
                          bt["n_nodes"]).numpy()


@pytest.mark.parametrize("bn_mode", ("batch", "sample"))
@pytest.mark.parametrize("impl", PORT_IMPLS)
def test_tox21_logits_match_reference(impl, bn_mode):
    got = _port_logits("tox21", bn_mode, impl)
    assert got.shape == (8, 12)
    np.testing.assert_allclose(got, _jax_logits("tox21", bn_mode, "ref"),
                               atol=ATOL, err_msg=f"{impl} {bn_mode}")


@pytest.mark.parametrize("bn_mode", ("batch", "sample"))
def test_fused_matches_reference_pallas_interpret(bn_mode):
    np.testing.assert_allclose(_port_logits("tox21", bn_mode, "fused"),
                               _jax_logits("tox21", bn_mode, "fused"),
                               atol=ATOL)


@pytest.mark.parametrize("impl", ("fused", "pallas_coo"))
def test_reaction100_shaped_multiclass_matches_reference(impl):
    got = _port_logits("r100", "sample", impl)
    assert got.shape == (6, 100)
    np.testing.assert_allclose(got, _jax_logits("r100", "sample", "ref"),
                               atol=ATOL)


def test_nonbatched_baseline_matches_reference():
    got = _port_logits("tox21", "batch", "ref", batched=False)
    np.testing.assert_allclose(got, _jax_logits("tox21", "batch", "ref"),
                               atol=ATOL)
    cfg, np_params, bj, bt = _setup("tox21")
    conv = jax.tree.map(jnp.asarray, np_params["convs"][0])
    want = to_np(j_nonbatched(conv, bj["adj"], bj["x"]))
    tconv = {k: torch.from_numpy(v.copy())
             for k, v in np_params["convs"][0].items()}
    got = graph_conv_nonbatched(tconv, bt["adj"], bt["x"]).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("size_dist", ("uniform", "skewed"))
def test_generate_and_batches_bitwise_equal(size_dist):
    spec = jgraphs.GraphDatasetSpec.tox21_like(n_samples=12,
                                               size_dist=size_dist, seed=3)
    tspec = tgraphs.GraphDatasetSpec(**dataclasses.asdict(spec))
    dj, dt = jgraphs.generate(spec), tgraphs.generate(tspec)
    assert len(dj) == len(dt)
    for a, b in zip(dj, dt):
        assert a.n_nodes == b.n_nodes
        for x, y in zip(a.rows + a.cols, b.rows + b.cols):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype
        np.testing.assert_array_equal(a.features, b.features)
        np.testing.assert_array_equal(a.label, b.label)
    bj = next(jgraphs.batches(dj, spec, 5, seed=1))
    bt = next(tgraphs.batches(dt, tspec, 5, seed=1))
    for aj, at in zip(bj["adj"], bt["adj"]):
        for f in dataclasses.fields(aj):
            np.testing.assert_array_equal(
                getattr(at, f.name).numpy(), to_np(getattr(aj, f.name)))
    for k in ("x", "n_nodes", "labels"):
        np.testing.assert_array_equal(bt[k].numpy(), to_np(bj[k]))


def test_gcn_module_mirrors_reference_names():
    cfg, np_params, _, bt = _setup("tox21")
    pcfg = _port_cfg(cfg, impl="fused", bn_mode="sample")
    model = tgcn.GCN(pcfg, params_from_jax(np_params, pcfg, device="cpu"))
    names = set(dict(model.named_parameters()))
    assert {"convs.0.w", "convs.1.b", "bns.1.scale", "bns.0.bias",
            "head.w", "head.b"} <= names
    with torch.inference_mode():
        got = model(bt["adj"], bt["x"], bt["n_nodes"]).numpy()
    np.testing.assert_allclose(got, _port_logits("tox21", "sample", "fused"),
                               rtol=0, atol=0)
    fresh = tgcn.GCN(pcfg, generator=torch.Generator().manual_seed(0),
                     device="cpu")
    w = fresh.convs[0]["w"]
    assert w.shape == (4, 62, 64) and w.abs().max() <= 1 / np.sqrt(62)


def test_unported_config_and_device_paths_raise(monkeypatch):
    cfg, np_params, _, bt = _setup("tox21")
    params = params_from_jax(np_params, _port_cfg(cfg), device="cpu")
    for kw, err in (({"impl": "auto"}, ValueError),
                    ({"layer": "gat", "batched": False}, ValueError),
                    ({"layer": "rgcn", "batched": False}, ValueError),
                    ({"layer": "sage"}, ValueError),
                    ({"precision": "fp8"}, ValueError),
                    ({"bn_mode": "global"}, ValueError)):
        with pytest.raises(err):
            tgcn.apply_gcn(params, _port_cfg(cfg, **kw), bt["adj"], bt["x"],
                           bt["n_nodes"])
    # the precision variants and policies are ported: a pinned variant runs
    # (within TOLS["bf16"] of ref) and precision, which steers only "auto",
    # leaves a pinned impl's logits unchanged
    for kw in ({"impl": "fused_bf16"}, {"precision": "bf16"},
               {"impl": "pallas_csr_i8", "precision": "i8"}):
        got = tgcn.apply_gcn(params, _port_cfg(cfg, **kw), bt["adj"],
                             bt["x"], bt["n_nodes"])
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), _port_logits(
            "tox21", cfg.bn_mode, cfg.impl), atol=8e-2, rtol=2e-2,
            err_msg=str(kw))
    # a grad-requiring input takes finite gradients that match impl="ref"
    dx = {}
    for impl in ("fused", "ref"):
        x = bt["x"].clone().requires_grad_()
        tgcn.apply_gcn(params, _port_cfg(cfg, impl=impl), bt["adj"], x,
                       bt["n_nodes"]).sum().backward()
        assert torch.isfinite(x.grad).all()
        dx[impl] = x.grad
    torch.testing.assert_close(dx["fused"], dx["ref"], atol=3e-4, rtol=3e-5)
    with pytest.raises(ValueError, match="divisible"):
        tgcn.init_gcn(_port_cfg(cfg, layer="gat", heads=5), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(np_params, _port_cfg(cfg, conv_widths=(32, 64)),
                        device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgcn.init_gcn(_port_cfg(cfg))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax(np_params, _port_cfg(cfg))


def test_torch_coo_round_trip():
    _, _, bj, bt = _setup("tox21")
    for aj, at in zip(bj["adj"], bt["adj"]):
        ct = torch_coo(aj)
        assert all(torch.equal(getattr(ct, f.name), getattr(at, f.name))
                   for f in dataclasses.fields(aj))
