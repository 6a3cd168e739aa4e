"""Port parity: the GNN layers (GAT, R-GCN) and ChemGCN with
``layer="gat"``/``"rgcn"`` against the JAX reference on the CPU.

The same numpy parameters and batches go through both packages: the layers
alone (forward and the gradients of every parameter and of x), ``apply_gcn``
and ``gcn_loss`` at narrow widths, a few ``GCNTrainer`` steps from one
numpy state, checkpoints crossing the packages bitwise, and the serving
engine. The reference runs ``impl="ref"`` (its grouped matmul in interpret
mode); the port runs its g-SpMM impls, the kernel wrappers' plain versions
on the CPU. Tolerances: ``tests/oracle.py`` f32 (1e-4, 1e-5) for outputs,
3x for parameter gradients (the layer-gradient rule).
"""
import dataclasses
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import TOLS
from repro.core import formats as jf
from repro.core import gcn as jgcn
from repro.data import graphs as jgraphs
from repro.models import gnn as jgnn
from repro.optim import adam as jadam
from repro.serving.engine import GraphRequest as JRequest
from repro.serving.engine import GraphServeEngine as JEngine
from repro.training import GCNTrainer as JTrainer
from repro.training import TrainerConfig as JTrainerConfig
from repro_torch import tree
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.core import gcn as tgcn
from repro_torch.data import graphs as tgraphs
from repro_torch.kernels import grouped_matmul as tgmm
from repro_torch.kernels import ops
from repro_torch.models import gnn as tgnn
from repro_torch.serving.engine import GraphRequest, GraphServeEngine
from repro_torch.training.trainer import GCNTrainer, TrainerConfig
from test_torch_formats import to_np, torch_coo
from test_torch_gcn import _port_cfg

ATOL, RTOL = TOLS["f32"]
LAYER_IMPLS = ("ref", "csr", "ell", "pallas_coo", "pallas_csr", "pallas_ell")
MODEL_IMPLS = ("ref", "pallas_coo", "pallas_csr", "pallas_ell")


def _close(got, want, what, scale=1):
    np.testing.assert_allclose(got, want, atol=scale * ATOL,
                               rtol=scale * RTOL, err_msg=what)


@functools.lru_cache(maxsize=None)
def _layer_case(layer: str):
    """(jax adjacencies, np x, np params, m_pad): three graphs of 10-16
    nodes (the reference's test geometry), two relations for R-GCN."""
    rng = np.random.default_rng(5)
    coo, m_pad = jf.random_batch(rng, batch=3, dim=(10, 16),
                                 nnz_per_row=(1, 4))
    x = rng.normal(size=(3, m_pad, 10)).astype(np.float32)
    if layer == "gat":
        p = jgnn.init_gat_layer(jax.random.PRNGKey(2), 10, 8, 2)
        adj = [coo]
    else:
        adj = [coo, jf.random_batch(np.random.default_rng(21), batch=3,
                                    dim=m_pad, nnz_per_row=2)[0]]
        p = jgnn.init_rgcn_layer(jax.random.PRNGKey(3), 10, 8, 2)
        # a non-zero bias, so that its gradient path is compared too
    p["b"] = jnp.asarray(rng.normal(size=p["b"].shape), jnp.float32)
    return adj, x, jax.tree.map(np.asarray, p), m_pad


def _j_layer(layer, p, adj, x):
    if layer == "gat":
        return jgnn.gat_layer(p, adj[0], x, impl="ref")
    return jgnn.rgcn_layer(p, adj, x, impl="ref", interpret=True)


@functools.lru_cache(maxsize=None)
def _jax_layer(layer: str):
    """(out, grads of sum(out²) wrt params, wrt x) of the reference."""
    adj, x, np_p, _ = _layer_case(layer)

    @jax.jit
    def f(p, xx):
        out = _j_layer(layer, p, adj, xx)
        return out, jax.grad(lambda pp, x2: jnp.sum(
            _j_layer(layer, pp, adj, x2) ** 2), argnums=(0, 1))(p, xx)

    out, (gp, gx) = f(jax.tree.map(jnp.asarray, np_p), jnp.asarray(x))
    return to_np(out), jax.tree.map(to_np, gp), to_np(gx)


@pytest.mark.parametrize("impl", LAYER_IMPLS)
@pytest.mark.parametrize("layer", ("gat", "rgcn"))
def test_gnn_layer_matches_reference(layer, impl):
    adj, x, np_p, m_pad = _layer_case(layer)
    params = {k: torch.from_numpy(v.copy()).requires_grad_()
              for k, v in np_p.items()}
    xt = torch.from_numpy(x).requires_grad_()
    tadj = [torch_coo(a) for a in adj]
    k_pad = max(int(jf.max_row_degree(a, m_pad).max()) for a in adj)
    if layer == "gat":
        out = tgnn.gat_layer(params, tadj[0], xt, impl=impl, k_pad=k_pad)
    else:
        out = tgnn.rgcn_layer(params, tadj, xt, impl=impl, k_pad=k_pad)
    (out ** 2).sum().backward()
    want_out, want_gp, want_gx = _jax_layer(layer)
    _close(out.detach().numpy(), want_out, f"{layer} {impl} forward")
    for k, p in params.items():
        _close(p.grad.numpy(), want_gp[k], f"{layer} {impl} d{k}", 3)
    _close(xt.grad.numpy(), want_gx, f"{layer} {impl} dx", 3)


@functools.lru_cache(maxsize=None)
def _model_setup(layer: str):
    """(reference cfg, np params, jax batch, port batch): narrow ChemGCN
    (62 -> 16 -> 16, 12 tasks, 4 heads) on 8 Tox21-like molecules."""
    cfg = dataclasses.replace(jgcn.GCNConfig.tox21(impl="ref", layer=layer,
                                                   interpret=True),
                              conv_widths=(16, 16))
    params = jgcn.init_gcn(jax.random.key(7), cfg)
    rng = np.random.default_rng(8)
    for bn in params["bns"]:
        bn["scale"] = jnp.asarray(rng.uniform(0.5, 1.5, bn["scale"].shape),
                                  jnp.float32)
        bn["bias"] = jnp.asarray(rng.normal(size=bn["bias"].shape),
                                 jnp.float32)
    spec = jgraphs.GraphDatasetSpec.tox21_like(n_samples=8, seed=4)
    tspec = tgraphs.GraphDatasetSpec(**dataclasses.asdict(spec))
    bj = next(jgraphs.batches(jgraphs.generate(spec), spec, 8))
    bt = next(tgraphs.batches(tgraphs.generate(tspec), tspec, 8))
    return cfg, jax.tree.map(np.asarray, params), bj, bt


@functools.lru_cache(maxsize=None)
def _jax_model(layer: str):
    """(logits with bn_mode="sample", loss, grads) of the reference."""
    cfg, np_params, bj, _ = _model_setup(layer)
    params = jax.tree.map(jnp.asarray, np_params)
    @jax.jit
    def f(p):
        logits = jgcn.apply_gcn(p, dataclasses.replace(cfg, bn_mode="sample"),
                                bj["adj"], bj["x"], bj["n_nodes"])
        return logits, *jax.value_and_grad(lambda pp: jgcn.gcn_loss(
            pp, cfg, bj["adj"], bj["x"], bj["n_nodes"], bj["labels"])[0])(p)

    logits, loss, grads = f(params)
    return to_np(logits), float(loss), jax.tree.leaves(
        jax.tree.map(to_np, grads))


@pytest.mark.parametrize("impl", MODEL_IMPLS)
@pytest.mark.parametrize("layer", ("gat", "rgcn"))
def test_apply_gcn_and_gcn_loss_match_reference(layer, impl):
    cfg, np_params, _, bt = _model_setup(layer)
    pcfg = _port_cfg(cfg, impl=impl)
    params = params_from_jax(np_params, pcfg, device="cpu")
    want_logits, want_loss, want_grads = _jax_model(layer)
    logits = tgcn.apply_gcn(params, dataclasses.replace(pcfg,
                                                        bn_mode="sample"),
                            bt["adj"], bt["x"], bt["n_nodes"])
    _close(logits.numpy(), want_logits, f"{layer} {impl} logits")
    leaves = [p.requires_grad_() for p in tree.leaves(params)]
    loss, _ = tgcn.gcn_loss(params, pcfg, bt["adj"], bt["x"], bt["n_nodes"],
                            bt["labels"])
    grads = torch.autograd.grad(loss, leaves)
    _close(loss.item(), want_loss, f"{layer} {impl} loss")
    assert len(grads) == len(want_grads)
    for i, (g, w) in enumerate(zip(grads, want_grads)):
        assert torch.isfinite(g).all()
        _close(g.numpy(), w, f"{layer} {impl} grad leaf {i}", 3)


def _batches(pkg, n_steps=4, batch=4, seed=0):
    spec = pkg.GraphDatasetSpec.tox21_like(n_samples=n_steps * batch,
                                           seed=seed)
    return list(pkg.batches(pkg.generate(spec), spec, batch, seed=seed))


@pytest.mark.parametrize("layer,impl", [("gat", "pallas_csr"),
                                        ("rgcn", "pallas_coo")])
def test_trainer_steps_track_reference(layer, impl, tmp_path):
    """Four GCNTrainer steps from one numpy state (params_from_jax,
    opt_state_from_jax) against the reference's losses (its gradient and
    Adam steps) on bitwise-equal batches."""
    cfg, np_params, _, _ = _model_setup(layer)
    pcfg = _port_cfg(cfg, impl=impl)
    trainer = GCNTrainer(pcfg, tcfg=TrainerConfig(str(tmp_path)),
                         device="cpu")
    params = params_from_jax(np_params, pcfg, device="cpu")
    state = opt_state_from_jax(jax.tree.map(np.asarray, jadam.adam_init(
        np_params)), pcfg, device="cpu")
    opt = jadam.AdamConfig(lr=3e-3)
    jp = jax.tree.map(jnp.asarray, np_params)
    js = jadam.adam_init(jp)

    @jax.jit
    def j_step(p, s, adj, x, n_nodes, labels):
        loss, g = jax.value_and_grad(lambda pp: jgcn.gcn_loss(
            pp, cfg, adj, x, n_nodes, labels)[0])(p)
        p, s = jadam.adam_update(opt, p, g, s)
        return p, s, loss

    for bj, bt in zip(_batches(jgraphs), _batches(tgraphs)):
        params, state, m = trainer.train_step(params, state,
                                              trainer.place_batch(bt))
        jp, js, j_loss = j_step(jp, js, bj["adj"], bj["x"], bj["n_nodes"],
                                bj["labels"])
        _close(m["loss"].item(), float(j_loss), f"{layer} loss")
    # parameters are not compared: a conv bias ahead of batch-norm has a
    # gradient at rounding level, whose sign Adam turns into steps of lr
    assert int(state["step"]) == int(js["step"]) == 4


@pytest.mark.parametrize("layer", ("gat", "rgcn"))
def test_checkpoints_cross_packages_bitwise(layer, tmp_path):
    """The port's checkpoint of a GAT/R-GCN model restores bitwise in the
    reference, and the reference's in the port (the leaf order of the new
    trees matches)."""
    cfg, _, _, _ = _model_setup(layer)
    pcfg = _port_cfg(cfg, impl="ref")
    ck = str(tmp_path / "port")
    tt = GCNTrainer(pcfg, tcfg=TrainerConfig(ck, checkpoint_every=1),
                    device="cpu")
    tt.fit(_batches(tgraphs, n_steps=2), epochs=1)
    t_params, t_state, _ = tt.restore_or_init()
    jt = JTrainer(cfg, tcfg=JTrainerConfig(checkpoint_dir=ck),
                  telemetry=False)
    j_params, j_state, start = jt.restore_or_init()
    assert start == 2
    got = tree.leaves((t_params, t_state))
    want = jax.tree.leaves((j_params, j_state))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())

    ck2 = str(tmp_path / "ref")
    jt2 = JTrainer(cfg, tcfg=JTrainerConfig(checkpoint_dir=ck2,
                                            checkpoint_every=1),
                   telemetry=False)
    jt2.fit(_batches(jgraphs, n_steps=1), epochs=1)
    j_params, j_state, _ = jt2.restore_or_init()
    t_params, t_state, start = GCNTrainer(
        pcfg, tcfg=TrainerConfig(ck2), device="cpu").restore_or_init()
    assert start == 1
    for g, w in zip(tree.leaves((t_params, t_state)),
                    jax.tree.leaves((j_params, j_state))):
        w = np.asarray(w)
        assert g.dtype == torch.from_numpy(w).dtype
        np.testing.assert_array_equal(g.numpy(), w)


def _requests(cls, n=6):
    spec = jgraphs.GraphDatasetSpec.tox21_like(n_samples=n, max_nodes=14,
                                               seed=2)
    return [cls(rows=list(s.rows), cols=list(s.cols), features=s.features,
                n_nodes=s.n_nodes) for s in jgraphs.generate(spec)]


def _star(cls, channel: int):
    """A request whose row 0 has degree 9 in ``channel``."""
    z = np.zeros(0, np.int32)
    rows, cols = [z] * 4, [z] * 4
    rows[channel] = np.zeros(9, np.int32)
    cols[channel] = np.arange(1, 10, dtype=np.int32)
    return cls(rows=rows, cols=cols, features=np.zeros((10, 62), np.float32),
               n_nodes=10)


@pytest.mark.parametrize("layer", ("gat", "rgcn"))
def test_serving_matches_reference_and_ell_guard(layer):
    """Logits of the port's engine (pallas_ell's plain version) against the
    reference engine (its plain ell) on the same requests, request-alone invariance,
    and the ELL degree guard: like the reference, it soft-fails a request
    whose degree passes k_pad in ANY channel, for GAT (whose layers read
    channel 0 only) as for R-GCN (every channel a relation)."""
    cfg, np_params, _, _ = _model_setup(layer)
    geom = dict(batch=4, m_pad=16, nnz_pad=64)
    jcfg = dataclasses.replace(cfg, bn_mode="sample", impl="ell")
    jreqs = _requests(JRequest) + [_star(JRequest, 0), _star(JRequest, 2)]
    JEngine(jax.tree.map(jnp.asarray, np_params), jcfg, **geom).run(jreqs)
    pcfg = _port_cfg(cfg, impl="pallas_ell", bn_mode="sample")
    eng = GraphServeEngine(params_from_jax(np_params, pcfg, device="cpu"),
                           pcfg, device="cpu", **geom)
    treqs = _requests(GraphRequest) + [_star(GraphRequest, 0),
                                       _star(GraphRequest, 2)]
    eng.run(treqs)
    for j, t in zip(jreqs, treqs):
        assert (t.done, t.failed, t.error) == (j.done, j.failed, j.error)
        if t.done:
            _close(t.logits, np.asarray(j.logits), f"{layer} logits")
    assert [t.failed for t in treqs] == [False] * 6 + [True, True]
    assert "k_pad" in treqs[-1].error
    alone = _requests(GraphRequest, 1)
    eng.run_wave(alone)
    np.testing.assert_array_equal(alone[0].logits, treqs[0].logits)


def test_layer_config_errors():
    """The reference's errors: heads must divide every conv width, GAT and
    R-GCN need batched=True, an unknown layer kind raises, and a GNN layer
    takes only the g-SpMM impls."""
    with pytest.raises(ValueError, match="divisible"):
        tgcn.init_gcn(tgcn.GCNConfig.tox21(layer="gat", heads=3),
                      device="cpu")
    with pytest.raises(ValueError, match="unknown layer kind"):
        tgcn.init_gcn(tgcn.GCNConfig.tox21(layer="sage"), device="cpu")
    cfg, np_params, _, bt = _model_setup("gat")
    with pytest.raises(ValueError, match="divisible"):
        params_from_jax(np_params, _port_cfg(cfg, heads=3), device="cpu")
    with pytest.raises(ValueError, match="leaves"):
        params_from_jax(np_params, _port_cfg(cfg, layer="rgcn"),
                        device="cpu")
    for layer in ("gat", "rgcn"):
        cfg, np_params, _, bt = _model_setup(layer)
        params = params_from_jax(np_params, _port_cfg(cfg), device="cpu")
        with pytest.raises(ValueError, match="requires batched=True"):
            tgcn.apply_gcn(params, _port_cfg(cfg, batched=False), bt["adj"],
                           bt["x"], bt["n_nodes"])
        for impl in ("fused", "pallas_gemm", "pallas_hybrid"):
            with pytest.raises(ValueError, match="cannot run g-SpMM"):
                tgcn.apply_gcn(params, _port_cfg(cfg, impl=impl), bt["adj"],
                               bt["x"], bt["n_nodes"])
    model = tgcn.GCN(_port_cfg(cfg), generator=torch.Generator().manual_seed(
        0), device="cpu")
    assert {"convs.0.w_rel", "convs.1.w_self", "convs.0.b", "head.w"} <= set(
        dict(model.named_parameters()))


@pytest.mark.parametrize("layer,impl,per_forward,per_step", [
    ("rgcn", "pallas_csr", {"_gmm": 2, "batched_spmm_csr": 2},
     {"_gmm": 3, "batched_spmm_csr": 2}),
    ("rgcn", "pallas_ell", {"_gmm": 2, "batched_spmm_ell": 2},
     {"_gmm": 3, "batched_spmm_ell": 2}),
    ("gat", "pallas_coo", {"batched_spmm_coo": 2}, {"batched_spmm_coo": 2}),
    ("gat", "pallas_csr", {"batched_spmm_csr": 2}, {"batched_spmm_csr": 2}),
])
def test_kernel_calls_per_wave_and_per_step(monkeypatch, tmp_path, layer,
                                            impl, per_forward, per_step):
    """The kernel wrappers a GNN forward and a training step call (each
    would launch its kernel on the card): R-GCN one grouped matmul and one
    g-SpMM per layer, plus the grouped matmul of dx in layer 2 only (layer
    1's input takes no gradient); GAT one g-SpMM per layer; both
    backwards of the g-SpMM are plain."""
    calls = {}
    targets = [(ops, n) for n in ("batched_spmm_ell", "batched_spmm_csr",
                                  "batched_spmm_coo")] + [(tgmm, "_gmm")]
    for mod, name in targets:
        real = getattr(mod, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **kw)

        monkeypatch.setattr(mod, name, counted)
    cfg, np_params, _, bt = _model_setup(layer)
    pcfg = _port_cfg(cfg, impl=impl)
    params = params_from_jax(np_params, pcfg, device="cpu")
    with torch.inference_mode():
        tgcn.apply_gcn(params, pcfg, bt["adj"], bt["x"], bt["n_nodes"])
    assert calls == per_forward
    calls.clear()
    trainer = GCNTrainer(pcfg, tcfg=TrainerConfig(str(tmp_path)),
                         device="cpu")
    state = trainer.init_state()[1]
    trainer.train_step(params, state, trainer.place_batch(bt))
    assert calls == per_step
    shutil.rmtree(tmp_path, ignore_errors=True)
