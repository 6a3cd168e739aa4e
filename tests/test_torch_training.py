"""Port parity: ChemGCN training (``gcn_loss``, Adam, checkpoints,
``GCNTrainer``) against the JAX reference on the CPU.

Both packages start from one numpy state (``params_from_jax``,
``opt_state_from_jax``) and see bitwise-equal batches. Tolerances:
loss at the f32 tolerance of ``tests/oracle.py`` (1e-4 abs, 1e-5 rel) and
parameter gradients at 3x it (the layer-gradient rule); Adam states at the
f32 tolerance; 20-step loss curves within 1e-4 relative (Adam turns
last-bit gradient differences into parameter differences of up to ``lr``
where a gradient is near 0, so parameters are not compared after many
steps); checkpoints bitwise.
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
from repro.checkpoint import load_pytree as j_load
from repro.core import gcn as jgcn
from repro.data import graphs as jgraphs
from repro.optim import adam as jadam
from repro.training import GCNTrainer as JTrainer
from repro.training import TrainerConfig as JTrainerConfig
from repro_torch import tree
from repro_torch.checkpoint.store import (
    CheckpointManager,
    load_pytree,
    save_pytree,
)
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.core import gcn as tgcn
from repro_torch.data import graphs as tgraphs
from repro_torch.optim import adam as tadam
from repro_torch.training.trainer import GCNTrainer, TrainerConfig
from test_torch_formats import to_np
from test_torch_gcn import _port_cfg, _setup

ATOL, RTOL = TOLS["f32"]
CURVE_RTOL = 1e-4
SPMM_CLASS_IMPLS = ("ref", "ell", "pallas_ell", "csr", "pallas_csr",
                    "pallas_coo", "dense", "loop", "fused")


def _j_loss_fn(cfg):
    @jax.jit
    def f(params, adj, x, n_nodes, labels):
        return jax.value_and_grad(
            lambda p: jgcn.gcn_loss(p, cfg, adj, x, n_nodes, labels),
            has_aux=True)(params)

    return f


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(kind: str):
    cfg, np_params, bj, _ = _setup(kind)
    (loss, acc), grads = _j_loss_fn(cfg)(
        jax.tree.map(jnp.asarray, np_params), bj["adj"], bj["x"],
        bj["n_nodes"], bj["labels"])
    return float(loss), float(acc), jax.tree.map(to_np, grads)


@pytest.mark.parametrize("kind,impl", [("tox21", i) for i in SPMM_CLASS_IMPLS]
                         + [("r100", i) for i in ("ref", "fused",
                                                  "pallas_csr")])
def test_gcn_loss_and_grads_match_reference(kind, impl):
    cfg, np_params, _, bt = _setup(kind)
    pcfg = _port_cfg(cfg, impl=impl)
    params = params_from_jax(np_params, pcfg, device="cpu")
    leaves = [p.requires_grad_() for p in tree.leaves(params)]
    loss, acc = tgcn.gcn_loss(params, pcfg, bt["adj"], bt["x"], bt["n_nodes"],
                              bt["labels"])
    grads = torch.autograd.grad(loss, leaves)
    want_loss, want_acc, want_grads = _jax_loss_and_grads(kind)
    np.testing.assert_allclose(loss.item(), want_loss, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(acc.item(), want_acc, atol=ATOL, rtol=RTOL)
    want = jax.tree.leaves(want_grads)
    assert len(grads) == len(want) == 4 * len(cfg.conv_widths) + 2
    for i, (g, w) in enumerate(zip(grads, want)):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), w, atol=3 * ATOL,
                                   rtol=3 * RTOL, err_msg=f"{impl} leaf {i}")


@pytest.mark.parametrize("variant", ("plain", "decay_and_clip", "cosine"))
def test_adam_update_matches_reference(variant):
    rng = np.random.default_rng(8)
    np_params = {"w": [rng.normal(size=(3, 4)).astype(np.float32),
                       rng.normal(size=(5,)).astype(np.float32)],
                 "b": rng.normal(size=(2, 2)).astype(np.float32)}
    cfg = {"plain": {}, "decay_and_clip": dict(weight_decay=0.01,
                                               grad_clip=0.5),
           "cosine": {}}[variant]
    jcfg, tcfg = jadam.AdamConfig(lr=3e-3, **cfg), tadam.AdamConfig(lr=3e-3,
                                                                   **cfg)
    jsched = tsched = None
    if variant == "cosine":
        jsched = jadam.cosine_schedule(3e-3, warmup=2, total=6)
        tsched = tadam.cosine_schedule(3e-3, warmup=2, total=6)
    jp = jax.tree.map(jnp.asarray, np_params)
    js = jadam.adam_init(jp)
    tp = tree.tree_map(lambda a: torch.from_numpy(a.copy()), np_params)
    ts = tadam.adam_init(tp)
    assert ts["step"].dtype == torch.int32 and ts["step"].shape == ()
    for _ in range(6):
        np_g = tree.tree_map(
            lambda a: rng.normal(size=a.shape).astype(np.float32), np_params)
        jp, js = jadam.adam_update(jcfg, jp, jax.tree.map(jnp.asarray, np_g),
                                   js, jsched)
        tp, ts = tadam.adam_update(tcfg, tp, tree.tree_map(torch.from_numpy,
                                                           np_g), ts, tsched)
        assert int(ts["step"]) == int(js["step"])
        for got, want in zip(tree.leaves((tp, ts["m"], ts["v"])),
                             jax.tree.leaves((jp, js["m"], js["v"]))):
            np.testing.assert_allclose(got.numpy(), to_np(want), atol=ATOL,
                                       rtol=RTOL)
    g = tree.tree_map(torch.from_numpy, np_g)
    clipped, norm = tadam.clip_by_global_norm(g, 0.5)
    jc, jn = jadam.clip_by_global_norm(jax.tree.map(jnp.asarray, np_g), 0.5)
    np.testing.assert_allclose(norm.item(), float(jn), rtol=RTOL)
    for a, b in zip(tree.leaves(clipped), jax.tree.leaves(jc)):
        np.testing.assert_allclose(a.numpy(), to_np(b), atol=ATOL, rtol=RTOL)


def _curve_batches(pkg, n_steps: int = 20, batch: int = 8):
    spec = pkg.GraphDatasetSpec.tox21_like(n_samples=5 * batch, seed=9)
    return list(pkg.batches(pkg.generate(spec), spec, batch, seed=0,
                            epochs=n_steps // 5))


@functools.lru_cache(maxsize=None)
def _jax_curve(impl: str):
    cfg, np_params, _, _ = _setup("tox21")
    cfg = dataclasses.replace(cfg, impl=impl)
    step_fn = _j_loss_fn(cfg)
    opt = jadam.AdamConfig(lr=3e-3)
    params = jax.tree.map(jnp.asarray, np_params)
    state = jadam.adam_init(params)
    losses, accs = [], []
    for b in _curve_batches(jgraphs):
        (loss, acc), grads = step_fn(params, b["adj"], b["x"], b["n_nodes"],
                                     b["labels"])
        params, state = jadam.adam_update(opt, params, grads, state)
        losses.append(float(loss))
        accs.append(float(acc))
    return np.asarray(losses), np.asarray(accs)


@pytest.mark.parametrize("impl,ref_impl", [
    ("ref", "ref"), ("csr", "csr"), ("ell", "ell"),
    ("pallas_csr", "csr"), ("pallas_ell", "ell"), ("pallas_coo", "ref"),
    ("fused", "ref")])
def test_twenty_adam_steps_track_reference_loss_curve(impl, ref_impl,
                                                      tmp_path):
    cfg, np_params, _, _ = _setup("tox21")
    pcfg = _port_cfg(cfg, impl=impl)
    trainer = GCNTrainer(pcfg, tcfg=TrainerConfig(str(tmp_path)),
                         device="cpu")
    params = params_from_jax(np_params, pcfg, device="cpu")
    state = opt_state_from_jax(jax.tree.map(
        np.asarray, jadam.adam_init(np_params)), pcfg, device="cpu")
    losses, accs = [], []
    for b in _curve_batches(tgraphs):
        params, state, m = trainer.train_step(params, state,
                                              trainer.place_batch(b))
        losses.append(m["loss"].item())
        accs.append(m["acc"].item())
    want_loss, want_acc = _jax_curve(ref_impl)
    assert int(state["step"]) == 20 and len(losses) == 20
    np.testing.assert_allclose(losses, want_loss, rtol=CURVE_RTOL)
    # a logit within rounding of 0 may flip one of 8 x 12 predictions
    np.testing.assert_allclose(accs, want_acc, atol=1 / 96 + 1e-7)
    assert losses[-1] < losses[0]


def _narrow_cfgs(impl: str = "ref"):
    jcfg = dataclasses.replace(jgcn.GCNConfig.tox21(impl=impl),
                               conv_widths=(16, 16))
    return jcfg, _port_cfg(jcfg)


def _tox21_batches(pkg, n_samples=8, batch=4, seed=0):
    spec = pkg.GraphDatasetSpec.tox21_like(n_samples=n_samples, seed=seed)
    return list(pkg.batches(pkg.generate(spec), spec, batch, seed=seed))


def test_gcn_resume_after_interruption(tmp_path):
    """The reference's resume test with the port's trainer: save, a fresh
    trainer (a fresh process: only the directory survives), resume."""
    cfg = tgcn.GCNConfig.tox21(impl="pallas_csr")
    tcfg = TrainerConfig(checkpoint_dir=str(tmp_path / "gcn_ck"),
                         checkpoint_every=1)
    batches_a = _tox21_batches(tgraphs)          # 2 steps
    t1 = GCNTrainer(cfg, tcfg=tcfg, device="cpu")
    p1, _, rec = t1.fit(batches_a, epochs=1)
    assert t1.manager.latest_step() == 2 and np.isfinite(rec["loss"])

    t2 = GCNTrainer(cfg, tcfg=tcfg, device="cpu")
    p2, s2, start = t2.restore_or_init()
    assert start == 2 and int(s2["step"]) == 2
    for a, c in zip(tree.leaves(p1), tree.leaves(p2)):
        assert torch.equal(a, c)

    # different data, same budget: every batch is already trained, so fit
    # fast-forwards and returns the restored parameters untouched
    batches_b = _tox21_batches(tgraphs, seed=1)
    t3 = GCNTrainer(cfg, tcfg=tcfg, device="cpu")
    p3, _, _ = t3.fit(batches_b, epochs=1)
    assert t3.manager.latest_step() == 2
    for a, c in zip(tree.leaves(p1), tree.leaves(p3)):
        assert torch.equal(a, c)

    # a longer budget continues training past the restored step
    t4 = GCNTrainer(cfg, tcfg=tcfg, device="cpu")
    seen = []
    t4.fit(batches_b, epochs=2, on_metrics=lambda e, r: seen.append(e))
    assert t4.manager.latest_step() == 4 and seen == [2]
    assert t4.restore_or_init()[2] == 4


def test_gcn_trainer_rejects_undersized_k_pad(tmp_path):
    bs = _tox21_batches(tgraphs)
    trainer = GCNTrainer(tgcn.GCNConfig.tox21(k_pad=1, impl="pallas_ell"),
                         tcfg=TrainerConfig(str(tmp_path),
                                            checkpoint_every=1000),
                         device="cpu")
    with pytest.raises(ValueError, match="max row degree"):
        trainer.fit(bs, epochs=1)
    assert trainer.manager.latest_step() is None


def test_reference_checkpoint_restores_bitwise_and_training_continues(
        tmp_path):
    """Two steps of the reference trainer, saved; the port's trainer
    restores that directory bitwise, and two more steps in each package
    give matching losses."""
    jcfg, pcfg = _narrow_cfgs()
    ck = str(tmp_path / "ck")
    jb, tb = _tox21_batches(jgraphs), _tox21_batches(tgraphs)
    jb, tb = jb + jb, tb + tb                     # four steps of data
    jt = JTrainer(jcfg, tcfg=JTrainerConfig(checkpoint_dir=ck,
                                            checkpoint_every=1),
                  telemetry=False)
    jt.fit(lambda e: [jb[e]], epochs=2)
    assert jt.manager.latest_step() == 2
    j_params, j_state, _ = jt.restore_or_init()

    tt = GCNTrainer(pcfg, tcfg=TrainerConfig(checkpoint_dir=ck),
                    device="cpu")
    t_params, t_state, start = tt.restore_or_init()
    assert start == 2
    for got, want in zip(tree.leaves((t_params, t_state)),
                         jax.tree.leaves((j_params, j_state))):
        want = np.asarray(want)
        assert got.dtype == torch.from_numpy(want).dtype
        np.testing.assert_array_equal(got.numpy(), want)

    def go(trainer, data):
        losses = []
        trainer.fit(lambda e: [data[e]], epochs=4,
                    on_metrics=lambda _, r: losses.append(r["loss"]))
        return losses

    ck2 = str(tmp_path / "ck_port")
    shutil.copytree(ck, ck2)
    t_losses = go(GCNTrainer(pcfg, tcfg=TrainerConfig(ck2, checkpoint_every=1),
                             device="cpu"), tb)
    j_losses = go(jt, jb)
    assert len(t_losses) == len(j_losses) == 2
    np.testing.assert_allclose(t_losses, j_losses, atol=ATOL, rtol=RTOL)


def test_port_checkpoint_restores_bitwise_in_reference(tmp_path):
    jcfg, pcfg = _narrow_cfgs("ref")
    ck = str(tmp_path / "ck")
    tt = GCNTrainer(pcfg, tcfg=TrainerConfig(ck, checkpoint_every=1),
                    device="cpu")
    t_params, t_state, _ = tt.fit(_tox21_batches(tgraphs), epochs=1)
    t_params, t_state, _ = tt.restore_or_init()
    jt = JTrainer(jcfg, tcfg=JTrainerConfig(checkpoint_dir=ck),
                  telemetry=False)
    j_params, j_state, start = jt.restore_or_init()
    assert start == 2
    for got, want in zip(tree.leaves((t_params, t_state)),
                         jax.tree.leaves((j_params, j_state))):
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_checkpoint_roundtrip_integrity_and_keep_k(tmp_path):
    t = {"a": torch.arange(10.0), "b": [torch.ones((3, 3)),
                                        torch.zeros((), dtype=torch.int32)]}
    save_pytree(t, str(tmp_path / "ck"))
    back = load_pytree(t, str(tmp_path / "ck"))
    for x, y in zip(tree.leaves(t), tree.leaves(back)):
        assert torch.equal(x, y) and x.dtype == y.dtype
    # the reference reads it back too
    for x, y in zip(tree.leaves(t), jax.tree.leaves(j_load(
            jax.tree.map(np.asarray, tree.tree_map(lambda v: v.numpy(), t)),
            str(tmp_path / "ck")))):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    with pytest.raises(IOError, match="leaves"):
        load_pytree({"a": t["a"]}, str(tmp_path / "ck"))
    npz = tmp_path / "ck" / "shard-0.npz"
    npz.write_bytes(npz.read_bytes()[:-20] + b"x" * 20)
    with pytest.raises(IOError, match="integrity"):
        load_pytree(t, str(tmp_path / "ck"))

    mgr = CheckpointManager(str(tmp_path / "m"), keep=2)
    (tmp_path / "m" / "step_0000000099.tmp-1").mkdir()   # a killed write
    for s in (10, 20, 30, 40):
        mgr.save(s, {"w": torch.ones(4)})
    assert mgr.steps() == [30, 40] and mgr.latest_step() == 40


def test_train_step_phases_and_metrics(tmp_path):
    trainer = GCNTrainer(tgcn.GCNConfig.tox21(impl="fused"),
                         tcfg=TrainerConfig(str(tmp_path)), device="cpu")
    params, state = trainer.init_state()
    phases = []
    batch = trainer.place_batch(_tox21_batches(tgraphs)[0])
    params, state, m = trainer.train_step(params, state, batch,
                                          on_phase=phases.append)
    assert phases == ["forward", "backward", "optimizer"]
    assert all(isinstance(v, torch.Tensor) and v.shape == () and
               not v.requires_grad for v in m.values())
    assert int(state["step"]) == 1 and float(m["grad_norm"]) > 0
    phases.clear()
    trainer.fit(_tox21_batches(tgraphs)[:1], on_phase=phases.append)
    assert phases == ["batch", "forward", "backward", "optimizer"]
    with pytest.raises(NotImplementedError):
        trainer.layer_decision(batch)
    with pytest.raises(ValueError, match="TrainerConfig"):
        GCNTrainer(tgcn.GCNConfig.tox21(impl="fused"), device="cpu")
    with pytest.raises(ValueError, match="auto"):
        GCNTrainer(tgcn.GCNConfig.tox21(), tcfg=TrainerConfig(str(tmp_path)),
                   device="cpu")


def test_trainer_and_state_conversion_default_to_cuda(monkeypatch, tmp_path):
    cfg, np_params, _, _ = _setup("tox21")
    np_state = jax.tree.map(np.asarray, jadam.adam_init(np_params))
    state = opt_state_from_jax(np_state, _port_cfg(cfg), device="cpu")
    assert state["step"].dtype == torch.int32 and state["step"].shape == ()
    with pytest.raises(ValueError, match="shape"):
        opt_state_from_jax(np_state, _port_cfg(cfg, conv_widths=(32, 64)),
                           device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GCNTrainer(_port_cfg(cfg, impl="fused"),
                   tcfg=TrainerConfig(str(tmp_path)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        opt_state_from_jax(np_state, _port_cfg(cfg))


def test_gcn_module_is_trainable():
    """The GCN module's parameters take gradients: the same as the
    functional loss's, for a kernel impl (its plain versions here)."""
    cfg, np_params, _, bt = _setup("tox21")
    pcfg = _port_cfg(cfg, impl="pallas_csr")
    model = tgcn.GCN(pcfg, params_from_jax(np_params, pcfg, device="cpu"))
    assert all(p.requires_grad for p in model.parameters())
    loss, _ = tgcn.gcn_loss(model.params, pcfg, bt["adj"], bt["x"],
                            bt["n_nodes"], bt["labels"])
    loss.backward()
    _, _, want = _jax_loss_and_grads("tox21")
    for p, w in zip(tree.leaves(model.params), jax.tree.leaves(want)):
        np.testing.assert_allclose(p.grad.numpy(), w, atol=3 * ATOL,
                                   rtol=3 * RTOL)
