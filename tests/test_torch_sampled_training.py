"""Port parity: the giant-graph tier's model and trainer (``apply_gcn_blocks``,
``gcn_node_loss``, ``GCNTrainer.block_decisions`` and ``fit_sampled``)
against the JAX package on the CPU, at ``reddit_like(2_000)``, batch 64,
fanouts (3, 2) and widths (16, 16).

Both packages see bitwise-equal sampled minibatches and start from one
state: the reference's parameters (``params_from_jax``), or its initial
state written as a step-0 checkpoint that either trainer restores.
Tolerances: logits, loss and accuracy at ``tests/oracle.py`` TOLS["f32"],
gradients at 3x it; 6-step loss curves within 1e-3 relative. The kernel
impls run their plain versions here (on CPU tensors), each held against
the reference's ``ref``.
"""
import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import TOLS
from repro import autotune as jat
from repro import sampling as js
from repro.checkpoint import CheckpointManager as JManager
from repro.core import gcn as jgcn
from repro.data import graphs as jgraphs
from repro.observability import MetricsRegistry as JRegistry
from repro.optim import AdamConfig as JAdam
from repro.training import GCNTrainer as JTrainer
from repro.training import TrainerConfig as JTrainerConfig
from repro_torch import autotune as tat
from repro_torch import observability as tobs
from repro_torch import sampling as ts
from repro_torch import tree
from repro_torch.convert import params_from_jax
from repro_torch.core import gcn as tgcn
from repro_torch.data import graphs as tgraphs
from repro_torch.optim.adam import AdamConfig
from repro_torch.training.trainer import GCNTrainer, TrainerConfig

ATOL, RTOL = TOLS["f32"]
CURVE_RTOL = 1e-3
N_NODES, BATCH, FANOUTS, WIDTHS = 2_000, 64, (3, 2), (16, 16)
STEPS = 6
IMPLS = ("ref", "pallas_coo", "pallas_csr")


def _cfgs(impl: str):
    kw = dict(n_features=64, channels=1, conv_widths=WIDTHS, n_tasks=8,
              task="multiclass", k_pad=None, impl=impl)
    return tgcn.GCNConfig(**kw), jgcn.GCNConfig(**kw)


@pytest.fixture(scope="module")
def data():
    return tgraphs.reddit_like(N_NODES), jgraphs.reddit_like(N_NODES)


def _loaders(data, n_seeds: int = STEPS * BATCH):
    """(port, reference) loaders over the first ``n_seeds`` train ids,
    each behind a static hot-node cache on a registry of its own."""
    out = []
    for mod, reg, d in ((ts, tobs.MetricsRegistry(), data[0]),
                        (js, JRegistry(), data[1])):
        store = mod.FeatureStore(d.features, registry=reg)
        cache = mod.HotNodeCache(
            store, 128, hot_ids=mod.static_hot_ids(d.csc.in_degrees(), 128),
            registry=reg)
        out.append(mod.SampledNodeLoader(
            d.csc, d.features, d.labels, d.train_ids[:n_seeds],
            fanouts=FANOUTS, batch_size=BATCH, cache=cache))
    return out


@pytest.fixture(scope="module")
def batches(data):
    tl, jl = _loaders(data)
    return next(iter(tl.epoch(0))), next(iter(jl.epoch(0)))


@pytest.fixture(scope="module")
def np_params():
    _, jcfg = _cfgs("ref")
    return jax.tree.map(np.asarray, jgcn.init_gcn(jax.random.key(3), jcfg))


def _padded_blocks(data):
    """One minibatch's (port, reference) blocks whose second block is padded
    past the first (the forward zero-pads between layers instead of
    slicing), and its input rows."""
    t, j = data
    seeds = t.train_ids[:BATCH]
    shapes = [(768, 576), (1024, 256)]
    tb = ts.neighbor_sample(t.csc, seeds, FANOUTS, seed=5, shapes=shapes)
    jb = js.neighbor_sample(j.csc, seeds, FANOUTS, seed=5, shapes=shapes)
    x = np.zeros((768, 64), np.float32)
    x[:tb[0].n_src] = t.features[tb[0].src_ids]
    return tb, jb, x


def _j_inputs(jb):
    return ([b.adj for b in jb.blocks], jnp.asarray(jb.x),
            jnp.asarray(jb.labels), tuple(b.m_pad for b in jb.blocks))


@pytest.fixture(scope="module")
def reference_forward(batches, np_params):
    """The reference's logits, loss, accuracy and gradients of the first
    minibatch with impl="ref", the oracle every port impl is held to."""
    _, jb = batches
    _, jcfg = _cfgs("ref")
    jadjs, jx, jlabels, m_pads = _j_inputs(jb)

    @jax.jit
    def reference(p):
        logits = jgcn.apply_gcn_blocks(p, jcfg, jadjs, jx, m_pads=m_pads)
        return logits, jax.value_and_grad(
            lambda q: jgcn.gcn_node_loss(q, jcfg, jadjs, jx, jlabels,
                                         m_pads=m_pads), has_aux=True)(p)

    return reference(jax.tree.map(jnp.asarray, np_params))


@pytest.mark.parametrize("impl", IMPLS)
def test_block_forward_loss_and_grads_match_reference(batches, np_params,
                                                      reference_forward,
                                                      impl):
    tb, jb = batches
    tcfg, _ = _cfgs(impl)
    m_pads = tuple(b.m_pad for b in jb.blocks)
    want_logits, ((want_loss, want_acc), want_grads) = reference_forward
    want_logits = np.asarray(want_logits)
    params = params_from_jax(np_params, tcfg, device="cpu")
    adjs = [b.adj for b in tb.blocks]
    x, labels = torch.from_numpy(tb.x), torch.from_numpy(tb.labels)
    logits = tgcn.apply_gcn_blocks(params, tcfg, adjs, x, m_pads=m_pads)
    assert logits.shape == want_logits.shape == (m_pads[-1], 8)
    np.testing.assert_allclose(logits.detach().numpy(), want_logits,
                               atol=ATOL, rtol=RTOL)
    leaves = [p.requires_grad_() for p in tree.leaves(params)]
    loss, acc = tgcn.gcn_node_loss(tree.unflatten(params, leaves), tcfg,
                                   adjs, x, labels, m_pads=m_pads,
                                   impls=(impl,) * 2)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(acc.item(), float(want_acc), atol=ATOL,
                               rtol=RTOL)
    want = jax.tree.leaves(want_grads)
    assert len(grads) == len(want) == 4 * len(WIDTHS) + 2
    for i, (g, w) in enumerate(zip(grads, want)):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=3 * ATOL,
                                   rtol=3 * RTOL, err_msg=f"{impl} leaf {i}")


def test_block_forward_pads_between_layers_as_the_reference(data,
                                                            np_params):
    tb, jb, x = _padded_blocks(data)
    tcfg, jcfg = _cfgs("ref")
    m_pads = (768, 1024)
    want = jax.jit(lambda p, adjs, x: jgcn.apply_gcn_blocks(
        p, jcfg, adjs, x, m_pads=m_pads))(
            jax.tree.map(jnp.asarray, np_params), [b.adj for b in jb],
            jnp.asarray(x))
    got = tgcn.apply_gcn_blocks(
        params_from_jax(np_params, tcfg, device="cpu"), tcfg,
        [b.adj for b in tb], torch.from_numpy(x), m_pads=m_pads)
    assert got.shape == (1024, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("what", ["count", "layer"])
def test_block_forward_errors_are_the_reference(batches, np_params, what):
    tb, jb = batches
    tcfg, jcfg = _cfgs("ref")
    jadjs, jx, _, m_pads = _j_inputs(jb)
    tadjs = [b.adj for b in tb.blocks]
    if what == "count":
        tadjs, jadjs, match = tadjs[:1], jadjs[:1], "1 blocks for 2 conv"
    else:
        tcfg = dataclasses.replace(tcfg, layer="gat")
        jcfg = dataclasses.replace(jcfg, layer="gat")
        match = "layer='gcn' only"
    with pytest.raises(ValueError, match=match):
        jgcn.apply_gcn_blocks(np_params, jcfg, jadjs, jx, m_pads=m_pads)
    with pytest.raises(ValueError, match=match):
        tgcn.apply_gcn_blocks(params_from_jax(np_params, _cfgs("ref")[0],
                                              device="cpu"),
                              tcfg, tadjs, torch.from_numpy(tb.x),
                              m_pads=m_pads)


def _trainers(tmp_path, impl: str, **tkw):
    tcfg, jcfg = _cfgs(impl)
    tdir, jdir = str(tmp_path / "port"), str(tmp_path / "ref")
    kw = dict(checkpoint_every=1000, log_every=1) | tkw
    return (GCNTrainer(tcfg, AdamConfig(lr=5e-3),
                       TrainerConfig(checkpoint_dir=tdir, **kw),
                       device="cpu", registry=tobs.MetricsRegistry()),
            JTrainer(jcfg, JAdam(lr=5e-3),
                     JTrainerConfig(checkpoint_dir=jdir, **kw),
                     registry=JRegistry()))


@pytest.mark.parametrize("impl", IMPLS + ("pallas_hybrid", "pallas_coo_bf16"))
def test_block_decisions_on_pinned_impls_are_the_reference(tmp_path,
                                                           batches, impl):
    tt, jt = _trainers(tmp_path, impl)
    got, want = tt.block_decisions(batches[0]), jt.block_decisions(batches[1])
    assert [(d.impl, d.source, d.workload.key()) for d in got] == \
        [(d.impl, d.source, d.workload.key()) for d in want]
    assert got[0].workload.k_pad is None and got[0].workload.block
    assert tt.block_decisions(batches[0]) is got            # memoized


def test_block_decisions_auto_on_the_cpu_ranks_the_plain_impls(tmp_path,
                                                               batches):
    tt, _ = _trainers(tmp_path, "auto")
    for d in tt.block_decisions(batches[0]):
        assert d.source == "model"
        assert d.impl == tat.rank(d.workload, allow_pallas=False)[0][0]
        assert not d.impl.startswith(("pallas", "fused"))
        assert "ell" not in d.impl                 # k_pad=None: no ELL


def test_auto_on_a_sampled_workload_is_the_h100_models_pick():
    """The port's counterpart of the reference's block-aware selection test
    (``tests/test_sampling.py``): the same workload and key, and the pick is
    the port's H100 model's cheapest, not the TPU model's ``pallas_csr``."""
    kw = dict(batch=1, m_pad=1600, nnz_pad=3200, k_pad=None, n_b=64,
              max_deg=16, block=360)
    w, jw = tat.Workload(**kw), jat.Workload(**kw)
    assert w.key() == jw.key() and w.key().endswith("_blk360")
    assert "_blk" not in dataclasses.replace(w, block=None).key()
    d = tat.select_impl(w, allow_pallas=True)
    scores = tat.rank(w, allow_pallas=True)
    assert (d.impl, d.source) == (scores[0][0], "model")
    assert d.impl.startswith("pallas_")
    assert all(s == float("inf") for i, s in
               ((i, tat.estimate(w, i)) for i in ("ell", "pallas_ell")))
    assert all("ell" not in i for i, _ in scores)


def _record(trainer, attr: str, out: list, loss_of):
    """Wrap a trainer's step function so that each step's loss lands in
    ``out`` (a test-side spy on the instance; the class is untouched)."""
    step = getattr(trainer, attr)

    def spy(*a, **k):
        r = step(*a, **k)
        out.append(float(loss_of(r)))
        return r

    setattr(trainer, attr, spy)


@pytest.fixture(scope="module")
def reference_run(data, tmp_path_factory, np_params):
    """The reference's fit_sampled (impl="ref") over STEPS batches from its
    seed-3 state (a step-0 checkpoint it wrote), checkpointing at step 3:
    its per-step losses, its directory and its result."""
    root = tmp_path_factory.mktemp("reference_run")
    _, jl = _loaders(data)
    _, jcfg = _cfgs("ref")
    jt = JTrainer(jcfg, JAdam(lr=5e-3),
                  JTrainerConfig(checkpoint_dir=str(root / "ref"),
                                 checkpoint_every=3, log_every=1),
                  registry=JRegistry())
    p0 = jax.tree.map(jnp.asarray, np_params)
    from repro.optim import adam_init
    start = str(root / "start")
    JManager(start).save(0, (p0, adam_init(p0)))
    shutil.copytree(start, str(root / "ref"), dirs_exist_ok=True)
    losses = []
    _record(jt, "_sampled_step", losses, lambda r: r[2])
    _, _, result = jt.fit_sampled(jl, epochs=1)
    return {"losses": losses, "dir": root, "start": start, "result": result}


@pytest.mark.parametrize("prefetch", [True, False])
def test_fit_sampled_curve_matches_the_reference(tmp_path, data,
                                                 reference_run, prefetch):
    tt, _ = _trainers(tmp_path, "pallas_coo")
    shutil.copytree(reference_run["start"], tt.tcfg.checkpoint_dir,
                    dirs_exist_ok=True)
    tl, _ = _loaders(data)
    losses = []
    _record(tt, "sampled_step", losses, lambda r: r[2]["loss"])
    tobs.TRACER.clear()
    with tobs.telemetry():
        _, _, result = tt.fit_sampled(tl, epochs=1, prefetch=prefetch)
    want = reference_run["losses"]
    assert len(losses) == len(want) == STEPS
    np.testing.assert_allclose(losses, want, rtol=CURVE_RTOL)
    assert result["programs"] == reference_run["result"]["programs"]
    np.testing.assert_allclose(result["loss"], losses[-1], rtol=0)
    spans = [e for e in tobs.TRACER.events()
             if e.name == "train/sampled_step"]
    assert len(spans) == STEPS
    gauge = tt.registry.gauge("train_sampled_programs")
    assert gauge.value(layer="gcn", impl="pallas_coo") == result["programs"]
    assert tt.registry.counter("train_steps_total").value(
        layer="gcn", impl="pallas_coo") == STEPS
    assert tt.manager.latest_step() == STEPS


def test_reference_checkpoint_resumes_in_the_port(tmp_path, data,
                                                  reference_run):
    """The reference's step-3 checkpoint: the port restores it, skips three
    batches and trains on the same batches 4-6 as the reference did."""
    tt, _ = _trainers(tmp_path, "pallas_coo")
    step3 = "step_0000000003"
    shutil.copytree(reference_run["dir"] / "ref" / step3,
                    os.path.join(tt.tcfg.checkpoint_dir, step3))
    assert tt.manager.latest_step() == 3
    tl, jl = _loaders(data)
    seen, losses = [], []
    place = tt.place_sampled

    def spy_place(b):
        seen.append(b)
        return place(b)

    tt.place_sampled = spy_place
    _record(tt, "sampled_step", losses, lambda r: r[2]["loss"])
    tt.fit_sampled(tl, epochs=1)
    assert [b.batch_index for b in seen] == [3, 4, 5]
    for got, want in zip(seen, list(jl.epoch(0))[3:], strict=True):
        np.testing.assert_array_equal(got.seeds, want.seeds)
        np.testing.assert_array_equal(got.x, want.x)
    np.testing.assert_allclose(losses, reference_run["losses"][3:],
                               rtol=CURVE_RTOL)
