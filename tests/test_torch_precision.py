"""Port parity: the reduced-precision variants (``PRECISION_IMPLS``: the
bf16, i8 and int16 branches of the ELL, CSR, COO, fused and hybrid
kernels) against the JAX reference on the CPU, on the oracle's three
regimes (``tests/oracle.py`` ``spmm_cases`` / ``layer_cases``).

The reference runs each variant with its Pallas kernels in interpret mode,
as its own tests do; the port runs the kernels' plain versions. Tolerances:

- ``narrow_col_ids`` and ``quantize_values_i8``: bit for bit;
- i8 forwards at ``TOLS["f32"]``: both packages hold the same codes and
  scale, so only the f32 summation order differs;
- bf16 kernel classes at (1e-4, 8e-3) against the same JAX variant: both
  round the same f32 sums to bf16 once, so they differ by at most one bf16
  ulp (2^-7 of the value) plus f32 noise; ``ell_bf16`` and ``csr_bf16``
  (XLA siblings in the reference) at ``TOLS["bf16"]``;
- every variant also against the f32 ``ref`` oracle at ``TOLS[policy]``;
- both gradients at ``TOLS[policy]``, 3x for ``fused_bf16`` (the layer
  rule; the reference takes that layer's dU through ``ref`` in interpret
  mode, the port through the bf16 COO class, so the two round dZ
  differently).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import TOLS, layer_cases
from repro.autotune import precision_of as j_precision_of
from repro.autotune import supports_gspmm as j_supports_gspmm
from repro.core import formats as jf
from repro.core import gcn as jgcn
from repro.core.graph_conv import graph_conv_batched as j_graph_conv
from repro.core.spmm import IMPLS as J_IMPLS
from repro.core.spmm import batched_spmm as j_batched_spmm
from repro.kernels import ops as jops
from repro.optim import adam as jadam
from repro_torch import tree
from repro_torch.autotune import PRECISION_IMPLS, precision_of
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.core import formats as tf
from repro_torch.core import gcn as tgcn
from repro_torch.core.graph_conv import graph_conv_batched
from repro_torch.data import graphs as tgraphs
from repro_torch.kernels import ops, ref
from repro_torch.kernels.batched_spmm_coo import batched_spmm_coo_bf16
from repro_torch.kernels.batched_spmm_csr import batched_spmm_csr_i8
from repro_torch.kernels.batched_spmm_ell import batched_spmm_ell_bf16
from repro_torch.kernels.fused_graph_conv import fused_forward_bf16
from repro_torch.serving.engine import GraphRequest, GraphServeEngine
from repro_torch.training.trainer import GCNTrainer, TrainerConfig
from test_torch_formats import CASE_NAMES, case, to_np, torch_coo
from test_torch_gcn import _port_cfg, _setup

SPMM_VARIANTS = tuple(i for i in PRECISION_IMPLS if i != "fused_bf16")
KERNEL_BF16_TOL = (1e-4, 8e-3)


def _variant_tol(impl: str) -> tuple[float, float]:
    """The tolerance of a variant against the same JAX variant."""
    base, policy = precision_of(impl)
    if policy == "i8":
        return TOLS["f32"]
    return TOLS["bf16"] if base in ("ell", "csr") else KERNEL_BF16_TOL


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol[0],
                               rtol=tol[1], err_msg=msg)


# ---------------------------------------------------------------------------
# formats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m_pad", (32767, 32768))
def test_narrow_col_ids_int16_boundary(m_pad):
    ids = np.array([[0, 5, m_pad - 1, m_pad]], np.int32)
    if m_pad > jf.INT16_MAX:
        with pytest.raises(ValueError, match="int16"):
            jf.narrow_col_ids(jnp.asarray(ids), m_pad)
        with pytest.raises(ValueError, match="int16"):
            tf.narrow_col_ids(torch.from_numpy(ids), m_pad)
        return
    want = to_np(jf.narrow_col_ids(jnp.asarray(ids), m_pad))
    got = tf.narrow_col_ids(torch.from_numpy(ids), m_pad)
    assert got.dtype == torch.int16 and want.dtype == np.int16
    np.testing.assert_array_equal(got.numpy(), want)
    assert tf.INT16_MAX == jf.INT16_MAX == 32767


@pytest.mark.parametrize("name", CASE_NAMES + ("ties",))
def test_quantize_values_i8_bitwise(name):
    if name == "ties":
        # maxabs 127 gives scale 1.0 exactly: the codes sit on .5 ties,
        # rounded half to even; an all-zero matrix takes scale 1.0; vector
        # edges quantize per matrix over every axis
        vals = np.array([[0.5, 1.5, 2.5, -0.5, -2.5, 127.0],
                         [0.0] * 6, [3.0, -1e-3, 0.25, 7.5, 1e-30, -4.0]],
                        np.float32)
        cases = [vals, np.random.default_rng(3).normal(
            size=(2, 8, 5)).astype(np.float32)]
    else:
        cases = [to_np(case(name)[0].values)]
    for v in cases:
        jc, js = jf.quantize_values_i8(jnp.asarray(v))
        tc, ts = tf.quantize_values_i8(torch.from_numpy(v))
        assert tc.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tc.numpy(), to_np(jc))
        np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                      to_np(js).view(np.int32))


def test_coo_transpose_swaps_ids():
    cj, ct, m_pad, _, _ = case("skewed")
    tj, tt = cj.transpose(m_pad), ct.transpose(m_pad)
    for f in dataclasses.fields(jf.BatchedCOO):
        np.testing.assert_array_equal(getattr(tt, f.name).numpy(),
                                      to_np(getattr(tj, f.name)))


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_registry_and_backward_classes_match_reference():
    assert set(ops.IMPLS) | {"auto"} == set(J_IMPLS)
    assert PRECISION_IMPLS == dict(jops.PRECISION_IMPLS)
    for impl in ops.IMPLS:
        assert precision_of(impl) == j_precision_of(impl), impl
        assert ops.bwd_impl_for(impl) == jops.bwd_impl_for(impl), impl
        assert ops.supports_gspmm(impl) == j_supports_gspmm(impl), impl
    assert ops._VARIANT_BWD == jops._VARIANT_BWD
    for a, b in ((torch.bfloat16, torch.float32),
                 (torch.bfloat16, torch.bfloat16),
                 (torch.float32, torch.float32)):
        want = jops.resolve_compute_dtype(
            jnp.bfloat16 if a == torch.bfloat16 else jnp.float32,
            jnp.bfloat16 if b == torch.bfloat16 else jnp.float32)
        assert str(ops.resolve_compute_dtype(a, b)).split(".")[-1] == \
            jnp.dtype(want).name


# ---------------------------------------------------------------------------
# SpMM variants: forward and both gradients
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_forward(name: str, impl: str) -> np.ndarray:
    coo, _, _, b, k_pad = case(name)
    # jitted, here and below: one compile instead of many eager ops
    return to_np(jax.jit(lambda bb: j_batched_spmm(
        coo, bb, impl=impl, k_pad=k_pad, interpret=True))(jnp.asarray(b)))


@pytest.mark.parametrize("name", CASE_NAMES)
@pytest.mark.parametrize("impl", SPMM_VARIANTS)
def test_variant_forward_matches_reference(impl, name):
    _, coo, _, b, k_pad = case(name)
    got = ops.batched_spmm(coo, torch.from_numpy(b), impl=impl, k_pad=k_pad)
    assert got.dtype == torch.float32
    _close(got.numpy(), _jax_forward(name, impl), _variant_tol(impl),
           f"{impl} vs the reference's {impl} on {name}")
    _close(got.numpy(), _jax_forward(name, "ref"),
           TOLS[precision_of(impl)[1]], f"{impl} vs ref on {name}")


def _tanh_loss_grads_jax(name, impl):
    coo, _, _, b, k_pad = case(name)

    def loss(values, bb):
        c = j_batched_spmm(dataclasses.replace(coo, values=values), bb,
                           impl=impl, k_pad=k_pad, interpret=True)
        return jnp.sum(jnp.tanh(c))

    return [to_np(g) for g in jax.jit(jax.grad(loss, argnums=(0, 1)))(
        coo.values, jnp.asarray(b))]


@pytest.mark.parametrize("name", CASE_NAMES)
@pytest.mark.parametrize("impl", SPMM_VARIANTS)
def test_variant_grads_match_reference(impl, name):
    _, coo, _, b, k_pad = case(name)
    v = coo.values.clone().requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    c = ops.batched_spmm(coo.with_values(v), bt, impl=impl, k_pad=k_pad)
    torch.tanh(c).sum().backward()
    assert v.grad.dtype == bt.grad.dtype == torch.float32
    for got, want, what in zip((v.grad, bt.grad),
                               _tanh_loss_grads_jax(name, impl),
                               ("dvalues", "dB")):
        _close(got.numpy(), want, TOLS[precision_of(impl)[1]],
               f"{impl} {what} on {name}")


# ---------------------------------------------------------------------------
# the fused_bf16 layer
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _layer_cases():
    return {name: (jax.tree.map(np.asarray, params), adj, to_np(x))
            for name, params, adj, x in layer_cases()}


def _layer_grads_jax(name, impl):
    params, adj, x = _layer_cases()[name]

    def loss(vals, xx, ww, bb):
        aa = [a.with_values(v) for a, v in zip(adj, vals)]
        return jnp.sum(jnp.tanh(j_graph_conv({"w": ww, "b": bb}, aa, xx,
                                             impl=impl, interpret=True)))

    y, g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3)))(
        [a.values for a in adj], jnp.asarray(x), jnp.asarray(params["w"]),
        jnp.asarray(params["b"]))
    return float(y), [to_np(t) for t in jax.tree.leaves(g)]


@pytest.mark.parametrize("name", CASE_NAMES)
def test_fused_bf16_layer_matches_reference(name):
    params, adj_j, x = _layer_cases()[name]
    adj = [torch_coo(a) for a in adj_j]
    leaves = [a.values.clone().requires_grad_() for a in adj] + [
        torch.from_numpy(t.copy()).requires_grad_()
        for t in (x, params["w"], params["b"])]
    nv = len(adj)
    y = graph_conv_batched({"w": leaves[nv + 1], "b": leaves[nv + 2]},
                           [a.with_values(v) for a, v in zip(adj, leaves)],
                           leaves[nv], impl="fused_bf16")
    assert y.dtype == torch.float32
    loss = torch.tanh(y).sum()
    loss.backward()
    jparams = jax.tree.map(jnp.asarray, params)
    for impl, tol in (("fused_bf16", KERNEL_BF16_TOL), ("ref", TOLS["bf16"])):
        want_y = to_np(jax.jit(lambda p, xx, impl=impl: j_graph_conv(
            p, adj_j, xx, impl=impl, interpret=True))(jparams,
                                                      jnp.asarray(x)))
        _close(y.detach().numpy(), want_y, tol, f"fused_bf16 vs {impl} "
                                                f"on {name}")
    want_loss, want_g = _layer_grads_jax(name, "fused_bf16")
    _close(loss.item(), want_loss, TOLS["bf16"], f"loss on {name}")
    tol = tuple(3 * t for t in TOLS["bf16"])
    for i, (leaf, want) in enumerate(zip(leaves, want_g)):
        assert leaf.grad.dtype == torch.float32
        _close(leaf.grad.numpy(), want, tol, f"fused_bf16 grad {i} {name}")


# ---------------------------------------------------------------------------
# the model: forward, a trainer step, the engine and fit, per variant
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_logits(impl: str) -> np.ndarray:
    cfg, np_params, bj, _ = _setup("tox21")
    cfg = dataclasses.replace(cfg, impl=impl, interpret=True)
    return to_np(jax.jit(lambda p, a, x, n: jgcn.apply_gcn(p, cfg, a, x, n))(
        jax.tree.map(jnp.asarray, np_params), bj["adj"], bj["x"],
        bj["n_nodes"]))


@pytest.mark.parametrize("impl", tuple(PRECISION_IMPLS))
def test_apply_gcn_variant_matches_reference(impl):
    """Every variant's logits against the reference's f32 ``ref`` at
    TOLS[policy]; one variant per policy also against the reference's
    same variant (i8 at the f32 logit rule: the codes are shared)."""
    cfg, np_params, _, bt = _setup("tox21")
    pcfg = _port_cfg(cfg, impl=impl)
    got = tgcn.apply_gcn(params_from_jax(np_params, pcfg, device="cpu"),
                         pcfg, bt["adj"], bt["x"], bt["n_nodes"]).numpy()
    policy = precision_of(impl)[1]
    if impl in ("fused_bf16", "pallas_ell_i8"):
        _close(got, _jax_logits(impl), (1e-4, 0.0) if policy == "i8"
               else TOLS[policy], impl)
    _close(got, _jax_logits("ref"), TOLS[policy], f"{impl} vs ref")


@pytest.mark.parametrize("impl", ("fused_bf16", "pallas_csr_i8"))
def test_trainer_step_per_policy_matches_reference(impl, tmp_path):
    """One GCNTrainer step from one numpy state against the reference's
    gcn_loss gradients and Adam update of the same variant."""
    cfg, np_params, bj, bt = _setup("tox21")
    jcfg = dataclasses.replace(cfg, impl=impl, interpret=True)
    opt = jadam.AdamConfig(lr=3e-3)
    np_state = jax.tree.map(np.asarray, jadam.adam_init(np_params))
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jgcn.gcn_loss(p, jcfg, bj["adj"], bj["x"], bj["n_nodes"],
                                bj["labels"]), has_aux=True))(
        jax.tree.map(jnp.asarray, np_params))
    jp, _ = jadam.adam_update(opt, jax.tree.map(jnp.asarray, np_params),
                              grads, jax.tree.map(jnp.asarray, np_state))

    pcfg = _port_cfg(cfg, impl=impl)
    trainer = GCNTrainer(pcfg, opt=None, tcfg=TrainerConfig(str(tmp_path)),
                         device="cpu")
    params = params_from_jax(np_params, pcfg, device="cpu")
    live = [p.clone().requires_grad_() for p in tree.leaves(params)]
    t_loss, _ = tgcn.gcn_loss(tree.unflatten(params, live), pcfg, bt["adj"],
                              bt["x"], bt["n_nodes"], bt["labels"])
    t_grads = torch.autograd.grad(t_loss, live)
    tol = TOLS[precision_of(impl)[1]]
    _close(t_loss.item(), float(loss), tol, f"{impl} loss")
    for i, (g, w) in enumerate(zip(t_grads, jax.tree.leaves(grads))):
        _close(g.numpy(), to_np(w), tuple(3 * t for t in tol),
               f"{impl} grad leaf {i}")
    state = opt_state_from_jax(np_state, pcfg, device="cpu")
    new, _, m = trainer.train_step(params, state, trainer.place_batch(bt))
    _close(m["loss"].item(), float(loss), tol, f"{impl} step loss")
    # Adam moves each parameter by about lr: a gradient near 0 may flip
    # the step's sign between the packages, so the updates are held to 2 lr
    for i, (p, w) in enumerate(zip(tree.leaves(new), jax.tree.leaves(jp))):
        _close(p.numpy(), to_np(w), (2 * opt.lr, 0.0), f"{impl} param {i}")


_GEOM = dict(batch=4, m_pad=16, nnz_pad=64)


def _requests(n=6):
    spec = tgraphs.GraphDatasetSpec.tox21_like(n_samples=n, max_nodes=14,
                                               seed=2)
    return [GraphRequest(rows=list(s.rows), cols=list(s.cols),
                         features=s.features, n_nodes=s.n_nodes)
            for s in tgraphs.generate(spec)]


@functools.lru_cache(maxsize=None)
def _served_ref():
    cfg = tgcn.GCNConfig.tox21(impl="ref", bn_mode="sample")
    params = tgcn.init_gcn(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    reqs = _requests()
    GraphServeEngine(params, cfg, **_GEOM, device="cpu").run(reqs)
    return params, np.stack([r.logits for r in reqs])


@pytest.mark.parametrize("impl", tuple(PRECISION_IMPLS))
def test_engine_and_fit_run_every_variant(impl, tmp_path):
    """GraphServeEngine serves and GCNTrainer.fit trains with each pinned
    variant on the CPU; the engine's logits are within TOLS[policy] of the
    f32 ref engine's, and the engine takes a precision override."""
    params, want = _served_ref()
    cfg = tgcn.GCNConfig.tox21(impl=impl, bn_mode="sample")
    policy = precision_of(impl)[1]
    eng = GraphServeEngine(params, cfg, **_GEOM, precision=policy,
                           device="cpu")
    assert eng.cfg.precision == policy and cfg.precision == "f32"
    reqs = _requests()
    eng.run(reqs)
    assert all(r.done and not r.failed for r in reqs)
    _close(np.stack([r.logits for r in reqs]), want, TOLS[policy], impl)
    spec = tgraphs.GraphDatasetSpec.tox21_like(n_samples=8, seed=1)
    data = list(tgraphs.batches(tgraphs.generate(spec), spec, 4))
    trainer = GCNTrainer(tgcn.GCNConfig.tox21(impl=impl),
                         tcfg=TrainerConfig(str(tmp_path),
                                            checkpoint_every=1000),
                         device="cpu")
    losses = []
    trainer.fit(data, epochs=1,
                on_metrics=lambda _, rec: losses.append(rec["loss"]))
    assert len(losses) == 1 and np.isfinite(losses).all()


@pytest.mark.parametrize("layer", ("gat", "rgcn"))
def test_gnn_layers_with_a_variant_raise_as_in_reference(layer):
    """The variants are (mul, sum)-only: the reference's g-SpMM refuses
    them, and so do the port's GAT and R-GCN layers."""
    cj, _, _, b, k_pad = case("uniform")
    op, red = ("mul", "sum") if layer == "gat" else ("copy_lhs", "mean")
    cfg = dataclasses.replace(tgcn.GCNConfig.tox21(layer=layer),
                              conv_widths=(8, 8))
    params = tgcn.init_gcn(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    spec = tgraphs.GraphDatasetSpec.tox21_like(n_samples=4, seed=1)
    bt = next(tgraphs.batches(tgraphs.generate(spec), spec, 4))
    for impl in ("pallas_csr_bf16", "pallas_ell_i8", "fused_bf16"):
        if layer == "gat":      # vector edges: the GAT layer's g-SpMM
            cj = cj.with_values(jnp.ones(cj.values.shape + (b.shape[-1],)))
        with pytest.raises(ValueError, match="g-SpMM"):
            jops.batched_gspmm(cj, jnp.asarray(b), op=op, reduce=red,
                               impl=impl, k_pad=k_pad, interpret=True)
        with pytest.raises(ValueError, match="cannot run g-SpMM"):
            tgcn.apply_gcn(params, dataclasses.replace(cfg, impl=impl),
                           bt["adj"], bt["x"], bt["n_nodes"])


# ---------------------------------------------------------------------------
# the wrappers' contract
# ---------------------------------------------------------------------------

def test_precision_entries_check_operands_and_never_fall_back(monkeypatch):
    """The entries take only their own types; a tensor off the CPU launches
    or raises, never runs the plain version; the ELL guard runs before the
    narrowing; case 3 takes the plain path on the CPU and the large-matrix
    entries off it, with int32 ids past m_pad 32767."""
    _, coo, m_pad, b, k_pad = case("uniform")
    bt = torch.from_numpy(b)
    e = tf.coo_to_ell(coo, m_pad, k_pad)
    c16 = tf.narrow_col_ids(e.col_ids, m_pad)
    with pytest.raises(TypeError, match="dtype"):
        batched_spmm_ell_bf16(e.col_ids, e.values.bfloat16(), bt.bfloat16())
    with pytest.raises(TypeError, match="dtype"):
        batched_spmm_ell_bf16(c16, e.values.bfloat16(), bt)
    csr = tf.coo_to_csr(coo, m_pad)
    codes, scale = tf.quantize_values_i8(csr.values)
    with pytest.raises(ValueError, match="shape"):
        batched_spmm_csr_i8(csr.rpt, tf.narrow_col_ids(csr.col_ids, m_pad),
                            codes, scale[:1], bt)
    r16 = tf.narrow_col_ids(coo.row_ids, m_pad)
    with pytest.raises(TypeError, match="dtype"):
        batched_spmm_coo_bf16(r16, coo.col_ids, coo.values.bfloat16(),
                              bt.bfloat16())
    # case 3, judged at the variant's element size: an m_pad whose f32 B
    # panel does not fit a block is case 3 for the i8 variants (f32 B) and
    # the COO class (f32 accumulator), not for the bf16 row splits. On the
    # CPU they take the reference's plain per-sample path, bit for bit.
    big = 3000
    rows = np.array([0, big - 1, 7], np.int32)
    one = tf.coo_from_lists([(rows, rows[::-1].copy(),
                              np.array([1.0, -2.0, 0.5], np.float32))], [big])
    bb = torch.randn((1, big, 32), generator=torch.Generator().manual_seed(5))
    q_codes, q_scale = tf.quantize_values_i8(one.values)
    want_i8 = ref.batched_spmm_csr_ref(
        tf.coo_to_csr(one.with_values(q_codes), big), bb) * q_scale
    torch.testing.assert_close(ops.batched_spmm(one, bb, impl="pallas_csr_i8"),
                               want_i8, rtol=0, atol=0)
    h = one.with_values(one.values.bfloat16())
    torch.testing.assert_close(
        ops.batched_spmm(one, bb, impl="pallas_coo_bf16"),
        ref.batched_spmm_coo_ref(h, bb.bfloat16(), big).float(),
        rtol=0, atol=0)

    def boom(*a, **k):
        raise AssertionError("fell back to the plain version")

    for fn in ("batched_spmm_ell_plain", "batched_spmm_coo_plain",
               "fused_graph_conv_plain", "batched_spmm_coo_ref"):
        monkeypatch.setattr(ref, fn, boom)
    meta = [t.to("meta") for t in (c16, e.values.bfloat16(), bt.bfloat16())]
    with pytest.raises(ValueError, match="CUDA"):
        batched_spmm_ell_bf16(*meta)
    with pytest.raises(ValueError, match="CUDA"):
        fused_forward_bf16(*(t.to("meta") for t in (
            r16[:, None], r16[:, None], coo.values[:, None].bfloat16(),
            coo.nnz[:, None], bt.bfloat16(), torch.zeros(1, 48, 8).bfloat16(),
            torch.zeros(1, 8).bfloat16())))
    with pytest.raises(ValueError, match="max row degree"):
        ops.batched_spmm(coo, bt, impl="pallas_ell_bf16", k_pad=k_pad - 1)
    # off the CPU, case 3 reaches the kernel's large-matrix entry (whose
    # device check raises here, with no card), never the plain path ...
    monkeypatch.setattr(ref, "batched_spmm_csr_ref", boom)
    entries = ("batched_spmm_csr_large_i8", "batched_spmm_coo_large_bf16",
               "batched_spmm_csr_large_bf16", "batched_spmm_csr_bf16")
    reached = []
    for name in entries:
        def spy(*a, _real=getattr(ops, name), _name=name, **k):
            reached.append((_name, a[1].dtype))
            return _real(*a, **k)

        monkeypatch.setattr(ops, name, spy)
    mb = bb.to("meta")
    for impl, want in (
            ("pallas_csr_i8", ("batched_spmm_csr_large_i8", torch.int16)),
            ("pallas_coo_bf16", ("batched_spmm_coo_large_bf16",
                                 torch.int16)),
            ("pallas_csr_bf16", ("batched_spmm_csr_bf16", torch.int16))):
        reached.clear()
        with pytest.raises(ValueError, match="CUDA"):
            ops.batched_spmm(one.to("meta"), mb, impl=impl)
        assert reached == [want], (impl, reached)
    # ... past LARGE_M every variant is case 3, and past INT16_MAX the large
    # entries take int32 ids, where the fused_bf16 layer's narrowing
    # refuses the ids before any launch (the reference raises at case 3)
    huge = tf.INT16_MAX + 1
    hrows = np.array([0, huge - 1], np.int32)
    wide = tf.coo_from_lists([(hrows, hrows.copy(), np.ones(2, np.float32))],
                             [huge])
    for impl in ("pallas_csr_bf16", "pallas_hybrid_bf16"):
        reached.clear()
        with pytest.raises(ValueError, match="CUDA"):
            ops.batched_spmm(wide.to("meta"),
                             torch.zeros((1, huge, 8), device="meta"),
                             impl=impl)
        assert reached == [("batched_spmm_csr_large_bf16", torch.int32)]
    with pytest.raises(ValueError, match="int16"):
        graph_conv_batched({"w": torch.zeros((1, 4, 8)),
                            "b": torch.zeros((1, 8))}, [wide],
                           torch.zeros((1, huge, 4)), impl="fused_bf16")
