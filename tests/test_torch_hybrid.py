"""Port parity: the degree-binned hybrid split (``plan_hybrid``,
``hybrid_operands``, the ``hybrid`` / ``pallas_hybrid`` SpMM impls and the
``fused_hybrid`` layer) against the JAX reference on the CPU.

Inputs are made with numpy from a seed and fed to both packages; the
reference's Pallas kernels run in interpret mode, as ``tests/test_hybrid.py``
runs them. Plans and the integer outputs of ``hybrid_operands`` match
exactly, the slab too; products at ``TOLS["f32"]`` of ``tests/oracle.py``,
gradients at 3x it. On the CPU the hybrid wrappers run their plain versions.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import TOLS
from repro.core import batching as jb
from repro.core import formats as jf
from repro.core.graph_conv import stack_channels as j_stack
from repro.core.spmm import batched_spmm as j_batched_spmm
from repro.kernels.batched_spmm_hybrid import hybrid_operands as j_operands
from repro.kernels.fused_graph_conv import fused_graph_conv as j_fused
from repro_torch import tree
from repro_torch.convert import params_from_jax
from repro_torch.core import batching as tb
from repro_torch.core import formats as tf
from repro_torch.core import gcn as tgcn
from repro_torch.core.graph_conv import stack_channels
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.batched_spmm_hybrid import (
    batched_spmm_hybrid,
    hybrid_launch,
    hybrid_operands,
)
from repro_torch.kernels.fused_graph_conv import (
    fused_forward,
    fused_graph_conv,
    fused_hybrid_forward,
)
from test_torch_formats import CASE_NAMES, case, to_np, torch_coo

ATOL, RTOL = TOLS["f32"]
HYBRID_IMPLS = ("hybrid", "pallas_hybrid")
CASES = CASE_NAMES + ("powerlaw",)


@functools.lru_cache(maxsize=None)
def _powerlaw():
    """A small degree-skewed batch of the reference's generator, N(0, 1)
    values on the real slots."""
    coo, m_pad = jf.random_powerlaw_batch(np.random.default_rng(0), batch=3,
                                          dim=64, avg_deg=4)
    rng = np.random.default_rng(1)
    vals = np.where(to_np(coo.values) != 0,
                    rng.normal(size=coo.values.shape), 0).astype(np.float32)
    coo = dataclasses.replace(coo, values=jnp.asarray(vals))
    b = rng.normal(size=(coo.batch, m_pad, 24)).astype(np.float32)
    return coo, m_pad, b


def _case(name):
    """(coo_jax, coo_torch, m_pad, b_np) of a regime or the powerlaw batch."""
    if name == "powerlaw":
        coo, m_pad, b = _powerlaw()
        return coo, torch_coo(coo), m_pad, b
    coo_j, coo_t, m_pad, b, _ = case(name)
    return coo_j, coo_t, m_pad, b


# ---------------------------------------------------------------------------
# the plan and the generator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch,m_pad,n_b,nnz_pad", [
    (4, 64, 32, 512), (2, 64, 32, 8), (512, 56, 64, 256), (128, 56, 64, 1024),
    (40, 256, 64, 2048), (160, 56, 64, 352), (3, 50, 16, 100), (1, 8, 8, 8),
    (5, 24, 16, 40), (2, 300, 512, 64), (7, 17, 8, 5)])
def test_plan_hybrid_matches_reference(batch, m_pad, n_b, nnz_pad):
    """dmin, d_pad and the bins equal the reference's at its defaults,
    d_pad == 0 included (nnz_pad < dmin), and m_pad is rounded to 8 as the
    reference rounds it; the panels are the Hopper planner's, with room
    for the row permutation beside the B panel."""
    want = jb.plan_hybrid(batch=batch, m_pad=m_pad, n_b=n_b, nnz_pad=nnz_pad)
    got = tb.plan_hybrid(batch=batch, m_pad=m_pad, n_b=n_b, nnz_pad=nnz_pad)
    assert (got.dmin, got.d_pad, got.bins) == (want.dmin, want.d_pad,
                                               want.bins)
    assert (tb.HYBRID_TAU, tb.HYBRID_NBINS) == (jb.HYBRID_TAU,
                                                jb.HYBRID_NBINS)
    assert (got.spmm.batch, got.spmm.m_pad, got.spmm.n_b) == (
        want.spmm.batch, want.spmm.m_pad, want.spmm.n_b)
    assert got.d_pad == 0 or nnz_pad >= got.dmin
    s = got.spmm
    assert s.case in (1, 2) and s.n_block * s.p >= n_b
    assert s.smem_bytes == 4 * s.m_pad * (s.n_block + 1) <= tb.SMEM_BYTES


@pytest.mark.parametrize("seed,dim,avg_deg", [(0, 256, 8), (9, 64, 4),
                                              (3, (20, 40), 3.5)])
def test_random_powerlaw_batch_bitwise(seed, dim, avg_deg):
    batch = 40 if dim == 256 else 4
    cj, mj = jf.random_powerlaw_batch(np.random.default_rng(seed),
                                      batch=batch, dim=dim, avg_deg=avg_deg)
    ct, mt = tf.random_powerlaw_batch(np.random.default_rng(seed),
                                      batch=batch, dim=dim, avg_deg=avg_deg)
    assert mj == mt
    for f in dataclasses.fields(jf.BatchedCOO):
        np.testing.assert_array_equal(getattr(ct, f.name).numpy(),
                                      to_np(getattr(cj, f.name)), f.name)
    np.testing.assert_array_equal(
        tf.powerlaw_degrees(np.random.default_rng(seed), 50, 3.0),
        jf.powerlaw_degrees(np.random.default_rng(seed), 50, 3.0))


def test_powerlaw_geometry_has_hubs():
    """The geometry the reference benchmarks the split on (bench_formats
    "powerlaw", seed 0): hub rows exist and the split engages."""
    coo, m_pad = tf.random_powerlaw_batch(np.random.default_rng(0), batch=40,
                                          dim=256, avg_deg=8)
    hp = tb.plan_hybrid(batch=40, m_pad=m_pad, n_b=64, nnz_pad=coo.nnz_pad)
    assert (m_pad, coo.nnz_pad, hp.dmin, hp.d_pad, len(hp.bins)) == (
        256, 2048, 64, 32, 8)
    deg = tf.row_degrees(coo, m_pad)
    assert int(deg.max()) == 256
    assert float((deg >= hp.dmin).sum()) / coo.batch == pytest.approx(5.0)


# ---------------------------------------------------------------------------
# hybrid_operands
# ---------------------------------------------------------------------------

def _rowmax_bins(rlen_sparse, plan):
    """The reference's per-bin loop bounds: the longest sparse row of each
    bin of the sorted row axis."""
    return torch.stack([rlen_sparse[:, s:e].amax(dim=1) for s, e in plan.bins],
                       dim=1).to(torch.int32)


@pytest.mark.parametrize("name", CASES)
def test_hybrid_operands_match_reference(name):
    """Every operand equals the reference's; its per-bin loop bounds, which
    the CUDA kernel does not read, follow from ``rlen_sparse`` and the
    plan's bins."""
    coo_j, coo_t, m_pad, b = _case(name)
    hj = jb.plan_hybrid(batch=coo_j.batch, m_pad=m_pad, n_b=b.shape[-1],
                        nnz_pad=coo_j.values.shape[1])
    ht = tb.plan_hybrid(batch=coo_t.batch, m_pad=m_pad, n_b=b.shape[-1],
                        nnz_pad=coo_t.nnz_pad)
    rank, st, rl, rowmax, cid, val, slab = j_operands(
        coo_j.row_ids, coo_j.col_ids, coo_j.values, coo_j.nnz, m_pad, hj)
    want = rank, st, rl, cid, val, slab
    got = hybrid_operands(coo_t.row_ids, coo_t.col_ids, coo_t.values,
                          coo_t.nnz, m_pad, ht)
    names = ("rank", "start_s", "rlen_sparse", "cid", "val", "slab")
    assert len(got) == len(names)
    for n, g, w in zip(names, got, want):
        if w is None:
            assert g is None, n
            continue
        assert g.dtype == {np.dtype(np.int32): torch.int32,
                           np.dtype(np.float32): torch.float32}[
                               to_np(w).dtype], n
        np.testing.assert_array_equal(g.numpy(), to_np(w), err_msg=n)
    np.testing.assert_array_equal(_rowmax_bins(got[2], ht).numpy(),
                                  to_np(rowmax))
    if name in ("skewed", "powerlaw"):
        assert got[-1] is not None and bool(got[-1].any())


# ---------------------------------------------------------------------------
# batched_spmm: forward and both gradients against the reference's impl
# ---------------------------------------------------------------------------

def _j_fwd_grads(coo, b, impl, t):
    def loss(values, bb):
        c = j_batched_spmm(dataclasses.replace(coo, values=values), bb,
                           impl=impl, k_pad=8, interpret=True)
        return jnp.sum(c * t), c

    (_, c), g = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        coo.values, jnp.asarray(b))
    return to_np(c), to_np(g[0]), to_np(g[1])


@functools.lru_cache(maxsize=None)
def _jax_spmm(name: str, impl: str):
    coo_j, _, _, b = _case(name)
    t = np.random.default_rng(2).normal(size=b.shape).astype(np.float32)
    return _j_fwd_grads(coo_j, b, impl, jnp.asarray(t)), t


def _port_fwd_grads(coo, b, impl, t):
    v = coo.values.clone().requires_grad_()
    bb = torch.from_numpy(b).requires_grad_()
    c = ops.batched_spmm(coo.with_values(v), bb, impl=impl, k_pad=8)
    (c * torch.from_numpy(t)).sum().backward()
    return c.detach().numpy(), v.grad.numpy(), bb.grad.numpy()


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("impl", HYBRID_IMPLS)
def test_batched_spmm_hybrid_matches_reference(impl, name):
    """Forward, dValues and dB of each hybrid impl against the reference's
    same impl (its Pallas kernel in interpret mode for pallas_hybrid)."""
    _, coo_t, _, b = _case(name)
    (want_c, want_dv, want_db), t = _jax_spmm(name, impl)
    got_c, got_dv, got_db = _port_fwd_grads(coo_t, b, impl, t)
    np.testing.assert_allclose(got_c, want_c, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_dv, want_dv, atol=3 * ATOL,
                               rtol=3 * RTOL)
    np.testing.assert_allclose(got_db, want_db, atol=3 * ATOL,
                               rtol=3 * RTOL)


@pytest.mark.parametrize("name", CASES)
def test_hybrid_plain_version_matches_reference_oracle(name):
    """The kernel's plain version on prepared operands against the
    reference's ``ref`` oracle."""
    coo_j, coo_t, m_pad, b = _case(name)
    want = to_np(j_batched_spmm(coo_j, jnp.asarray(b), impl="ref"))
    hp = tb.plan_hybrid(batch=coo_t.batch, m_pad=m_pad, n_b=b.shape[-1],
                        nnz_pad=coo_t.nnz_pad)
    rank, st, rl, cid, val, slab = hybrid_operands(
        coo_t.row_ids, coo_t.col_ids, coo_t.values, coo_t.nnz, m_pad, hp)
    got = ref.batched_spmm_hybrid_plain(rank, st, rl, cid, val, slab,
                                        torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def _empty():
    return (np.zeros(0, np.int32), np.zeros(0, np.int32),
            np.zeros(0, np.float32))


def test_hybrid_dpad_zero_route_matches_ref():
    """nnz_pad below dmin: the plan sizes no slab and both hybrid impls
    still match ``ref`` (the reference's test_hybrid_dpad_zero_path)."""
    rng = np.random.default_rng(3)
    tri = [(np.asarray([0, 1, 2], np.int32), np.asarray([5, 6, 7], np.int32),
            rng.normal(size=3).astype(np.float32)) for _ in range(2)]
    coo = tf.coo_from_lists(tri, [64, 64])
    hp = tb.plan_hybrid(batch=2, m_pad=64, n_b=16, nnz_pad=coo.nnz_pad)
    assert coo.nnz_pad < hp.dmin and hp.d_pad == 0
    assert hybrid_operands(coo.row_ids, coo.col_ids, coo.values, coo.nnz, 64,
                           hp)[-1] is None
    b = torch.from_numpy(rng.normal(size=(2, 64, 16)).astype(np.float32))
    want = ops.batched_spmm(coo, b, impl="ref")
    for impl in HYBRID_IMPLS:
        torch.testing.assert_close(ops.batched_spmm(coo, b, impl=impl), want,
                                   atol=ATOL, rtol=RTOL)


def test_hybrid_all_empty_rows_give_exact_zeros():
    coo = tf.coo_from_lists([_empty()] * 3, [24, 24, 24])
    b = torch.from_numpy(np.random.default_rng(4).normal(
        size=(3, 24, 16)).astype(np.float32))
    for impl in HYBRID_IMPLS:
        assert not ops.batched_spmm(coo, b, impl=impl).any(), impl


def test_hybrid_exact_threshold_row_classifies_dense():
    """A row whose degree is exactly dmin is a hub (>=): its sparse length
    is zeroed and all its non-zeros land in slab row 0."""
    m_pad = 32
    hp = tb.plan_hybrid(batch=1, m_pad=m_pad, n_b=16, nnz_pad=16)
    dmin = hp.dmin
    rows = np.concatenate([np.zeros(dmin, np.int32),
                           np.asarray([3, 9], np.int32)])
    cols = np.concatenate([np.arange(dmin, dtype=np.int32),
                           np.asarray([1, 2], np.int32)])
    coo = tf.coo_from_lists([(rows, cols, np.ones(rows.size, np.float32))],
                            [m_pad], nnz_pad=16)
    _, _, rlen_sparse, _, _, slab = hybrid_operands(
        coo.row_ids, coo.col_ids, coo.values, coo.nnz, m_pad, hp)
    assert int(tf.row_degrees(coo, m_pad)[0, 0]) == dmin
    assert int(rlen_sparse[0, 0]) == 0
    assert float(slab[0, 0].sum()) == float(dmin)
    assert int(rlen_sparse[0].sum()) == 2
    b = torch.from_numpy(np.random.default_rng(5).normal(
        size=(1, m_pad, 16)).astype(np.float32))
    want = ops.batched_spmm(coo, b, impl="ref")
    for impl in HYBRID_IMPLS + ("pallas_gemm",):
        torch.testing.assert_close(ops.batched_spmm(coo, b, impl=impl), want,
                                   atol=ATOL, rtol=RTOL)


def _mixed_batch():
    """Uniform, hub-skewed, zero-nnz and single-long-row samples in one
    batch (the reference's test_hybrid._mixed_batch draws)."""
    rng = np.random.default_rng(6)
    m = 16
    uni_r = np.repeat(np.arange(m, dtype=np.int32), 2)
    uni_c = np.asarray(rng.integers(0, m, uni_r.size), np.int32)
    skew_r = np.concatenate([np.full(8, 2, np.int32),
                             np.asarray([0, 5, 11], np.int32)])
    skew_c = np.asarray(rng.integers(0, m, skew_r.size), np.int32)
    long_r = np.full(m, 7, np.int32)
    long_c = np.arange(m, dtype=np.int32)
    tri = [(uni_r, uni_c, rng.normal(size=uni_r.size).astype(np.float32)),
           (skew_r, skew_c, rng.normal(size=skew_r.size).astype(np.float32)),
           _empty(),
           (long_r, long_c, rng.normal(size=m).astype(np.float32))]
    coo = tf.coo_from_lists(tri, [m] * 4)
    b = rng.normal(size=(4, m, 24)).astype(np.float32)
    return coo, m, b


@pytest.mark.parametrize("impl", HYBRID_IMPLS + ("pallas_gemm",))
def test_row_permutation_round_trip(impl):
    """Relabel rows by a random per-sample permutation, run the impl and
    undo the permutation: bitwise equal to the unpermuted output, and the
    gradients equal the unpermuted ones at the f32 tolerance."""
    coo, m_pad, b = _mixed_batch()
    rng = np.random.default_rng(7)
    pi = torch.from_numpy(np.stack([rng.permutation(m_pad)
                                    for _ in range(coo.batch)]))
    coo_p = dataclasses.replace(
        coo, row_ids=torch.gather(pi, 1, coo.row_ids.long()).int())
    bt = torch.from_numpy(b)
    out = ops.batched_spmm(coo, bt, impl=impl)
    out_p = ops.batched_spmm(coo_p, bt, impl=impl)
    recover = torch.gather(out_p, 1, pi[:, :, None].expand_as(out_p))
    assert torch.equal(recover, out), impl
    t = torch.from_numpy(np.random.default_rng(8).normal(
        size=out.shape).astype(np.float32))
    t_p = torch.gather(t, 1, torch.argsort(pi, dim=1)[:, :, None]
                       .expand_as(t))
    grads = []
    for a, w in ((coo, t), (coo_p, t_p)):
        v = a.values.clone().requires_grad_()
        bb = bt.clone().requires_grad_()
        (ops.batched_spmm(a.with_values(v), bb, impl=impl) * w).sum() \
            .backward()
        grads.append((v.grad, bb.grad))
    for g_p, g in zip(grads[1], grads[0]):
        torch.testing.assert_close(g_p, g, atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------------------
# the fused_hybrid layer
# ---------------------------------------------------------------------------

def _layer(name, channels=2, n_in=12, n_out=40):
    """Channel 0 the case's COO, the others slot-permuted copies (padding
    then sits anywhere in the visited chunks, as in the oracle's layer
    regime); numpy weights for both packages."""
    coo_j, _, m_pad, _ = _case(name)
    rng = np.random.default_rng(13)
    adj_j = [coo_j]
    for _ in range(1, channels):
        perm = rng.permutation(coo_j.values.shape[1])
        adj_j.append(dataclasses.replace(
            coo_j, row_ids=coo_j.row_ids[:, perm],
            col_ids=coo_j.col_ids[:, perm], values=coo_j.values[:, perm]))
    x = rng.normal(size=(coo_j.batch, m_pad, n_in)).astype(np.float32)
    w = (rng.normal(size=(channels, n_in, n_out)) / 4).astype(np.float32)
    bias = rng.normal(size=(channels, n_out)).astype(np.float32)
    res = rng.normal(size=(coo_j.batch, m_pad, n_out)).astype(np.float32)
    t = rng.normal(size=(coo_j.batch, m_pad, n_out)).astype(np.float32)
    return adj_j, x, w, bias, res, t


@functools.lru_cache(maxsize=None)
def _jax_fused(name: str, impl: str, epilogue: str):
    adj_j, x, w, bias, res, t = _layer(name)
    rj, cj, vj, nj = j_stack(adj_j)

    def loss(v, xx, ww, bb, rr):
        y = j_fused(rj, cj, v, nj, xx, ww, bb, epilogue=epilogue,
                    residual=rr, interpret=True, impl=impl)
        return jnp.sum(y * jnp.asarray(t)), y

    (_, y), g = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4),
                                   has_aux=True)(
        vj, *map(jnp.asarray, (x, w, bias, res)))
    return to_np(y), [to_np(a) for a in g]


def _port_fused(name: str, impl: str, epilogue: str):
    adj_j, x, w, bias, res, t = _layer(name)
    rt, ct, vt, nt = stack_channels([torch_coo(a) for a in adj_j])
    leaves = [a.clone().requires_grad_() for a in
              (vt, *map(torch.from_numpy, (x, w, bias, res)))]
    y = fused_graph_conv(rt, ct, leaves[0], nt, *leaves[1:4],
                         epilogue=epilogue, residual=leaves[4], impl=impl)
    (y * torch.from_numpy(t)).sum().backward()
    return y.detach().numpy(), [a.grad.numpy() for a in leaves]


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("epilogue", ("none", "relu"))
def test_fused_hybrid_matches_reference(name, epilogue):
    """fused_graph_conv(impl="fused_hybrid") with a residual: forward and
    the five gradients (values, x, w, bias, residual) against the
    reference's fused_hybrid (Pallas interpret)."""
    want_y, want_g = _jax_fused(name, "fused_hybrid", epilogue)
    got_y, got_g = _port_fused(name, "fused_hybrid", epilogue)
    np.testing.assert_allclose(got_y, want_y, atol=ATOL, rtol=RTOL)
    for i, (g, w) in enumerate(zip(got_g, want_g)):
        np.testing.assert_allclose(g, w, atol=3 * ATOL, rtol=3 * RTOL,
                                   err_msg=f"grad {i}")


def _hybrid_layer_operands(name):
    adj_j, x, w, bias, res, _ = _layer(name)
    rt, ct, vt, nt = stack_channels([torch_coo(a) for a in adj_j])
    m_pad = x.shape[1]
    hp = tb.plan_hybrid(batch=x.shape[0], m_pad=m_pad, n_b=w.shape[-1],
                        nnz_pad=rt.shape[1] * rt.shape[2])
    return (rt, ct, vt, nt, *map(torch.from_numpy, (x, w, bias, res))), hp


@pytest.mark.parametrize("name", CASES)
def test_fused_hybrid_forward_equals_fused(name):
    """The split changes only where each sum is taken: fused_hybrid_forward
    against the plain fused layer, with ReLU and a residual."""
    (rt, ct, vt, nt, x, w, bias, res), hp = _hybrid_layer_operands(name)
    assert hp.d_pad > 0 or name == "zero_nnz"
    got = fused_hybrid_forward(rt, ct, vt, nt, x, w, bias, res, hplan=hp,
                               epilogue="relu")
    want = fused_graph_conv(rt, ct, vt, nt, x, w, bias, epilogue="relu",
                            residual=res)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


def test_fused_hybrid_dpad_zero_takes_plain_fused_kernel(monkeypatch):
    """With d_pad == 0 (the layer's slots below dmin) the plain fused
    kernel runs, without rank or slab, as in the reference."""
    (rt, ct, vt, nt, x, w, bias, res), _ = _hybrid_layer_operands("uniform")
    hp = tb.plan_hybrid(batch=x.shape[0], m_pad=x.shape[1], n_b=w.shape[-1],
                        nnz_pad=2)
    assert hp.d_pad == 0
    seen = []
    real = ref.fused_graph_conv_plain

    def spy(*a, **k):
        seen.append(a[9:] + tuple(k.values()))
        return real(*a, **k)

    monkeypatch.setattr(ref, "fused_graph_conv_plain", spy)
    got = fused_hybrid_forward(rt, ct, vt, nt, x, w, bias, res, hplan=hp,
                               epilogue="relu")
    assert seen == [(None, None, None)]     # rank, slab, hubs
    want = real(rt, ct, vt, (nt + 127) // 128, x, w, bias, res, "relu")
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_fused_plain_hybrid_branch_matches_reference_kernel():
    """The plain version's rank/slab branch against the reference's
    fused_forward with the same rank and slab (Pallas interpret)."""
    from repro.kernels.fused_graph_conv import fused_forward as j_forward

    (rt, ct, vt, nt, x, w, bias, res), _ = _hybrid_layer_operands("skewed")
    rng = np.random.default_rng(21)
    batch, m_pad = x.shape[0], x.shape[1]
    rank = np.stack([rng.permutation(m_pad) for _ in range(batch)]).astype(
        np.int32)
    slab = rng.normal(size=(batch, rt.shape[1], 8, m_pad)).astype(np.float32)
    chunks = (nt + 127) // 128
    plan = jb.plan_fused_graph_conv(batch=batch, m_pad=m_pad, n_in=12,
                                    n_out=40, channels=2,
                                    nnz_pad=rt.shape[2])
    want = to_np(j_forward(*(jnp.asarray(a.numpy()) for a in
                             (rt, ct, vt, chunks, x, w, bias, res)),
                           jnp.asarray(rank), jnp.asarray(slab), plan=plan,
                           epilogue="relu", interpret=True))
    got = fused_forward(rt, ct, vt, chunks.int(), x, w, bias, res,
                        torch.from_numpy(rank), torch.from_numpy(slab),
                        epilogue="relu")
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------------------
# the model and the trainer
# ---------------------------------------------------------------------------

def trainer_curve(impl: str, tmp_path, steps: int):
    """The losses of ``steps`` GCNTrainer steps of ``impl`` from the
    reference's seed state on the 8-molecule Tox21 batches of
    ``test_torch_training``, and the reference's ``ref`` curve over the
    same batches."""
    from repro.optim import adam as jadam
    from repro_torch.convert import opt_state_from_jax
    from repro_torch.data import graphs as tgraphs
    from repro_torch.training.trainer import GCNTrainer, TrainerConfig
    from test_torch_gcn import _port_cfg, _setup
    from test_torch_training import _curve_batches, _jax_curve

    cfg, np_params, _, _ = _setup("tox21")
    pcfg = _port_cfg(cfg, impl=impl)
    trainer = GCNTrainer(pcfg, tcfg=TrainerConfig(str(tmp_path)),
                         device="cpu")
    params = params_from_jax(np_params, pcfg, device="cpu")
    state = opt_state_from_jax(jax.tree.map(
        np.asarray, jadam.adam_init(np_params)), pcfg, device="cpu")
    losses = []
    for b in _curve_batches(tgraphs)[:steps]:
        params, state, m = trainer.train_step(params, state,
                                              trainer.place_batch(b))
        losses.append(m["loss"].item())
    assert int(state["step"]) == steps
    return np.asarray(losses), _jax_curve("ref")[0][:steps]


@pytest.mark.parametrize("impl", ("pallas_hybrid", "fused_hybrid"))
def test_tox21_logits_match_reference_same_impl(impl):
    from test_torch_gcn import _jax_logits, _port_logits

    got = _port_logits("tox21", "sample", impl)
    np.testing.assert_allclose(got, _jax_logits("tox21", "sample", impl),
                               atol=1e-4)


@pytest.mark.parametrize("impl", ("hybrid", "pallas_hybrid",
                                  "fused_hybrid"))
def test_gcn_loss_and_grads_match_reference(impl):
    check_gcn_loss_and_grads(impl)


def check_gcn_loss_and_grads(impl: str) -> None:
    """gcn_loss and its parameter gradients with ``impl`` against the
    reference's ``ref`` on the 8-molecule Tox21 batch."""
    from test_torch_gcn import _port_cfg, _setup
    from test_torch_training import _jax_loss_and_grads

    cfg, np_params, _, bt = _setup("tox21")
    pcfg = _port_cfg(cfg, impl=impl)
    params = params_from_jax(np_params, pcfg, device="cpu")
    leaves = [p.requires_grad_() for p in tree.leaves(params)]
    loss, _ = tgcn.gcn_loss(params, pcfg, bt["adj"], bt["x"], bt["n_nodes"],
                            bt["labels"])
    grads = torch.autograd.grad(loss, leaves)
    want_loss, _, want_grads = _jax_loss_and_grads("tox21")
    np.testing.assert_allclose(loss.item(), want_loss, atol=ATOL, rtol=RTOL)
    for i, (g, w) in enumerate(zip(grads, jax.tree.leaves(want_grads))):
        np.testing.assert_allclose(g.numpy(), w, atol=3 * ATOL,
                                   rtol=3 * RTOL, err_msg=f"{impl} leaf {i}")


@pytest.mark.parametrize("impl", ("hybrid", "pallas_hybrid",
                                  "fused_hybrid"))
def test_trainer_steps_track_reference_curve(impl, tmp_path):
    """Five GCNTrainer steps from the reference's state: the loss curve
    within 1e-4 relative of the reference's ``ref`` curve."""
    got, want = trainer_curve(impl, tmp_path, steps=5)
    np.testing.assert_allclose(got, want, rtol=1e-4)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def test_hybrid_wrappers_never_fall_back_off_the_cpu(monkeypatch):
    """A tensor off the CPU launches the kernel or raises: here (no card)
    meta tensors must raise, and the plain versions must not run."""
    def boom(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(ref, "batched_spmm_hybrid_plain", boom)
    monkeypatch.setattr(ref, "fused_graph_conv_plain", boom)
    coo, m_pad, b = _mixed_batch()
    hp = tb.plan_hybrid(batch=coo.batch, m_pad=m_pad, n_b=24,
                        nnz_pad=coo.nnz_pad)
    meta = [t.to("meta") for t in (coo.row_ids, coo.col_ids, coo.values,
                                   coo.nnz, torch.from_numpy(b))]
    with pytest.raises(ValueError, match="CUDA"):
        batched_spmm_hybrid(*meta, plan=hp)
    with pytest.raises(ValueError, match="CUDA"):
        batched_spmm_hybrid(*meta[:4], torch.from_numpy(b), plan=hp)
    ops_ = hybrid_operands(coo.row_ids, coo.col_ids, coo.values, coo.nnz,
                           m_pad, hp)
    with pytest.raises(ValueError, match="CUDA"):
        hybrid_launch(*ops_, torch.from_numpy(b), plan=hp)
    (rt, ct, vt, nt, x, w, bias, res), _ = _hybrid_layer_operands("skewed")
    rank = torch.zeros((x.shape[0], x.shape[1]), dtype=torch.int32)
    slab = torch.zeros((x.shape[0], 2, 8, x.shape[1]))
    with pytest.raises(ValueError, match="CUDA"):
        fused_forward(*(t.to("meta") for t in (rt, ct, vt, nt.int(), x, w,
                                               bias, res, rank, slab)))


def test_hybrid_wrappers_reject_what_the_kernels_do_not_take():
    coo, m_pad, b = _mixed_batch()
    bt = torch.from_numpy(b)
    hp = tb.plan_hybrid(batch=coo.batch, m_pad=m_pad, n_b=24,
                        nnz_pad=coo.nnz_pad)
    with pytest.raises(TypeError, match="dtype"):
        batched_spmm_hybrid(coo.row_ids.long(), coo.col_ids, coo.values,
                            coo.nnz, bt, plan=hp)
    with pytest.raises(ValueError, match="does not match"):
        batched_spmm_hybrid(coo.row_ids, coo.col_ids, coo.values, coo.nnz,
                            bt[:, :, :8].contiguous(), plan=hp)
    (rt, ct, vt, nt, x, w, bias, res), _ = _hybrid_layer_operands("skewed")
    with pytest.raises(ValueError, match="together"):
        fused_forward(rt, ct, vt, nt.int(), x, w, bias, res,
                      torch.zeros((x.shape[0], x.shape[1]),
                                  dtype=torch.int32))
    with pytest.raises(ValueError, match="slab"):
        fused_forward(rt, ct, vt, nt.int(), x, w, bias, res,
                      torch.zeros((x.shape[0], x.shape[1]),
                                  dtype=torch.int32),
                      torch.zeros((x.shape[0], 2, x.shape[1] + 1,
                                   x.shape[1])))
    # the reference's hybrid split needs m_pad a multiple of 8
    odd = tf.coo_from_lists([(np.array([0], np.int32), np.array([1], np.int32),
                              np.ones(1, np.float32))], [10])
    with pytest.raises(ValueError, match="does not match"):
        ops.batched_spmm(odd, torch.ones((1, 10, 4)), impl="pallas_hybrid")


def test_hybrid_launch_counters_and_sources_present():
    for fn in (batched_spmm_hybrid, fused_hybrid_forward, fused_forward):
        assert isinstance(fn.launches, int)
    assert {"batched_spmm_hybrid", "fused_graph_conv"} <= set(_build.SOURCES)
    src = (_build.CSRC / "fused_graph_conv.cu").read_text()
    assert 'extern "C" int fused_graph_conv_hybrid_f32(' in src
    before = (batched_spmm_hybrid.launches, fused_hybrid_forward.launches)
    coo, m_pad, b = _mixed_batch()
    ops.batched_spmm(coo, torch.from_numpy(b), impl="pallas_hybrid")
    assert (batched_spmm_hybrid.launches,
            fused_hybrid_forward.launches) == before


def test_registry_and_backward_classes():
    """The reference's bwd_impl_for for the new names; fused_hybrid is a
    layer impl that batched_spmm refuses."""
    assert {"hybrid", "pallas_hybrid", "pallas_gemm",
            "fused_hybrid"} <= set(ops.IMPLS)
    assert {"pallas_hybrid", "pallas_gemm", "fused_hybrid"} <= set(
        ops.KERNEL_IMPLS)
    from repro.kernels.ops import bwd_impl_for as j_bwd

    for impl in ops.IMPLS:
        assert ops.bwd_impl_for(impl) == j_bwd(impl), impl
    coo, _, b = _mixed_batch()
    with pytest.raises(ValueError, match="graph_conv_batched"):
        ops.batched_spmm(coo, torch.from_numpy(b), impl="fused_hybrid")
