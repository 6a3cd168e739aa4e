"""Port parity: g-SpMM message passing (``batched_gspmm``,
``message_passing``, ``segment_softmax``) and the vector-edge format
conversions against the JAX reference, on the oracle's three regimes.

Every ``(op, reduce)`` corner with scalar and vector edges, for every
g-SpMM impl of the port (on the CPU the kernel wrappers run their plain
versions), is held against the reference's ``batched_gspmm`` with
``impl="ref"``: the forward and both gradients of ``sum(tanh(C))``, at the
f32 tolerance of ``tests/oracle.py``. The reference's own Pallas kernels
run in interpret mode on a tiny case, as its tests run them.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import GSPMM_MATRIX, TOLS, gspmm_cases, gspmm_valid_mask
from repro.core import formats as jf
from repro.core.message_passing import message_passing as j_message_passing
from repro.kernels import ops as j_ops
from repro.kernels.segment_softmax import segment_softmax as j_softmax
from repro_torch.core import formats as tf
from repro_torch.core.message_passing import (
    message_passing,
    resolve_message_passing_impl,
)
from repro_torch.kernels import ops
from repro_torch.kernels.segment_softmax import segment_softmax
from test_torch_formats import CASE_NAMES, _j_coo_to_ell, to_np, torch_coo

ATOL, RTOL = TOLS["f32"]
GSPMM_IMPLS = ("ref", "loop", "ell", "csr", "pallas_ell", "pallas_csr",
               "pallas_coo")
CORNERS = [f"{op}-{red}" for op, red in GSPMM_MATRIX]
_j_coo_to_csr = jax.jit(jf.coo_to_csr, static_argnums=1)


@functools.lru_cache(maxsize=None)
def _cases(edges: str):
    return [(name, coo, m_pad, to_np(b), k_pad)
            for name, coo, m_pad, b, k_pad in gspmm_cases(edges)]


def _jax_vjp(coo, b, op, reduce, impl, k_pad, interpret=True):
    def f(values, bb):
        return j_ops.batched_gspmm(dataclasses.replace(coo, values=values),
                                   bb, op=op, reduce=reduce, impl=impl,
                                   k_pad=k_pad, interpret=interpret)

    @jax.jit
    def fwd_bwd(values, bb):
        c, vjp = jax.vjp(f, values, bb)
        return (c, *vjp(1.0 - jnp.tanh(c) ** 2))

    return tuple(map(to_np, fwd_bwd(coo.values, jnp.asarray(b))))


@functools.lru_cache(maxsize=None)
def _reference(edges: str, corner: str):
    """(C, dValues, dB) of the reference's impl="ref" per regime."""
    op, reduce = corner.split("-")
    return [_jax_vjp(coo, b, op, reduce, "ref", k_pad)
            for _, coo, _, b, k_pad in _cases(edges)]


def _port_vjp(coo_t, b, op, reduce, impl, k_pad):
    v = coo_t.values.clone().requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    c = ops.batched_gspmm(coo_t.with_values(v), bt, op=op, reduce=reduce,
                          impl=impl, k_pad=k_pad)
    torch.tanh(c).sum().backward()
    return c.detach().numpy(), v.grad.numpy(), bt.grad.numpy()


@pytest.mark.parametrize("edges", ("scalar", "vector"))
@pytest.mark.parametrize("corner", CORNERS)
@pytest.mark.parametrize("impl", GSPMM_IMPLS)
def test_gspmm_forward_and_grads_match_reference(impl, corner, edges):
    op, reduce = corner.split("-")
    for (name, coo, _, b, k_pad), want in zip(_cases(edges),
                                              _reference(edges, corner)):
        got = _port_vjp(torch_coo(coo), b, op, reduce, impl, k_pad)
        # dValues at the valid slots: the delegated (mul, sum) scalar corner
        # reports unmasked cotangents at padding (oracle.check_gspmm_grads)
        vm = gspmm_valid_mask(coo)
        if got[1].ndim == 3:
            vm = vm[..., None]
        for what, g, w in zip(("forward", "dvalues", "db"),
                              (got[0], got[1] * vm, got[2]),
                              (want[0], want[1] * vm, want[2])):
            np.testing.assert_allclose(
                g, w, atol=ATOL, rtol=RTOL,
                err_msg=f"{impl} {corner} {edges} {what} on {name}")


def _tiny(edges: str):
    """A case the reference's Pallas kernels run in interpret mode at
    small cost: 2 matrices of 8 rows, n_b 8, one empty row, one row with
    two edges to the same column."""
    rows = np.array([0, 0, 0, 2, 3, 3, 5, 7], np.int32)
    cols = np.array([1, 1, 4, 2, 0, 6, 5, 3], np.int32)
    rng = np.random.default_rng(3)
    tri = [(rows, cols, rng.normal(size=8).astype(np.float32)),
           (rows[:5], cols[:5][::-1].copy(),
            rng.normal(size=5).astype(np.float32))]
    coo = jf.coo_from_lists(tri, [8, 8], nnz_pad=8)
    if edges == "vector":
        vv = rng.normal(size=(2, 8, 8)).astype(np.float32)
        coo = dataclasses.replace(coo, values=jnp.asarray(
            np.where(gspmm_valid_mask(coo)[..., None], vv, 0.0)))
    b = rng.normal(size=(2, 8, 8)).astype(np.float32)
    return coo, b


@pytest.mark.parametrize("corner,edges", [("copy_lhs-mean", "scalar"),
                                          ("mul-sum", "vector"),
                                          ("add-max", "scalar"),
                                          ("mul-max", "vector")])
@pytest.mark.parametrize("impl", ("pallas_ell", "pallas_csr", "pallas_coo"))
def test_gspmm_matches_reference_kernels_in_interpret_mode(impl, corner,
                                                           edges):
    """The port's kernel impls against the SAME impl of the reference, its
    Pallas kernel run in interpret mode (forward and both gradients)."""
    op, reduce = corner.split("-")
    coo, b = _tiny(edges)
    want = _jax_vjp(coo, b, op, reduce, impl, 3)
    got = _port_vjp(torch_coo(coo), b, op, reduce, impl, 3)
    for what, g, w in zip(("forward", "dvalues", "db"), got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL,
                                   err_msg=f"{impl} {corner} {what}")


@pytest.mark.parametrize("name", CASE_NAMES)
def test_vector_edge_conversions_bitwise(name):
    """coo_to_ell / coo_to_csr carry (batch, nnz_pad, d_e) vector edges
    exactly as the reference's do (the dropped slots zeroed)."""
    for case_name, coo, m_pad, _, k_pad in _cases("vector"):
        if case_name != name:
            continue
        ct = torch_coo(coo)
        ell_j = _j_coo_to_ell(coo, m_pad, k_pad)
        ell_t = tf.coo_to_ell(ct, m_pad, k_pad)
        assert ell_t.values.shape == ell_j.values.shape
        np.testing.assert_array_equal(ell_t.values.numpy(),
                                      to_np(ell_j.values))
        np.testing.assert_array_equal(ell_t.col_ids.numpy(),
                                      to_np(ell_j.col_ids))
        csr_j = _j_coo_to_csr(coo, m_pad)
        csr_t = tf.coo_to_csr(ct, m_pad)
        np.testing.assert_array_equal(csr_t.values.numpy(),
                                      to_np(csr_j.values))
        np.testing.assert_array_equal(csr_t.rpt.numpy(), to_np(csr_j.rpt))
        # a narrower k_pad drops slots: their vector values are zeroed too
        if k_pad > 1:
            np.testing.assert_array_equal(
                tf.coo_to_ell(ct, m_pad, k_pad - 1).values.numpy(),
                to_np(_j_coo_to_ell(coo, m_pad, k_pad - 1).values))


def _softmax_inputs(name, heads):
    for case_name, coo, m_pad, _, _ in _cases("scalar"):
        if case_name == name:
            rng = np.random.default_rng(7)
            shape = coo.row_ids.shape + ((heads,) if heads else ())
            return coo, m_pad, (rng.normal(size=shape) * 3).astype(
                np.float32), rng.normal(size=shape).astype(np.float32)
    raise KeyError(name)


@pytest.mark.parametrize("heads", (0, 3))
@pytest.mark.parametrize("name", CASE_NAMES)
def test_segment_softmax_forward_and_vjp_match_reference(name, heads):
    coo, m_pad, s, g = _softmax_inputs(name, heads)
    out_j, vjp = jax.vjp(lambda x: j_softmax(x, coo.row_ids, nnz=coo.nnz,
                                             m_pad=m_pad), jnp.asarray(s))
    (ds_j,) = vjp(jnp.asarray(g))
    ct = torch_coo(coo)
    st = torch.from_numpy(s).requires_grad_()
    out_t = segment_softmax(st, ct.row_ids, nnz=ct.nnz, m_pad=m_pad)
    out_t.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out_t.detach().numpy(), to_np(out_j),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(st.grad.numpy(), to_np(ds_j), atol=ATOL,
                               rtol=RTOL)
    valid = gspmm_valid_mask(coo)
    assert (out_t.detach().numpy()[~valid] == 0).all()
    assert (st.grad.numpy()[~valid] == 0).all()


def test_message_passing_matches_reference_and_gspmm():
    cases = _cases("scalar")
    name, coo, m_pad, b, k_pad = cases[0]
    ct = torch_coo(coo)
    for op, reduce in (("copy_lhs", "max"), ("mul", "sum"), ("add", "mean")):
        want = to_np(j_message_passing(coo, jnp.asarray(b), op=op,
                                       reduce=reduce, impl="csr"))
        got = message_passing(ct, torch.from_numpy(b), op=op, reduce=reduce,
                              impl="csr")
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
        np.testing.assert_array_equal(
            got.numpy(), ops.batched_gspmm(ct, torch.from_numpy(b), op=op,
                                           reduce=reduce, impl="csr").numpy())
    # impl="auto" resolves over the g-SpMM ladder, as the reference's: a
    # pinned impl is the same forced Decision, "auto" one the CPU runs (no
    # kernel impl ranked) that gives the pinned impl's bits
    bt = torch.from_numpy(b)
    for op, reduce in (("copy_lhs", "mean"), ("add", "max")):
        d = resolve_message_passing_impl(ct, bt, op=op, reduce=reduce)
        assert d.source == "model" and ops.supports_gspmm(d.impl)
        assert not d.impl.startswith("pallas") and d.workload.is_gspmm
        np.testing.assert_array_equal(
            message_passing(ct, bt, op=op, reduce=reduce).numpy(),
            message_passing(ct, bt, op=op, reduce=reduce,
                            impl=d.impl).numpy())
        f = resolve_message_passing_impl(ct, bt, op=op, reduce=reduce,
                                         impl="csr")
        jf_ = j_ops.resolve_gspmm_impl(coo, jnp.asarray(b), op=op,
                                       reduce=reduce, impl="csr")
        assert (f.impl, f.kind, f.source, f.workload.key()) == (
            jf_.impl, jf_.kind, jf_.source, jf_.workload.key())


def test_gspmm_validates_op_reduce_and_impl():
    _, coo, m_pad, b, k_pad = _cases("vector")[0]
    ct, bt = torch_coo(coo), torch.from_numpy(b)
    with pytest.raises(ValueError, match="op"):
        ops.batched_gspmm(ct, bt, op="sub", impl="ref")
    with pytest.raises(ValueError, match="reduce"):
        ops.batched_gspmm(ct, bt, reduce="min", impl="ref")
    for impl in ("dense", "pallas_gemm", "hybrid", "pallas_hybrid"):
        with pytest.raises(ValueError, match="cannot run g-SpMM"):
            ops.batched_gspmm(ct, bt, reduce="max", impl=impl)
    # impl="auto" picks a g-SpMM-capable impl and gives its bits
    d = ops.resolve_gspmm_impl(ct, bt, reduce="max")
    assert ops.supports_gspmm(d.impl) and d.workload.d_e == bt.shape[-1]
    np.testing.assert_array_equal(
        ops.batched_gspmm(ct, bt, reduce="max", impl="auto",
                          k_pad=k_pad).numpy(),
        ops.batched_gspmm(ct, bt, reduce="max", impl=d.impl,
                          k_pad=k_pad).numpy())
    with pytest.raises(ValueError, match="k_pad"):
        ops.batched_gspmm(ct, bt, reduce="max", impl="pallas_ell")
    with pytest.raises(ValueError, match="k_pad"):
        ops.batched_gspmm(ct, bt, reduce="max", impl="ell", k_pad=k_pad - 1)
    assert ops.GSPMM_IMPLS == j_ops.GSPMM_IMPLS
    assert ops.GSPMM_OPS == j_ops.GSPMM_OPS
    assert ops.GSPMM_REDUCES == j_ops.GSPMM_REDUCES
    for impl in ops.IMPLS:
        assert ops.supports_gspmm(impl) == j_ops.supports_gspmm(impl), impl


@pytest.mark.parametrize("corner,edges,bwd_kernel", [
    ("copy_lhs-mean", "scalar", None),     # R-GCN: backward is plain
    ("mul-sum", "vector", None),           # GAT: backward is plain
    ("mul-mean", "scalar", "class"),       # dB through the SpMM class
])
@pytest.mark.parametrize("impl", ("pallas_ell", "pallas_csr", "pallas_coo"))
def test_gspmm_kernel_calls_per_forward_and_backward(monkeypatch, impl,
                                                     corner, edges,
                                                     bwd_kernel):
    """Which kernel wrappers a g-SpMM forward and backward call: one
    g-SpMM entry of ``impl``'s kernel forward; the backward calls the
    kernel of ``bwd_impl_for(impl)`` only in the (mul, sum/mean) scalar
    corner."""
    calls = []
    for name in ("batched_spmm_ell", "batched_spmm_csr", "batched_spmm_coo"):
        real = getattr(ops, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls.append((_name, kw.get("op", "mul"), kw.get("reduce")))
            return _real(*a, **kw)

        monkeypatch.setattr(ops, name, counted)
    op, reduce = corner.split("-")
    name, coo, m_pad, b, k_pad = _cases(edges)[0]
    fwd_name = {"pallas_ell": "batched_spmm_ell",
                "pallas_csr": "batched_spmm_csr",
                "pallas_coo": "batched_spmm_coo"}
    v = torch_coo(coo).values.clone().requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    c = ops.batched_gspmm(torch_coo(coo).with_values(v), bt, op=op,
                          reduce=reduce, impl=impl, k_pad=k_pad)
    assert calls == [(fwd_name[impl], op, reduce)]
    c.sum().backward()
    bwd = calls[1:]
    if bwd_kernel is None:
        assert bwd == []
    else:
        assert bwd == [(fwd_name[ops.bwd_impl_for(impl)], "mul", None)]
