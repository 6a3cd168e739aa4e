"""Port parity: the gradients of the ported kernels' autograd Functions
against the reference's custom VJPs, on the oracle's three regimes.

``batched_spmm``: forward, dValues and dB of every impl of the port's
registry against the same impl of the reference (its Pallas kernels in
interpret mode), at the f32 tolerance of ``tests/oracle.py`` (1e-4 abs,
1e-5 rel). ``fused_graph_conv``: the gradients of values, x, w, bias and
residual at 3x that tolerance (the layer-gradient rule of
``oracle.check_layer_grads``). On the CPU every kernel wrapper runs its
plain version; which kernels a backward would launch is checked by
counting wrapper calls.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import TOLS
from repro.core.spmm import batched_spmm as j_batched_spmm
from repro.kernels import ops as j_ops
from repro.kernels.fused_graph_conv import fused_graph_conv as j_fused
from repro_torch.core.graph_conv import stack_channels
from repro_torch.kernels import ops
from repro_torch.kernels import fused_graph_conv as fgc
from repro_torch.kernels.fused_graph_conv import fused_graph_conv
from test_torch_formats import CASE_NAMES, case, to_np, torch_coo
from test_torch_kernels import _layer_inputs

ATOL, RTOL = TOLS["f32"]
SPMM_IMPLS = ("ref", "ell", "pallas_ell", "csr", "pallas_csr", "pallas_coo",
              "dense", "loop")


@functools.lru_cache(maxsize=None)
def _jax_spmm_vjp(name: str, impl: str):
    """(C, dValues, dB) of the reference for sum(tanh(C))."""
    coo, _, _, b, k_pad = case(name)

    def f(values, bb):
        return j_batched_spmm(dataclasses.replace(coo, values=values), bb,
                              impl=impl, k_pad=k_pad, interpret=True)

    @jax.jit     # one compile instead of many eager dispatches
    def fwd_bwd(values, bb):
        c, vjp = jax.vjp(f, values, bb)
        return (c, *vjp(1.0 - jnp.tanh(c) ** 2))

    return tuple(map(to_np, fwd_bwd(coo.values, jnp.asarray(b))))


def _port_spmm_vjp(name: str, impl: str):
    _, coo, _, b, k_pad = case(name)
    v = coo.values.clone().requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    c = ops.batched_spmm(coo.with_values(v), bt, impl=impl, k_pad=k_pad)
    torch.tanh(c).sum().backward()
    return c.detach().numpy(), v.grad.numpy(), bt.grad.numpy()


@pytest.mark.parametrize("name", CASE_NAMES)
@pytest.mark.parametrize("impl", SPMM_IMPLS)
def test_batched_spmm_forward_and_grads_match_reference(impl, name):
    got = _port_spmm_vjp(name, impl)
    want = _jax_spmm_vjp(name, impl)
    for what, g, w in zip(("forward", "dvalues", "db"), got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL,
                                   err_msg=f"{impl} {what} on {name}")


def test_registry_and_backward_classes_match_reference():
    assert set(ops.IMPLS) <= set(j_ops.IMPLS)
    for impl in ops.IMPLS:
        assert ops.bwd_impl_for(impl) == j_ops.bwd_impl_for(impl), impl
    assert [ops.bwd_impl_for(i) for i in ops.KERNEL_IMPLS] == \
        ["pallas_coo", "pallas_csr", "pallas_coo", "pallas_csr",
         "pallas_coo", "pallas_coo", "pallas_coo"]


def test_dvalues_covers_padded_slots_like_reference():
    """dValues is taken over every slot: a padded slot at (row 0, col 0)
    gets <dC[0], B[0]>, not 0."""
    _, coo, m_pad, b, _ = case("skewed")
    rng = np.random.default_rng(3)
    dc = rng.normal(size=b.shape).astype(np.float32)
    got = ops.dvalues(coo.row_ids, coo.col_ids, torch.from_numpy(dc),
                      torch.from_numpy(b)).numpy()
    cj, _, _, _, _ = case("skewed")
    want = to_np(j_ops.dvalues(cj.row_ids, cj.col_ids, jnp.asarray(dc),
                               jnp.asarray(b)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    pad = ~(np.arange(coo.nnz_pad)[None] < coo.nnz.numpy()[:, None])
    assert pad.any() and np.abs(got[pad]).max() > 0


def _count_calls(monkeypatch, module, names):
    calls = {n: 0 for n in names}
    for n in names:
        fn = getattr(module, n)

        def counted(*a, _fn=fn, _n=n, **k):
            calls[_n] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(module, n, counted)
    return calls


@pytest.mark.parametrize("impl,fwd,bwd", [
    ("pallas_coo", "batched_spmm_coo", "batched_spmm_coo"),
    ("pallas_ell", "batched_spmm_ell", "batched_spmm_coo"),
    ("pallas_csr", "batched_spmm_csr", "batched_spmm_csr"),
])
def test_kernel_impls_run_their_kernel_forward_and_backward(monkeypatch,
                                                            impl, fwd, bwd):
    """Each kernel impl calls its kernel wrapper once forward and its
    backward class's wrapper once for dB; dValues, not asked for here,
    is not computed."""
    calls = _count_calls(monkeypatch, ops, ("batched_spmm_coo",
                                            "batched_spmm_ell",
                                            "batched_spmm_csr"))

    def boom(*a, **k):
        raise AssertionError("dvalues computed though values need no grad")

    monkeypatch.setattr(ops, "dvalues", boom)
    _, coo, _, b, k_pad = case("uniform")
    bt = torch.from_numpy(b).requires_grad_()
    c = ops.batched_spmm(coo, bt, impl=impl, k_pad=k_pad)
    assert calls[fwd] == 1 and sum(calls.values()) == 1
    c.sum().backward()
    assert calls[bwd] == 1 + (fwd == bwd) and sum(calls.values()) == 2
    assert torch.isfinite(bt.grad).all()


def test_fused_backward_runs_the_coo_kernel(monkeypatch):
    calls = _count_calls(monkeypatch, ops, ("batched_spmm_coo",))
    fwd = _count_calls(monkeypatch, fgc, ("fused_forward",))
    adj_j, x, w, bias, _ = _layer_inputs("uniform")
    rt, ct, vt, nt = stack_channels([torch_coo(a) for a in adj_j])
    wt = torch.from_numpy(w).requires_grad_()
    y = fused_graph_conv(rt, ct, vt, nt, torch.from_numpy(x), wt,
                         torch.from_numpy(bias), epilogue="relu")
    assert fwd == {"fused_forward": 1} and calls["batched_spmm_coo"] == 0
    y.sum().backward()
    assert calls["batched_spmm_coo"] == 1 and torch.isfinite(wt.grad).all()


@functools.lru_cache(maxsize=None)
def _jax_fused_grads(name: str, epilogue: str, residual: bool):
    from repro.core.graph_conv import stack_channels as j_stack

    adj_j, x, w, bias, res = _layer_inputs(name)
    rj, cj, vj, nj = j_stack(adj_j)

    def loss(vals, xx, ww, bb, rr):
        y = j_fused(rj, cj, vals, nj, xx, ww, bb, epilogue=epilogue,
                    residual=rr if residual else None, interpret=True)
        return jnp.sum(jnp.tanh(y))

    g = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        vj, *(jnp.asarray(a) for a in (x, w, bias, res)))
    return [to_np(a) for a in g]


@pytest.mark.parametrize("name", CASE_NAMES)
@pytest.mark.parametrize("epilogue,residual", [("none", False),
                                               ("relu", True)])
def test_fused_graph_conv_grads_match_reference(name, epilogue, residual):
    adj_j, x, w, bias, res = _layer_inputs(name)
    rt, ct, vt, nt = stack_channels([torch_coo(a) for a in adj_j])
    leaves = [t.clone().requires_grad_() for t in (
        vt, *(torch.from_numpy(a) for a in (x, w, bias, res)))]
    y = fused_graph_conv(rt, ct, leaves[0], nt, *leaves[1:4],
                         epilogue=epilogue,
                         residual=leaves[4] if residual else None)
    torch.tanh(y).sum().backward()
    want = _jax_fused_grads(name, epilogue, residual)
    for i, what in enumerate(("values", "x", "w", "bias", "residual")):
        if what == "residual" and not residual:
            assert leaves[4].grad is None
            continue
        np.testing.assert_allclose(
            leaves[i].grad.numpy(), want[i], atol=3 * ATOL, rtol=3 * RTOL,
            err_msg=f"d{what} {epilogue} on {name}")
