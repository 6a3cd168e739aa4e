"""Port parity: the kernel wrappers' plain versions and the SpMM dispatch
(repro_torch.kernels) against the JAX reference — its Pallas kernels in
interpret mode and its ``ref`` oracle — on the oracle's three regimes at f32
``TOLS``. On the CPU every kernel wrapper runs its plain version; a tensor
on any other device launches the kernel or raises, never falls back.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import TOLS
from repro.core.spmm import batched_spmm as j_batched_spmm
from repro.kernels.fused_graph_conv import fused_graph_conv as j_fused
from repro_torch.core import batching as tb
from repro_torch.core.formats import coo_from_lists
from repro_torch.core.graph_conv import stack_channels
from repro_torch.kernels import _build, ref
from repro_torch.kernels import ops
from repro_torch.kernels.batched_gemm import batched_gemm
from repro_torch.kernels.batched_spmm_coo import batched_spmm_coo
from repro_torch.kernels.batched_spmm_csr import batched_spmm_csr
from repro_torch.kernels.batched_spmm_ell import batched_spmm_ell
from repro_torch.kernels.batched_spmm_hybrid import batched_spmm_hybrid
from repro_torch.kernels.fused_graph_conv import (
    fused_forward,
    fused_graph_conv,
    fused_hybrid_forward,
    runtime_chunks,
)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.grouped_matmul import _gmm
from test_torch_formats import CASE_NAMES, case, to_np, torch_coo

ATOL, RTOL = TOLS["f32"]
PORT_SPMM_IMPLS = ("ref", "ell", "pallas_ell", "csr", "pallas_csr",
                   "pallas_coo", "hybrid", "pallas_hybrid", "dense",
                   "pallas_gemm", "loop")


@functools.lru_cache(maxsize=None)
def _jax_spmm(name: str, impl: str) -> np.ndarray:
    coo, _, _, b, k_pad = case(name)
    return to_np(j_batched_spmm(coo, jnp.asarray(b), impl=impl, k_pad=k_pad,
                                interpret=True))


@pytest.mark.parametrize("name", CASE_NAMES)
@pytest.mark.parametrize("impl", PORT_SPMM_IMPLS)
def test_batched_spmm_matches_reference_oracle(impl, name):
    _, coo, _, b, k_pad = case(name)
    got = ops.batched_spmm(coo, torch.from_numpy(b), impl=impl, k_pad=k_pad)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _jax_spmm(name, "ref"),
                               atol=ATOL, rtol=RTOL, err_msg=f"{impl} {name}")


@pytest.mark.parametrize("name", CASE_NAMES)
@pytest.mark.parametrize("impl", ("pallas_ell", "pallas_csr", "pallas_coo"))
def test_spmm_plain_versions_match_pallas_interpret(impl, name):
    """The CPU leg of each kernel wrapper vs the TPU kernel it replaces."""
    _, coo, _, b, k_pad = case(name)
    got = ops.batched_spmm(coo, torch.from_numpy(b), impl=impl, k_pad=k_pad)
    np.testing.assert_allclose(got.numpy(), _jax_spmm(name, impl),
                               atol=ATOL, rtol=RTOL, err_msg=f"{impl} {name}")


CASE3_IMPLS = ("ref", "ell", "pallas_ell", "csr", "pallas_csr", "pallas_coo",
               "pallas_hybrid", "pallas_gemm", "pallas_csr_i8",
               "pallas_coo_bf16")


@functools.lru_cache(maxsize=None)
def _case3_inputs(name: str):
    """The oracle's uniform or skewed regime at m_pad 2048, where the port's
    plan is paper case 3 at n_b 64 (the reference's VMEM plan is not):
    (coo_jax, coo_torch, b, k_pad, the reference's ref output and grads of
    sum(tanh(C)) in values and b). N(0, 1) values, numpy from a seed."""
    from repro.core import formats as jf
    from repro_torch.core import formats as tf

    rng = np.random.default_rng(11)
    m = 2048
    empty = (np.zeros(0, np.int32),) * 2 + (np.zeros(0, np.float32),)
    if name == "uniform":      # every row the same degree
        lists = []
        for _ in range(2):
            r = np.repeat(np.arange(m, dtype=np.int32), 3)
            lists.append((r, rng.integers(0, m, r.size).astype(np.int32),
                          rng.normal(size=r.size).astype(np.float32)))
    else:                      # heavy rows, a light sample, an empty one
        r = np.repeat(np.arange(0, m, 16, dtype=np.int32), 8)
        lists = [(r, rng.integers(0, m, r.size).astype(np.int32),
                  rng.normal(size=r.size).astype(np.float32)),
                 (np.array([0, 5, m - 1], np.int32),
                  np.array([1, m - 2, 2], np.int32),
                  rng.normal(size=3).astype(np.float32)), empty]
    cj = jf.coo_from_lists(lists, [m] * len(lists))
    b = rng.normal(size=(len(lists), m, 64)).astype(np.float32)
    k_pad = 8

    def loss(values, bb):
        c = j_batched_spmm(cj.__class__(cj.row_ids, cj.col_ids, values,
                                        cj.nnz, cj.n_rows), bb, impl="ref")
        return jnp.tanh(c).sum(), c

    (_, c), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        cj.values, jnp.asarray(b))
    return (cj, torch_coo(cj), b, k_pad, to_np(c),
            tuple(to_np(g) for g in grads))


@pytest.mark.parametrize("name", ("uniform", "skewed"))
def test_case3_batched_spmm_matches_reference(name):
    """At a paper case-3 shape (m_pad 2048, n_b 64) every impl the port
    plans as case 3 there (f32, i8 B, the COO class's f32 accumulator) and
    the plain impls, forward and both gradients, against the reference's
    ``ref`` at f32 TOLS (gradients at 3x, the gradient rule); the
    reduced-precision ones at their policy's TOLS."""
    from repro_torch.autotune import precision_of

    _, coo, b, k_pad, want, (dv_want, db_want) = _case3_inputs(name)
    assert tb.plan_batched_spmm(batch=coo.batch, m_pad=2048,
                                n_b=64).case == 3
    for impl in CASE3_IMPLS:
        atol, rtol = TOLS[precision_of(impl)[1]]
        v = coo.values.clone().requires_grad_()
        bt = torch.from_numpy(b).requires_grad_()
        c = ops.batched_spmm(coo.with_values(v), bt, impl=impl, k_pad=k_pad)
        torch.tanh(c).sum().backward()
        np.testing.assert_allclose(c.detach().numpy(), want, atol=atol,
                                   rtol=rtol, err_msg=f"{impl} {name}")
        for got, g in ((v.grad, dv_want), (bt.grad, db_want)):
            np.testing.assert_allclose(got.numpy(), g, atol=3 * atol,
                                       rtol=3 * rtol,
                                       err_msg=f"{impl} {name} grad")


def _layer_inputs(name: str, channels: int = 2, n_in: int = 12,
                  n_out: int = 40):
    """The oracle's layer regime: channel 0 is the case's COO, the other
    channels slot-permuted copies; numpy weights fed to both packages."""
    coo_j, _, m_pad, _, _ = case(name)
    rng = np.random.default_rng(13)
    adj_j = [coo_j]
    for _ in range(1, channels):
        perm = rng.permutation(coo_j.values.shape[1])
        adj_j.append(coo_j.__class__(
            row_ids=coo_j.row_ids[:, perm], col_ids=coo_j.col_ids[:, perm],
            values=coo_j.values[:, perm], nnz=coo_j.nnz,
            n_rows=coo_j.n_rows))
    x = rng.normal(size=(coo_j.batch, m_pad, n_in)).astype(np.float32)
    w = (rng.normal(size=(channels, n_in, n_out)) / 4).astype(np.float32)
    bias = rng.normal(size=(channels, n_out)).astype(np.float32)
    res = rng.normal(size=(coo_j.batch, m_pad, n_out)).astype(np.float32)
    return adj_j, x, w, bias, res


@pytest.mark.parametrize("name", CASE_NAMES)
@pytest.mark.parametrize("epilogue,residual", [("none", False),
                                               ("relu", True)])
def test_fused_plain_version_matches_pallas_interpret(name, epilogue,
                                                      residual):
    adj_j, x, w, bias, res = _layer_inputs(name)
    from repro.core.graph_conv import stack_channels as j_stack

    rj, cj, vj, nj = j_stack(adj_j)
    want = to_np(j_fused(rj, cj, vj, nj, jnp.asarray(x), jnp.asarray(w),
                         jnp.asarray(bias), epilogue=epilogue,
                         residual=jnp.asarray(res) if residual else None,
                         interpret=True))
    rt, ct, vt, nt = stack_channels([torch_coo(a) for a in adj_j])
    got = fused_graph_conv(rt, ct, vt, nt, torch.from_numpy(x),
                           torch.from_numpy(w), torch.from_numpy(bias),
                           epilogue=epilogue,
                           residual=torch.from_numpy(res) if residual
                           else None)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    assert runtime_chunks(nt).tolist() == to_np(
        (nj + 127) // 128).tolist()


def test_coo_wrapper_masks_sentinel_rows():
    """The m_pad row-id sentinel adds nothing: the JAX scatter drops such
    an update, index_add_ would raise on it."""
    rid = torch.tensor([[0, 4, 1, 4]], dtype=torch.int32)   # 4 == m_pad
    cid = torch.tensor([[1, 0, 2, 3]], dtype=torch.int32)
    val = torch.tensor([[2.0, 5.0, 3.0, 7.0]])
    b = torch.arange(16, dtype=torch.float32).reshape(1, 4, 4)
    got = batched_spmm_coo(rid, cid, val, b)
    want = torch.zeros(1, 4, 4)
    want[0, 0] = 2.0 * b[0, 1]
    want[0, 1] = 3.0 * b[0, 2]
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _meta_like(*ts):
    return [t.to("meta") for t in ts]


def test_non_cpu_tensors_never_fall_back(monkeypatch):
    """A tensor off the CPU launches the kernel or raises: here (no card)
    a meta tensor must raise, and the plain versions must not run."""
    def boom(*a, **k):
        raise AssertionError("fell back to the plain version")

    for fn in ("batched_spmm_ell_plain", "batched_spmm_coo_plain",
               "fused_graph_conv_plain"):
        monkeypatch.setattr(ref, fn, boom)
    _, coo, m_pad, b, _ = case("uniform")
    bt = torch.from_numpy(b)
    ell = torch.zeros((coo.batch, m_pad, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        batched_spmm_ell(*_meta_like(ell, ell.float(), bt))
    with pytest.raises(ValueError, match="CUDA"):
        batched_spmm_coo(*_meta_like(coo.row_ids, coo.col_ids, coo.values,
                                     bt))
    with pytest.raises(ValueError, match="CUDA"):   # mixed devices
        batched_spmm_coo(coo.row_ids, coo.col_ids, coo.values,
                         bt.to("meta"))
    ids = coo.row_ids[:, None]
    with pytest.raises(ValueError, match="CUDA"):
        fused_forward(*_meta_like(
            ids, coo.col_ids[:, None], coo.values[:, None],
            coo.nnz[:, None], bt, torch.zeros(1, 48, 8), torch.zeros(1, 8)))


def _spy_on(monkeypatch, module, names):
    """Replace ``module.<name>`` for each name by a wrapper that records the
    name, then calls the original; returns the record."""
    reached = []
    for name in names:
        def spy(*a, _real=getattr(module, name), _name=name, **k):
            reached.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(module, name, spy)
    return reached


def test_case3_kernel_impls_raise_off_the_cpu(monkeypatch):
    """Planner case 3 (m_pad too large for one 32-lane panel): on the CPU
    every impl takes the reference's plain per-sample path, bit for bit;
    off the CPU a kernel impl reaches its kernel's large-matrix entry, whose
    device check raises here (no card), and never that plain path."""
    m_pad = 2000
    rows = np.array([0, 1999, 7], np.int32)
    coo = coo_from_lists([(rows, rows[::-1].copy(),
                           np.array([1.0, 2.0, 3.0], np.float32))], [m_pad])
    b = torch.randn((1, m_pad, 32),
                    generator=torch.Generator().manual_seed(0))
    assert tb.plan_batched_spmm(batch=1, m_pad=m_pad, n_b=32).case == 3
    want = ref.batched_spmm_coo_ref(coo, b, m_pad)
    for impl in ("pallas_coo", "pallas_ell", "ell"):
        torch.testing.assert_close(
            ops.batched_spmm(coo, b, impl=impl, k_pad=1), want,
            rtol=0, atol=0)
    want_g = ref.batched_gspmm_ref(coo, b, m_pad, op="copy_lhs",
                                   reduce="mean")
    for impl in ("pallas_coo", "pallas_ell", "pallas_csr"):
        torch.testing.assert_close(
            ops.batched_gspmm(coo, b, op="copy_lhs", reduce="mean",
                              impl=impl, k_pad=1), want_g, rtol=0, atol=0)

    def boom(*a, **k):
        raise AssertionError("fell back to the plain per-sample path")

    for fn in ("batched_spmm_coo_ref", "batched_spmm_csr_ref",
               "batched_gspmm_ref"):
        monkeypatch.setattr(ref, fn, boom)
    # the ELL guard reads the row degrees, which meta tensors do not hold
    monkeypatch.setattr(ops, "validate_ell_k_pad", lambda *a: None)
    entries = {"pallas_coo": "batched_spmm_coo_large",
               "pallas_ell": "batched_spmm_ell_large",
               "pallas_csr": "batched_spmm_csr_large"}
    reached = _spy_on(monkeypatch, ops, entries.values())
    mc, mb = coo.to("meta"), b.to("meta")
    for impl, entry in entries.items():
        for gspmm in (False, True):
            reached.clear()
            with pytest.raises(ValueError, match="CUDA"):
                if gspmm:
                    ops.batched_gspmm(mc, mb, op="copy_lhs", reduce="mean",
                                      impl=impl, k_pad=1)
                else:
                    ops.batched_spmm(mc, mb, impl=impl, k_pad=1)
            assert reached == [entry], (impl, gspmm, reached)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def test_failed_kernel_build_raises_with_compiler_output(monkeypatch,
                                                         tmp_path):
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'error: no such intrinsic'\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        _build.build()
    assert not list((tmp_path / "kernels").glob("*.so"))


def test_launch_counters_and_sources_present():
    for fn in (batched_spmm_ell, batched_spmm_coo, batched_spmm_csr,
               batched_spmm_hybrid, batched_gemm, fused_forward,
               fused_hybrid_forward, _gmm, flash_attention):
        assert isinstance(fn.launches, int)
    assert len(_build.SOURCES) == 8
    for name in _build.SOURCES:
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert "Replaces the TPU kernel src/repro/kernels/" in src
        assert f"extern \"C\" int {name}_f32(" in src
    # CPU tensors run the plain versions: the counters do not move
    before = batched_spmm_coo.launches
    _, coo, _, b, _ = case("uniform")
    ops.batched_spmm(coo, torch.from_numpy(b), impl="pallas_coo")
    assert batched_spmm_coo.launches == before


def test_wrappers_reject_what_the_kernels_do_not_take():
    _, coo, m_pad, b, k_pad = case("uniform")
    bt = torch.from_numpy(b)
    with pytest.raises(TypeError, match="dtype"):
        batched_spmm_coo(coo.row_ids.long(), coo.col_ids, coo.values, bt)
    with pytest.raises(ValueError, match="contiguous"):
        batched_spmm_coo(coo.row_ids, coo.col_ids, coo.values,
                         bt.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="shape"):
        batched_spmm_ell(torch.zeros((coo.batch, m_pad, 2), dtype=torch.int32),
                         torch.zeros((coo.batch, m_pad, 3)), bt)
    with pytest.raises(ValueError, match="epilogue"):
        fused_forward(*(None,) * 7, epilogue="gelu")


def test_dispatch_raises_for_unported_paths():
    _, coo, _, b, k_pad = case("uniform")
    bt = torch.from_numpy(b)
    with pytest.raises(ValueError, match="Autotune"):
        ops.batched_spmm(coo, bt, impl="auto")
    # the precision variants are ported: the SpMM ones run (in B's dtype,
    # within TOLS["bf16"] of ref), the layer ones only as layers
    for impl in ("pallas_hybrid_bf16", "pallas_ell_bf16"):
        got = ops.batched_spmm(coo, bt, impl=impl, k_pad=k_pad)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), _jax_spmm("uniform", "ref"),
                                   atol=TOLS["bf16"][0], rtol=TOLS["bf16"][1])
    with pytest.raises(ValueError, match="unknown impl"):
        ops.batched_spmm(coo, bt, impl="pallas_gemm_bf16")
    for impl in ("fused", "fused_bf16"):
        with pytest.raises(ValueError, match="graph_conv_batched"):
            ops.batched_spmm(coo, bt, impl=impl)
    with pytest.raises(ValueError, match="k_pad"):
        ops.batched_spmm(coo, bt, impl="pallas_ell")
    with pytest.raises(ValueError, match="max row degree"):
        ops.batched_spmm(coo, bt, impl="pallas_ell", k_pad=k_pad - 1)
    with pytest.raises(ValueError, match="g-SpMM"):
        ops.batched_gspmm(coo, bt, op="add", reduce="sum", impl="pallas_gemm")
    with pytest.raises(ValueError, match="batched_gspmm"):
        ops.batched_spmm(coo.with_values(coo.values[..., None]), bt,
                         impl="ref")
    # every impl takes gradients: a kernel impl's match impl="ref"'s
    grads = {}
    for impl in ("pallas_coo", "ref"):
        g = bt.clone().requires_grad_()
        ops.batched_spmm(coo, g, impl=impl).sum().backward()
        assert g.grad is not None and torch.isfinite(g.grad).all()
        grads[impl] = g.grad
    torch.testing.assert_close(grads["pallas_coo"], grads["ref"], atol=ATOL,
                               rtol=RTOL)


def test_jax_stays_on_cpu():
    assert jax.default_backend() == "cpu"
