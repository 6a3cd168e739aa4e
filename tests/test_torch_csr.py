"""Port parity: the CSR format and the row-split CSR kernel's plain version
against the JAX reference on the oracle's three regimes.

``coo_to_csr`` and ``csr_transpose`` are bitwise equal to the reference's;
the CSR products agree at the f32 tolerance of ``tests/oracle.py`` (1e-4
abs, 1e-5 rel). The CUDA kernel itself is held against the plain version
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import TOLS
from repro.core import formats as jf
from repro.core.batching import plan_batched_spmm as j_plan
from repro.kernels import ref as j_ref
from repro.kernels.batched_spmm_csr import batched_spmm_csr as j_csr_kernel
from repro_torch.core import formats as tf
from repro_torch.kernels import ref
from repro_torch.kernels.batched_spmm_csr import batched_spmm_csr
from test_torch_formats import CASE_NAMES, case, to_np, torch_coo

ATOL, RTOL = TOLS["f32"]
_j_coo_to_csr = jax.jit(jf.coo_to_csr, static_argnums=1)
_j_csr_transpose = jax.jit(jf.csr_transpose, static_argnums=1)


def _assert_csr_equal(got: tf.BatchedCSR, want: jf.BatchedCSR, what: str):
    for f in ("rpt", "col_ids", "values", "n_rows"):
        g = getattr(got, f)
        np.testing.assert_array_equal(g.numpy(), to_np(getattr(want, f)),
                                      err_msg=f"{what}: {f}")
        assert g.dtype == (torch.float32 if f == "values" else torch.int32)
    assert got.m_pad == want.m_pad and got.nnz_pad == want.nnz_pad
    np.testing.assert_array_equal(got.nnz.numpy(), to_np(want.nnz))


@pytest.mark.parametrize("name", CASE_NAMES)
def test_coo_to_csr_bitwise(name):
    cj, ct, m_pad, _, _ = case(name)
    _assert_csr_equal(tf.coo_to_csr(ct, m_pad), _j_coo_to_csr(cj, m_pad),
                      f"coo_to_csr {name}")


@pytest.mark.parametrize("name", CASE_NAMES)
@pytest.mark.parametrize("n_cols", (None, "wider"))
def test_csr_transpose_bitwise(name, n_cols):
    cj, ct, m_pad, _, _ = case(name)
    n = None if n_cols is None else m_pad + 8
    _assert_csr_equal(tf.csr_transpose(tf.coo_to_csr(ct, m_pad), n),
                      _j_csr_transpose(_j_coo_to_csr(cj, m_pad), n),
                      f"csr_transpose {name}")


def test_coo_to_csr_honours_the_nnz_prefix():
    """Slots at or past nnz are dropped even when they carry non-zero
    values and ids (the CSR class's padding contract), bitwise as in the
    reference; the products of both packages agree."""
    cj, _, m_pad, b, _ = case("skewed")
    rng = np.random.default_rng(5)
    junk = dict(
        row_ids=np.where(np.arange(cj.nnz_pad) < to_np(cj.nnz)[:, None],
                         to_np(cj.row_ids),
                         rng.integers(0, m_pad, cj.row_ids.shape)),
        values=np.where(np.arange(cj.nnz_pad) < to_np(cj.nnz)[:, None],
                        to_np(cj.values), 7.0).astype(np.float32))
    cj = dataclasses.replace(cj, **{k: jnp.asarray(v, getattr(cj, k).dtype)
                                    for k, v in junk.items()})
    ct = torch_coo(cj)
    csr_t, csr_j = tf.coo_to_csr(ct, m_pad), _j_coo_to_csr(cj, m_pad)
    _assert_csr_equal(csr_t, csr_j, "junk past nnz")
    assert (csr_t.values[:, :csr_t.nnz.min()] != 7.0).all()
    got = ref.batched_spmm_csr_ref(csr_t, torch.from_numpy(b))
    np.testing.assert_allclose(
        got.numpy(), to_np(j_ref.batched_spmm_csr_ref(csr_j, jnp.asarray(b))),
        atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", CASE_NAMES)
def test_csr_plain_version_matches_pallas_interpret(name):
    """The CPU leg of the CSR kernel wrapper vs the TPU kernel it replaces,
    on the same CSR arrays."""
    cj, ct, m_pad, b, _ = case(name)
    csr_j = _j_coo_to_csr(cj, m_pad)
    want = to_np(j_csr_kernel(
        csr_j.rpt, csr_j.col_ids, csr_j.values, jnp.asarray(b),
        plan=j_plan(batch=cj.batch, m_pad=m_pad, n_b=b.shape[-1],
                    slots=cj.nnz_pad, itemsize=4), interpret=True))
    csr_t = tf.coo_to_csr(ct, m_pad)
    got = batched_spmm_csr(csr_t.rpt, csr_t.col_ids, csr_t.values,
                           torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(
        ref.batched_spmm_csr_ref(csr_t, torch.from_numpy(b)).numpy(),
        to_np(j_ref.batched_spmm_csr_ref(csr_j, jnp.asarray(b))),
        atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", CASE_NAMES)
def test_transpose_product_is_the_dense_transpose(name):
    """(Aᵀ)·B through the transposed CSR equals densify(A)ᵀ·B, and the
    transpose of the transpose is the original CSR."""
    _, ct, m_pad, b, _ = case(name)
    csr = tf.coo_to_csr(ct, m_pad)
    at = tf.csr_transpose(csr)
    bt = torch.from_numpy(b)
    want = torch.bmm(tf.coo_to_dense(ct, m_pad).transpose(1, 2), bt)
    torch.testing.assert_close(
        batched_spmm_csr(at.rpt, at.col_ids, at.values, bt), want,
        atol=ATOL, rtol=RTOL)
    # the round trip keeps every row's slots, sorted by column within it:
    # the sums change order, so they agree to the f32 tolerance
    back = tf.csr_transpose(at)
    assert torch.equal(back.rpt, csr.rpt)
    torch.testing.assert_close(
        batched_spmm_csr(back.rpt, back.col_ids, back.values, bt),
        batched_spmm_csr(csr.rpt, csr.col_ids, csr.values, bt),
        atol=ATOL, rtol=RTOL)


def test_flatten_channels_hands_csr_the_reference_nnz():
    """The stacked form's CSR conversion sees each (channel, sample)'s own
    nnz, channel-major, exactly as the reference's flatten_channels."""
    from repro.core.graph_conv import flatten_channels as j_flatten
    from repro_torch.core.graph_conv import flatten_channels
    from test_torch_kernels import _layer_inputs

    adj_j = _layer_inputs("skewed", channels=3)[0]
    adj_j[2] = dataclasses.replace(adj_j[2], nnz=adj_j[2].nnz // 2)
    fj = j_flatten(adj_j)
    ft = flatten_channels([torch_coo(a) for a in adj_j])
    for f in ("row_ids", "col_ids", "values", "nnz", "n_rows"):
        np.testing.assert_array_equal(getattr(ft, f).numpy(),
                                      to_np(getattr(fj, f)), err_msg=f)
    m_pad = case("skewed")[2]
    _assert_csr_equal(tf.coo_to_csr(ft, m_pad), _j_coo_to_csr(fj, m_pad),
                      "flattened channels")


def test_csr_wrapper_checks_operands_and_never_falls_back(monkeypatch):
    _, ct, m_pad, b, _ = case("uniform")
    csr = tf.coo_to_csr(ct, m_pad)
    bt = torch.from_numpy(b)
    with pytest.raises(ValueError, match="shape"):
        batched_spmm_csr(csr.rpt[:, :-1], csr.col_ids, csr.values, bt)
    with pytest.raises(TypeError, match="dtype"):
        batched_spmm_csr(csr.rpt.long(), csr.col_ids, csr.values, bt)
    with pytest.raises(ValueError, match="contiguous"):
        batched_spmm_csr(csr.rpt, csr.col_ids, csr.values,
                         bt.transpose(1, 2).contiguous().transpose(1, 2))

    def boom(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(ref, "batched_spmm_csr_plain", boom)
    with pytest.raises(ValueError, match="CUDA"):
        batched_spmm_csr(*(t.to("meta") for t in (csr.rpt, csr.col_ids,
                                                  csr.values, bt)))
    assert batched_spmm_csr.launches == 0
