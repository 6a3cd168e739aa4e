"""Port parity: batched formats and the planner (repro_torch.core) against
the JAX reference, on the oracle's three regimes. Conversions are bitwise.

The converters at the top are shared by the other ``test_torch_*`` files:
numpy is the only thing that crosses between the two packages.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from oracle import spmm_cases
from repro.core import formats as jf
from repro_torch.core import batching as tb
from repro_torch.core import formats as tf

CASE_NAMES = ("uniform", "skewed", "zero_nnz")

# jitted: one compile per shape instead of one per eager op
_j_row_degrees = jax.jit(jf.row_degrees, static_argnums=1)
_j_coo_to_ell = jax.jit(jf.coo_to_ell, static_argnums=(1, 2))
_j_coo_to_dense = jax.jit(jf.coo_to_dense, static_argnums=1)


def to_np(a) -> np.ndarray:
    return np.array(a)          # a writable copy


def torch_coo(coo) -> tf.BatchedCOO:
    """The reference's BatchedCOO as the port's (CPU tensors)."""
    return tf.BatchedCOO(*(torch.from_numpy(to_np(getattr(coo, f.name)))
                           for f in dataclasses.fields(jf.BatchedCOO)))


@functools.lru_cache(maxsize=None)
def _spmm_cases():
    return spmm_cases()


def case(name):
    """(coo_jax, coo_torch, m_pad, b_np, k_pad) of one oracle regime."""
    for n, coo, m_pad, b, k_pad in _spmm_cases():
        if n == name:
            return coo, torch_coo(coo), m_pad, to_np(b), k_pad
    raise KeyError(name)


def test_random_batch_and_coo_from_lists_bitwise():
    cj, mj = jf.random_batch(np.random.default_rng(3), batch=5, dim=(6, 20),
                             nnz_per_row=(1, 4))
    ct, mt = tf.random_batch(np.random.default_rng(3), batch=5, dim=(6, 20),
                             nnz_per_row=(1, 4))
    assert mj == mt
    for f in dataclasses.fields(jf.BatchedCOO):
        np.testing.assert_array_equal(getattr(ct, f.name).numpy(),
                                      to_np(getattr(cj, f.name)), f.name)
        assert getattr(ct, f.name).dtype == {
            "values": torch.float32}.get(f.name, torch.int32)


@pytest.mark.parametrize("name", CASE_NAMES)
def test_conversions_bitwise(name):
    cj, ct, m_pad, _, k_pad = case(name)
    deg = to_np(_j_row_degrees(cj, m_pad))
    np.testing.assert_array_equal(tf.row_degrees(ct, m_pad).numpy(), deg)
    np.testing.assert_array_equal(tf.max_row_degree(ct, m_pad).numpy(),
                                  deg.max(axis=1))
    for kp in (k_pad, k_pad + 3):
        ej, et = _j_coo_to_ell(cj, m_pad, kp), tf.coo_to_ell(ct, m_pad, kp)
        np.testing.assert_array_equal(et.col_ids.numpy(), to_np(ej.col_ids))
        np.testing.assert_array_equal(et.values.numpy(), to_np(ej.values))
        assert et.col_ids.dtype == torch.int32
    np.testing.assert_allclose(tf.coo_to_dense(ct, m_pad).numpy(),
                               to_np(_j_coo_to_dense(cj, m_pad)),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", CASE_NAMES)
def test_validate_ell_k_pad_raises_where_reference_raises(name):
    cj, ct, m_pad, _, k_pad = case(name)
    for kp in (k_pad - 1, k_pad):
        try:
            jf.validate_ell_k_pad(cj, m_pad, kp)
            want = None
        except ValueError:
            want = ValueError
        if want is None:
            tf.validate_ell_k_pad(ct, m_pad, kp)
        else:
            with pytest.raises(ValueError, match="max row degree"):
                tf.validate_ell_k_pad(ct, m_pad, kp)


def test_coo_to_ell_drops_overflow_like_reference():
    """Below the true max degree both conversions drop the same slots."""
    cj, ct, m_pad, _, k_pad = case("skewed")
    ej, et = _j_coo_to_ell(cj, m_pad, 2), tf.coo_to_ell(ct, m_pad, 2)
    np.testing.assert_array_equal(et.values.numpy(), to_np(ej.values))
    np.testing.assert_array_equal(et.col_ids.numpy(), to_np(ej.col_ids))


@pytest.mark.parametrize("m_pad,n_b,case_,n_block", [
    (56, 64, 1, 64),        # Tox21 stacked SpMM: one panel
    (56, 512, 2, 128),      # wide: panels of at most PANEL_MAX columns
    (24, 20, 1, 20),        # narrower than a warp: the panel is n_b
    (2000, 64, 3, 64),      # one warp-wide panel no longer fits smem
    (9000, 8, 3, 8),        # paper case 3 (> LARGE_M)
])
def test_plan_batched_spmm_cases(m_pad, n_b, case_, n_block):
    plan = tb.plan_batched_spmm(batch=4, m_pad=m_pad, n_b=n_b)
    assert (plan.case, plan.n_block) == (case_, n_block)
    if case_ != 3:
        assert plan.p == -(-n_b // n_block)
        assert plan.smem_bytes == m_pad * n_block * 4 <= tb.SMEM_BYTES


def test_plan_fused_graph_conv_hopper_smem():
    # smem_bytes: the ring (stages of a 64 x 32 X tile, rows padded to 36
    # f32, and a 32 x tile-width W tile), U_ch (m_pad rounded up to 32
    # rows) and the accumulator (m_pad rows), tile-width columns of f32;
    # the 128 Tox21 samples fill the 132 SMs at two 32-column panels
    tox = tb.plan_fused_graph_conv(batch=128, m_pad=56, n_in=62, n_out=64)
    assert (tox.case, tox.n_block, tox.p, tox.large) == (2, 32, 2, False)
    assert tox.smem_bytes == 3 * (64 * 36 + 32 * 32) * 4 + (64 + 56) * 32 * 4
    r100 = tb.plan_fused_graph_conv(batch=128, m_pad=56, n_in=512,
                                    n_out=512)
    assert (r100.case, r100.n_block, r100.p, r100.large) == (2, 128, 4, False)
    # row tiles of 56 rows at 128 columns in f32 (m_pad 56)
    assert r100.smem_bytes == (2 * (56 * 36 + 32 * 128) * 4
                               + (64 + 56) * 128 * 4)             # 108 KB
    assert 2 * (r100.smem_bytes + 1024) <= 233_472     # two blocks an SM
    # the reference's case at m_pad 1024 (not 3): the panels leave shared
    # memory for a global scratch, which holds the ring alone
    big = tb.plan_fused_graph_conv(batch=1, m_pad=1024, n_in=512, n_out=64)
    assert (big.case, big.large, big.n_block) == (2, True, 16)
    assert big.smem_bytes == 3 * (64 * 36 + 32 * 16) * 4
    assert tb.plan_fused_graph_conv(batch=1, m_pad=8193, n_in=4,
                                    n_out=4).case == 3


def test_chunk_counts_and_sub_warp_match_reference():
    from repro.core.batching import chunk_counts

    rows = [[0, 1, 128, 129], 300, 0]
    assert tb.chunk_counts(rows) == chunk_counts(rows)
    assert [tb.sub_warp(n) for n in (1, 3, 16, 20, 64, 512)] == \
        [1, 4, 16, 32, 32, 32]
