"""Port parity: the gemmBatched baseline (``plan_batched_gemm``,
``batched_gemm``, ``dense_batched_matmul`` and the ``pallas_gemm`` SpMM
impl) against the JAX reference on the CPU.

Inputs are made with numpy from a seed and fed to both packages; the
reference's Pallas GEMM runs in interpret mode. Products at ``TOLS["f32"]``
of ``tests/oracle.py``, gradients at 3x it. On the CPU the GEMM wrapper
runs its plain version.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import TOLS
from repro.core import batching as jb
from repro.core.spmm import batched_spmm as j_batched_spmm
from repro.kernels.batched_gemm import batched_gemm as j_gemm
from repro.kernels.ops import dense_batched_matmul as j_dbm
from repro_torch.core import batching as tb
from repro_torch.core import formats as tf
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import batched_gemm as gemm_mod
from repro_torch.kernels.batched_gemm import batched_gemm, batched_gemm_large
from test_torch_formats import CASE_NAMES, to_np
from test_torch_hybrid import (
    _case,
    _jax_spmm,
    _mixed_batch,
    _port_fwd_grads,
    check_gcn_loss_and_grads,
    trainer_curve,
)

ATOL, RTOL = TOLS["f32"]
SHAPES = [(3, 24, 24, 16), (2, 16, 40, 70), (4, 56, 56, 64), (1, 8, 5, 3)]


def _operands(batch, m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(batch, m, k)).astype(np.float32),
            rng.normal(size=(batch, k, n)).astype(np.float32))


@pytest.mark.parametrize("batch,m,n,k", [
    (512, 56, 64, 56), (512, 56, 512, 56), (3, 24, 16, 24), (2, 16, 200, 40),
    (2, 200, 64, 200), (4, 50, 33, 50)])
def test_plan_batched_gemm_matches_reference_and_fits(batch, m, n, k):
    """batch and n_b are the reference's, and m_pad too where the reference
    does not round it up; the panel is the Hopper planner's: the A tile and
    one B panel fit a block's shared memory, 32-lane multiples up to 128
    columns."""
    want = jb.plan_batched_gemm(batch=batch, m=m, n=n, k=k)
    got = tb.plan_batched_gemm(batch=batch, m=m, n=n, k=k)
    assert (got.batch, got.n_b) == (want.batch, want.n_b)
    if m % 8 == 0:
        assert got.m_pad == want.m_pad
    assert got.case in (1, 2) and got.n_block * got.p >= n
    assert got.n_block <= tb.PANEL_MAX
    assert got.smem_bytes == (m * k + k * got.n_block) * 4 <= tb.SMEM_BYTES
    assert (got.case == 1) == (got.p == 1)


def test_plan_batched_gemm_case3_when_the_a_tile_does_not_fit():
    assert tb.plan_batched_gemm(batch=1, m=200, n=64, k=200).case == 1
    assert tb.plan_batched_gemm(batch=1, m=300, n=64, k=300).case == 3


@pytest.mark.parametrize("batch,m,n", [
    (512, 56, 64), (512, 56, 512), (200, 56, 64), (2, 9000, 64),
    (8, 2048, 64), (7, 24, 300), (3, 200, 33), (2, 5, 1), (1, 33_792, 64),
    (150, 129, 70), (4, 128, 64)])
def test_gemm_tile_spreads_the_rows_over_the_card(batch, m, n):
    """The kernel's row tile: up to 128 rows one tile of row groups of 4
    (up to 64 rows) or 8 rows a thread, with fewer spare rows than a group
    holds (none at m 56); past it, no other tile leaves fewer rows on the
    busiest of 132 SMs, so 2 x 9000 is one wave of 126 tiles and 8 x 2048
    one of 128; every grid fits 65535 row tiles."""
    tm, groups = gemm_mod.gemm_tile(batch, m, n, 132)
    assert tm in gemm_mod.TILE_THREAD_ROWS
    assert 1 <= groups <= gemm_mod.MAX_ROW_GROUPS
    bm = tm * groups

    def busiest(bm_):
        return -(-batch * -(-m // bm_) * -(-n // gemm_mod.PANEL) // 132) * bm_

    if m <= 128:
        assert tm == (4 if m <= 64 else 8) and 0 <= bm - m < tm
    else:
        assert busiest(bm) == min(busiest(t * g) for t in (8, 9)
                                  for g in (8, 16))
    assert -(-m // bm) <= 65535
    if (batch, m) in ((2, 9000), (8, 2048)):
        assert batch * -(-m // bm) <= 132
    if m == 56:
        assert bm == 56


@pytest.mark.parametrize("batch,m,k,n", SHAPES)
def test_batched_gemm_plain_matches_reference_pallas_interpret(batch, m, k,
                                                               n):
    a, b = _operands(batch, m, k, n)
    plan = jb.plan_batched_gemm(batch=batch, m=m, n=n, k=k)
    want = to_np(j_gemm(jnp.asarray(a), jnp.asarray(b), plan=plan,
                        interpret=True))
    got = batched_gemm(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(
        ref.batched_gemm_plain(torch.from_numpy(a),
                               torch.from_numpy(b)).numpy(),
        ref.batched_gemm_ref(torch.from_numpy(a),
                             torch.from_numpy(b)).numpy(),
        atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("batch,m,k,n", SHAPES[:2])
def test_dense_batched_matmul_matches_reference(batch, m, k, n):
    a, b = _operands(batch, m, k, n, seed=1)
    want = to_np(j_dbm(jnp.asarray(a), jnp.asarray(b), interpret=True))
    got = ops.dense_batched_matmul(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", CASE_NAMES + ("powerlaw",))
def test_pallas_gemm_spmm_matches_reference(name):
    """Forward, dValues and dB of ``pallas_gemm`` (densify + the GEMM
    kernel; dB through the COO kernel) against the reference's
    ``pallas_gemm`` (Pallas interpret)."""
    _, coo_t, _, b = _case(name)
    (want_c, want_dv, want_db), t = _jax_spmm(name, "pallas_gemm")
    got_c, got_dv, got_db = _port_fwd_grads(coo_t, b, "pallas_gemm", t)
    np.testing.assert_allclose(got_c, want_c, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_dv, want_dv, atol=3 * ATOL,
                               rtol=3 * RTOL)
    np.testing.assert_allclose(got_db, want_db, atol=3 * ATOL,
                               rtol=3 * RTOL)


@pytest.mark.parametrize("impl", ("pallas_gemm", "dense"))
def test_gemm_impls_match_reference_dense(impl):
    """Both gemmBatched impls against the reference's ``dense`` on the
    mixed batch (empty sample, single long row)."""
    from repro.core.formats import coo_from_lists as j_from_lists

    coo, m_pad, b = _mixed_batch()
    tri = []
    for s in range(coo.batch):
        k = int(coo.nnz[s])
        tri.append((coo.row_ids[s, :k].numpy(), coo.col_ids[s, :k].numpy(),
                    coo.values[s, :k].numpy()))
    coo_j = j_from_lists(tri, [m_pad] * coo.batch, nnz_pad=coo.nnz_pad)
    want = to_np(j_batched_spmm(coo_j, jnp.asarray(b), impl="dense"))
    got = ops.batched_spmm(coo, torch.from_numpy(b), impl=impl)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_tox21_logits_match_reference_pallas_gemm():
    from test_torch_gcn import _jax_logits, _port_logits

    np.testing.assert_allclose(_port_logits("tox21", "sample", "pallas_gemm"),
                               _jax_logits("tox21", "sample", "pallas_gemm"),
                               atol=1e-4)


def test_gcn_loss_and_grads_match_reference():
    check_gcn_loss_and_grads("pallas_gemm")


def test_trainer_steps_track_reference_curve(tmp_path):
    got, want = trainer_curve("pallas_gemm", tmp_path, steps=5)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_gemm_wrapper_never_falls_back_off_the_cpu(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(ref, "batched_gemm_plain", boom)
    a, b = _operands(2, 16, 16, 8)
    with pytest.raises(ValueError, match="CUDA"):
        batched_gemm(torch.from_numpy(a).to("meta"),
                     torch.from_numpy(b).to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        batched_gemm(torch.from_numpy(a), torch.from_numpy(b).to("meta"))


def test_gemm_wrapper_rejects_what_the_kernel_does_not_take():
    a, b = _operands(2, 16, 16, 8)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    with pytest.raises(TypeError, match="dtype"):
        batched_gemm(at.double(), bt)
    with pytest.raises(ValueError, match="contiguous"):
        batched_gemm(at.transpose(1, 2), bt)
    with pytest.raises(ValueError, match="shape"):
        batched_gemm(at, bt[:, :8].contiguous())
    with pytest.raises(ValueError, match="case 3"):
        batched_gemm(at, bt, plan=dataclasses.replace(
            tb.plan_batched_gemm(batch=2, m=16, n=8, k=16), case=3))


def test_pallas_gemm_case3_raises_off_the_cpu(monkeypatch):
    """m_pad whose A tile does not fit a block: the plain product on the
    CPU (``pallas_gemm`` and ``dense_batched_matmul``, which the reference
    runs at every size), and for tensors off the CPU the K-tiled large
    entry, whose device check raises here (no card), never the plain
    product."""
    m_pad = 300
    rows = np.array([0, 299, 7], np.int32)
    coo = tf.coo_from_lists([(rows, rows[::-1].copy(),
                              np.array([1.0, 2.0, 3.0], np.float32))],
                            [m_pad])
    b = torch.randn((1, m_pad, 16), generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(ops.batched_spmm(coo, b, impl="pallas_gemm"),
                               ops.batched_spmm(coo, b, impl="ref"),
                               atol=ATOL, rtol=RTOL)
    a = tf.coo_to_dense(coo, m_pad)
    torch.testing.assert_close(ops.dense_batched_matmul(a, b),
                               ref.batched_gemm_plain(a, b), rtol=0, atol=0)

    def boom(*a, **k):
        raise AssertionError("fell back to the plain product")

    monkeypatch.setattr(ref, "batched_gemm_plain", boom)
    reached = []

    def spy(*a, **k):
        reached.append(1)
        return batched_gemm_large(*a, **k)

    monkeypatch.setattr(ops, "batched_gemm_large", spy)
    with pytest.raises(ValueError, match="CUDA"):
        ops.batched_spmm(coo.to("meta"), b.to("meta"), impl="pallas_gemm")
    with pytest.raises(ValueError, match="CUDA"):
        ops.dense_batched_matmul(a.to("meta"), b.to("meta"))
    assert reached == [1, 1]


def test_gemm_launch_counter_and_source_present():
    assert isinstance(batched_gemm.launches, int)
    assert "batched_gemm" in _build.SOURCES
    src = (_build.CSRC / "batched_gemm.cu").read_text()
    assert "Replaces the TPU kernel src/repro/kernels/batched_gemm.py" in src
    before = batched_gemm.launches
    a, b = _operands(2, 16, 16, 8)
    batched_gemm(torch.from_numpy(a), torch.from_numpy(b))
    assert batched_gemm.launches == before
