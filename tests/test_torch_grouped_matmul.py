"""Port parity: the ragged grouped matmul (``kernels/grouped_matmul``)
against the JAX reference on the CPU, its ``_gmm`` Pallas kernel in
interpret mode: the forward, ``dx`` and ``dw`` of its custom VJP, with and
without row tiles that straddle a group boundary, and rows past the sum of
the group sizes; and the reference's ``max_groups_per_tile`` contract: a
row tile visits at most that many groups and leaves the rows of further
groups 0, in both packages. Tolerance: ``tests/oracle.py`` f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import TOLS
from repro.kernels import grouped_matmul as jgmm
from repro_torch.kernels import grouped_matmul as tgmm
from repro_torch.kernels import ref

ATOL, RTOL = TOLS["f32"]

# (sizes, M, K, N, the reference's row tile): straddling tiles, aligned
# tiles, rows past sum(sizes) (group E - 1), and R-GCN's equal relation
# groups (4 relations x 2 graphs x 8 rows)
CASES = {
    "straddle": ([7, 9, 4], 20, 6, 5, 8),
    "aligned": ([16, 8, 8], 32, 12, 7, 8),
    "short_sizes": ([5, 5], 14, 4, 3, 8),
    "rgcn": ([16] * 4, 64, 10, 8, 16),
}


def _inputs(name):
    sizes, m, k, n, tm = CASES[name]
    rng = np.random.default_rng(len(name))
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(len(sizes), k, n)).astype(np.float32)
    g = rng.normal(size=(m, n)).astype(np.float32)
    return np.asarray(sizes, np.int32), x, w, g, tm


@pytest.mark.parametrize("name", sorted(CASES))
def test_grouped_matmul_forward_and_vjp_match_reference(name):
    sizes, x, w, g, tm = _inputs(name)
    out_j, vjp = jax.vjp(lambda a, b: jgmm.grouped_matmul(
        a, b, jnp.asarray(sizes), tm=tm, tn=8, interpret=True),
        jnp.asarray(x), jnp.asarray(w))
    dx_j, dw_j = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = tgmm.grouped_matmul(xt, wt, torch.from_numpy(sizes), tm=tm)
    out.backward(torch.from_numpy(g))
    for what, got, want in (("forward", out.detach(), out_j),
                            ("dx", xt.grad, dx_j), ("dw", wt.grad, dw_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=RTOL, err_msg=f"{name} {what}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_row_groups_and_sort_by_group_match_reference(name):
    sizes, x, _, _, _ = _inputs(name)
    m, e = x.shape[0], len(sizes)
    want = np.asarray(jgmm._row_groups(jnp.asarray(sizes), m, e))
    got = tgmm._row_groups(torch.from_numpy(sizes), m, e)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    eids = np.random.default_rng(1).integers(0, e, 3 * m).astype(np.int32)
    order_j, sizes_j = jgmm.sort_by_group(jnp.asarray(eids), e)
    order_t, sizes_t = tgmm.sort_by_group(torch.from_numpy(eids), e)
    np.testing.assert_array_equal(order_t.numpy(), np.asarray(order_j))
    np.testing.assert_array_equal(sizes_t.numpy(), np.asarray(sizes_j))


@pytest.mark.parametrize("sizes,crosses_more_than_4", [
    ([2] * 8, True),                # 8 groups in one 16-row tile
    ([4, 4, 4, 4], False),          # 4 groups: the reference visits all
])
def test_max_groups_per_tile_departure(sizes, crosses_more_than_4):
    """Both packages visit groups first..first+3 of a 16-row tile and leave
    the rows of later groups 0, in the forward and in dx; dw is the
    unmasked one-hot einsum in both. Where no tile holds more than 4 groups
    every row is the dense product."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(16, 5)).astype(np.float32)
    w = rng.normal(size=(len(sizes), 5, 6)).astype(np.float32)
    g = rng.normal(size=(16, 6)).astype(np.float32)
    s_j = jnp.asarray(sizes, jnp.int32)
    want, vjp = jax.vjp(lambda a, b: jgmm.grouped_matmul(
        a, b, s_j, tm=16, tn=8, interpret=True), jnp.asarray(x),
        jnp.asarray(w))
    dx_j, dw_j = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = tgmm.grouped_matmul(xt, wt, torch.tensor(sizes, dtype=torch.int32),
                              tm=16)
    out.backward(torch.from_numpy(g))
    got = out.detach().numpy()
    for what, a, b in (("forward", got, want), ("dx", xt.grad, dx_j),
                       ("dw", wt.grad, dw_j)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL,
                                   rtol=RTOL, err_msg=what)
    rows_g = np.repeat(np.arange(len(sizes)), sizes)
    dense = np.einsum("mk,mkn->mn", x, w[rows_g])
    visited = rows_g < 4
    np.testing.assert_allclose(got[visited], dense[visited], atol=ATOL,
                               rtol=RTOL)
    if crosses_more_than_4:
        assert (got[~visited] == 0).all() and (xt.grad[~visited] == 0).all()
        assert (dense[~visited] != 0).all()
    else:
        assert visited.all()


def test_gradients_only_when_asked_and_wrapper_checks(monkeypatch):
    """dx runs the same kernel (one more _gmm call) only when x takes a
    gradient, dw only when w does; the wrapper checks its operands."""
    calls = []
    real = tgmm._gmm

    def counted(*a, **kw):
        calls.append(a[1].shape)
        return real(*a, **kw)

    monkeypatch.setattr(tgmm, "_gmm", counted)
    sizes, x, w, g, _ = _inputs("straddle")
    wt = torch.from_numpy(w).requires_grad_()
    out = tgmm.grouped_matmul(torch.from_numpy(x), wt, torch.from_numpy(sizes))
    out.backward(torch.from_numpy(g))
    assert calls == [w.shape] and wt.grad is not None
    calls.clear()
    xt = torch.from_numpy(x).requires_grad_()
    out = tgmm.grouped_matmul(xt, torch.from_numpy(w),
                              torch.from_numpy(sizes))
    out.backward(torch.from_numpy(g))
    assert calls == [w.shape, (w.shape[0], w.shape[2], w.shape[1])]
    monkeypatch.undo()
    rg = tgmm._row_groups(torch.from_numpy(sizes), x.shape[0], len(sizes))
    with pytest.raises(TypeError, match="dtype"):
        tgmm._gmm(torch.from_numpy(x).double(), torch.from_numpy(w), rg)
    with pytest.raises(ValueError, match="shape"):
        tgmm._gmm(torch.from_numpy(x), torch.from_numpy(w), rg[:-1])
    np.testing.assert_allclose(
        tgmm._gmm(torch.from_numpy(x), torch.from_numpy(w), rg).numpy(),
        ref.grouped_matmul_ref(torch.from_numpy(x), rg.long(),
                               torch.from_numpy(w)).numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("m,n,tile", [
    (28_672, 64, (8, 4)),      # R-GCN Tox21 serving: 448 tiles of 64 rows
    (11_200, 64, (8, 4)),      # Tox21 training: 175 tiles for 132 SMs
    (11_200, 62, (8, 4)),      # a dx at N 62
    (28_672, 512, (8, 8)),     # Reaction100: 64 x 128 tiles
    (5, 20, (1, 4)),           # below one tile
    (64, 64, (8, 4)),
    (65, 65, (8, 8)),
    (1_000_000, 64, (8, 4))])
def test_gmm_tile_covers_the_rows_in_64_row_tiles(m, n, tile):
    """The kernel's tile: 8 rows a thread in 64-row tiles, or one tile of
    ceil(m / 8) row groups below 64 rows (fewer than 8 spare rows); 4
    columns a thread up to n 64, 8 past it; every grid fits 65535 row
    tiles, and the main paths' M (11,200 and 28,672) make more tiles than
    an H100 has SMs (132)."""
    got = tgmm.gmm_tile(m, n)
    assert got == tile
    bm = tgmm.THREAD_ROWS * got[0]
    assert -(-m // bm) <= 65535
    assert bm == 64 or (m < 64 and 0 <= bm - m < tgmm.THREAD_ROWS)
    if m >= 11_200:
        assert -(-m // bm) > 132


def test_non_finite_w_stays_in_its_group_as_in_the_reference():
    """An inf in one group's w and a NaN in another's: the plain version
    (what the kernel is held to on the card) and the reference's ``_gmm``
    in interpret mode put inf and NaN at the same places, only in rows of
    those groups, and agree on every other row (finite; 0 where a 16-row
    tile of the reference visits no more groups), in the forward and in
    dx. Tiles straddle both bad groups' boundaries, and the first tile's
    fifth group, which the reference leaves 0, has an inf of its own."""
    sizes = np.asarray([3, 7, 2, 2, 2, 5, 9, 6], np.int32)  # 36 rows, tm 16
    rng = np.random.default_rng(21)
    m, k, n = int(sizes.sum()), 6, 5
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(len(sizes), k, n)).astype(np.float32)
    w[1, 2, 3] = np.inf
    w[5, 4, 1] = np.nan
    w[4, 0, 0] = np.inf
    rg = tgmm._row_groups(torch.from_numpy(sizes), m, len(sizes))
    visited = tgmm._visited_groups(rg, 16, 4)
    rows = rg.numpy()
    bad = np.isin(rows, (1, 5)) & (visited.numpy() >= 0)
    for what, a, b in (("forward", x, w),
                       ("dx", rng.normal(size=(m, n)).astype(np.float32),
                        np.ascontiguousarray(w.transpose(0, 2, 1)))):
        want = np.asarray(jgmm._gmm(jnp.asarray(a), jnp.asarray(b),
                                    jnp.asarray(sizes), tm=16, tn=8,
                                    interpret=True))
        got = ref.grouped_matmul_ref(torch.from_numpy(a), visited,
                                     torch.from_numpy(b)).numpy()
        assert (~np.isfinite(want[bad])).any(), what
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
        assert np.isfinite(got[~bad]).all(), what
        np.testing.assert_allclose(got[np.isfinite(want)],
                                   want[np.isfinite(want)], atol=ATOL,
                                   rtol=RTOL, err_msg=what)
        assert (visited.numpy() < 0).any()
        assert (got[visited.numpy() < 0] == 0).all(), what
