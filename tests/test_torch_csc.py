"""Port parity: the giant-graph tier's CSC structure, blocks and graph
generator (``repro_torch.core.csc``, ``repro_torch.data.graphs.reddit_like``)
against the JAX package's on the CPU.

All of it is host code, so every comparison is bitwise: the same numpy
inputs give the same arrays, dtypes included, and a block's ``BatchedCOO``
(CPU torch tensors in the port) holds the reference's values.
"""
import numpy as np
import pytest

from repro.core import csc as jcsc
from repro.data import graphs as jgraphs
from repro_torch.core import csc as tcsc
from repro_torch.data import graphs as tgraphs

COO_FIELDS = ("row_ids", "col_ids", "values", "nnz", "n_rows")


def assert_same(a: np.ndarray, b) -> None:
    b = np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def assert_same_block(t, j) -> None:
    """A port Block against a reference Block: every field, bitwise."""
    for f in COO_FIELDS:
        assert_same(getattr(t.adj, f).numpy(), getattr(j.adj, f))
    assert_same(t.src_ids, j.src_ids)
    assert (t.n_dst, t.n_src, t.m_pad, t.max_deg, t.nnz, t.nnz_pad) == \
        (j.n_dst, j.n_src, j.m_pad, j.max_deg, j.nnz, j.nnz_pad)
    assert_same(t.dst_ids(), j.dst_ids())


def _edges(seed: int, n: int, e: int):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, e).astype(np.int64),
            rng.integers(0, n, e).astype(np.int64))


@pytest.mark.parametrize("seed,n,e", [(0, 50, 300), (1, 7, 0), (2, 200, 40),
                                      (3, 1, 5)])
def test_csc_round_trip_is_the_reference_bitwise(seed, n, e):
    src, dst = _edges(seed, n, e)
    t, j = tcsc.csc_from_edges(src, dst, n), jcsc.csc_from_edges(src, dst, n)
    assert_same(t.indptr, j.indptr)
    assert_same(t.indices, j.indices)
    assert (t.n_nodes, t.n_edges) == (j.n_nodes, j.n_edges) == (n, e)
    assert_same(t.in_degrees(), j.in_degrees())
    for v in range(min(n, 5)):
        assert_same(t.in_neighbors(v), j.in_neighbors(v))
    ts, td = tcsc.csc_to_coo(t)
    js, jd = jcsc.csc_to_coo(j)
    assert_same(ts, js)
    assert_same(td, jd)
    back = tcsc.coo_to_csc(ts, td, n)
    assert_same(back.indptr, t.indptr)
    assert_same(back.indices, t.indices)


@pytest.mark.parametrize("src,dst,n,what", [
    ([0, 1], [0, 5], 5, "out of range"),
    ([-1], [0], 5, "out of range"),
    ([0, 1], [0], 5, "shape mismatch"),
])
def test_csc_rejects_bad_edges_as_the_reference(src, dst, n, what):
    for mod in (tcsc, jcsc):
        with pytest.raises(ValueError, match=what):
            mod.csc_from_edges(np.asarray(src), np.asarray(dst), n)


def test_csc_rejects_a_bad_indptr_as_the_reference():
    for mod in (tcsc, jcsc):
        with pytest.raises(ValueError, match="indptr must run"):
            mod.CSCGraph(indptr=np.asarray([0, 2, 3]),
                         indices=np.asarray([1, 0], np.int32))
        with pytest.raises(ValueError, match="1-D"):
            mod.CSCGraph(indptr=np.zeros((2, 2), np.int64),
                         indices=np.zeros(0, np.int32))


def _raw_block(seed: int, n_dst: int, n_src: int, e: int):
    rng = np.random.default_rng(seed)
    rows = np.sort(rng.integers(0, n_dst, e)).astype(np.int32)
    cols = rng.integers(0, n_src, e).astype(np.int32)
    src_ids = rng.permutation(10 * n_src)[:n_src]
    return rows, cols, src_ids


@pytest.mark.parametrize("normalize", ["mean", "none"])
@pytest.mark.parametrize("pads", [(None, None), (64, 96), (40, 40)])
def test_make_block_is_the_reference_bitwise(normalize, pads):
    rows, cols, src_ids = _raw_block(7, 12, 37, 40)
    m_pad, nnz_pad = pads
    kw = dict(m_pad=m_pad, nnz_pad=nnz_pad, normalize=normalize)
    t = tcsc.make_block(rows, cols, src_ids, 12, **kw)
    j = jcsc.make_block(rows, cols, src_ids, 12, **kw)
    assert_same_block(t, j)
    assert t.adj.values.device.type == "cpu"
    if normalize == "mean":
        deg = np.bincount(rows, minlength=12)
        np.testing.assert_array_equal(t.adj.values[0, :40].numpy(),
                                      (1.0 / deg[rows]).astype(np.float32))


def test_make_block_without_edges_is_the_reference():
    t = tcsc.make_block([], [], np.arange(3), 3)
    j = jcsc.make_block([], [], np.arange(3), 3)
    assert_same_block(t, j)
    assert t.max_deg == 0 and t.nnz == 0


@pytest.mark.parametrize("kw,what", [
    (dict(normalize="sum"), "unknown normalize"),
    (dict(m_pad=16), "exceeds m_pad"),
    (dict(nnz_pad=8), "exceeds nnz_pad"),
])
def test_make_block_errors_are_the_reference(kw, what):
    rows, cols, src_ids = _raw_block(3, 6, 37, 40)
    for mod in (tcsc, jcsc):
        with pytest.raises(ValueError, match=what):
            mod.make_block(rows, cols, src_ids, 6, **kw)


@pytest.mark.parametrize("n,kw", [
    (2_000, {}),
    (500, dict(n_classes=4, n_features=8, seed=3)),
    (1_000, dict(avg_deg=4, alpha=0.8, homophily=0.2, val_frac=0.25,
                 seed=11)),
])
def test_reddit_like_is_the_reference_bitwise(n, kw):
    t, j = tgraphs.reddit_like(n, **kw), jgraphs.reddit_like(n, **kw)
    for f in ("features", "labels", "train_ids", "val_ids"):
        assert_same(getattr(t, f), getattr(j, f))
    assert_same(t.csc.indptr, j.csc.indptr)
    assert_same(t.csc.indices, j.csc.indices)
    assert t.n_classes == j.n_classes
    assert t.csc.in_degrees().min() >= 1            # every node self-loops
    assert not set(t.train_ids) & set(t.val_ids)
