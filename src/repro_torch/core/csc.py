"""CSC sampling structure and bipartite Blocks of the giant-graph tier
(DESIGN.md §14), the reference's ``core/csc.py``: the same numpy code, so
a graph and its blocks are bitwise the reference's.

One graph of millions of nodes cannot be padded into a
:class:`~repro_torch.core.formats.BatchedCOO` whole. The tier holds the
full graph on the host in a static CSC structure (:class:`CSCGraph`: one
``indptr`` column pointer per destination node, the in-neighbor
``indices`` grouped per column, so sampling reads one contiguous slice per
seed), and samples fanout-bounded neighborhoods into bipartite **Blocks**
(``repro_torch.sampling``), each in the padded batched-COO format that
every kernel, autotune branch and telemetry hook downstream takes.

**Block convention.** A block is a (dst-nodes × src-nodes) bipartite
adjacency with compacted local ids, embedded in the square
``(m_pad, m_pad)`` shape of the batched kernels by ordering the src node
set with the dst nodes as its PREFIX (``src_ids[:n_dst]`` are the dst
nodes). Rows ``0..n_dst-1`` carry edges, rows ``n_dst..m_pad-1`` are
structural padding (value 0.0, index 0), and ``BatchedCOO.n_rows ==
n_dst`` is the true row count. ``C = A_block @ H_src`` then holds the next
layer's dst features in its first ``n_dst`` rows, which are the src prefix
of the next block: layer chaining is a static slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.formats import BatchedCOO, coo_from_lists


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class CSCGraph:
    """Static host-side CSC over ONE giant graph (numpy).

    indptr  : (n_nodes + 1,) int64 — per-DESTINATION column pointers
    indices : (n_edges,)    int32/int64 — in-neighbor (source) node ids,
              grouped per destination: node ``v``'s in-neighbors are
              ``indices[indptr[v]:indptr[v+1]]``

    Immutable, and shared read-only by the sampler and its prefetch thread.
    """

    indptr: np.ndarray
    indices: np.ndarray

    def __post_init__(self):
        if self.indptr.ndim != 1 or self.indices.ndim != 1:
            raise ValueError("CSCGraph arrays must be 1-D")
        if int(self.indptr[0]) != 0 or int(self.indptr[-1]) != len(self.indices):
            raise ValueError(
                f"indptr must run 0..n_edges={len(self.indices)}, got "
                f"[{int(self.indptr[0])}..{int(self.indptr[-1])}]")

    @property
    def n_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def n_edges(self) -> int:
        return len(self.indices)

    def in_degrees(self) -> np.ndarray:
        """(n_nodes,) int64 — per-destination in-degree (the static
        hot-node cache's admission statistic)."""
        return np.diff(self.indptr)

    def in_neighbors(self, v: int) -> np.ndarray:
        """The contiguous in-neighbor slice of one destination node."""
        return self.indices[self.indptr[v]:self.indptr[v + 1]]


def csc_from_edges(src: np.ndarray, dst: np.ndarray,
                   n_nodes: int) -> CSCGraph:
    """Build a :class:`CSCGraph` from flat (src → dst) edge arrays by a
    stable counting sort on the destination (parallel edges and the source
    order within a destination are kept), O(E + N)."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    if src.shape != dst.shape:
        raise ValueError(f"src/dst shape mismatch: {src.shape} vs {dst.shape}")
    if len(dst) and (int(dst.min()) < 0 or int(dst.max()) >= n_nodes
                     or int(src.min()) < 0 or int(src.max()) >= n_nodes):
        raise ValueError(f"edge endpoints out of range [0, {n_nodes})")
    counts = np.bincount(dst, minlength=n_nodes)
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    order = np.argsort(dst, kind="stable")
    indices = np.ascontiguousarray(src[order].astype(np.int32, copy=False))
    return CSCGraph(indptr=indptr, indices=indices)


def coo_to_csc(src: np.ndarray, dst: np.ndarray, n_nodes: int) -> CSCGraph:
    """COO edge list → CSC (:func:`csc_from_edges`, named for the round
    trip)."""
    return csc_from_edges(src, dst, n_nodes)


def csc_to_coo(csc: CSCGraph) -> tuple[np.ndarray, np.ndarray]:
    """CSC → flat (src, dst) COO edge arrays, destination-major: the order
    ``coo_to_csc`` stores, so ``coo_to_csc(*csc_to_coo(g), n)`` is bitwise
    ``g``."""
    dst = np.repeat(np.arange(csc.n_nodes, dtype=np.int64),
                    csc.in_degrees())
    return csc.indices.copy(), dst


@dataclasses.dataclass(frozen=True)
class Block:
    """One sampled bipartite (dst × src) adjacency, kernel-ready.

    adj     : BatchedCOO on the CPU (as sampled), batch 1, square over
              ``m_pad`` padded rows. Rows are LOCAL dst ids (< n_dst), cols
              LOCAL src ids (< n_src); ``adj.n_rows == [n_dst]``, and padded
              slots hold value 0.0 at index 0.
    src_ids : (n_src,) int64 GLOBAL node ids of the src set, dst-prefixed:
              ``src_ids[:n_dst]`` are the dst nodes in seed order.
    m_pad   : the padded square dimension (a bucket rung, see
              ``repro_torch.sampling.bucketing``).
    max_deg : the largest sampled in-degree of a dst row, the skew that
              ``autotune.Workload.max_deg`` prices.
    """

    adj: BatchedCOO
    src_ids: np.ndarray
    n_dst: int
    n_src: int
    m_pad: int
    max_deg: int

    @property
    def nnz_pad(self) -> int:
        return self.adj.nnz_pad

    @property
    def nnz(self) -> int:
        """The true slot count, read from the host copy of ``adj`` (the
        trainer moves a copy to the device, never this one), so it waits on
        no device."""
        return int(self.adj.nnz[0])

    def dst_ids(self) -> np.ndarray:
        """(n_dst,) global ids of the dst nodes (the src prefix)."""
        return self.src_ids[:self.n_dst]


def make_block(
    rows: np.ndarray,
    cols: np.ndarray,
    src_ids: np.ndarray,
    n_dst: int,
    *,
    m_pad: int | None = None,
    nnz_pad: int | None = None,
    normalize: str = "mean",
) -> Block:
    """Emit one sampled bipartite adjacency as a kernel-ready :class:`Block`.

    ``rows``/``cols`` are LOCAL (dst, src) edge endpoints, ``src_ids`` the
    dst-prefixed global id map. ``normalize="mean"`` sets each edge value to
    ``1 / sampled_in_degree(dst)`` (the neighbor-sampled mean aggregator:
    the SAMPLED degree, not the full graph's); ``"none"`` keeps 1.0.
    ``m_pad``/``nnz_pad`` pad to a bucket rung (defaults: multiples of 8).
    """
    if normalize not in ("mean", "none"):
        raise ValueError(f"unknown normalize {normalize!r}: "
                         "expected 'mean' or 'none'")
    rows = np.asarray(rows, np.int32)
    cols = np.asarray(cols, np.int32)
    n_src = len(src_ids)
    deg = np.bincount(rows, minlength=max(n_dst, 1)) if len(rows) else \
        np.zeros(max(n_dst, 1), np.int64)
    max_deg = int(deg.max()) if len(deg) else 0
    if normalize == "mean" and len(rows):
        vals = (1.0 / np.maximum(deg[rows], 1)).astype(np.float32)
    else:
        vals = np.ones(len(rows), np.float32)
    m_pad = m_pad or _round_up(max(n_src, 1), 8)
    if n_src > m_pad:
        raise ValueError(f"n_src={n_src} exceeds m_pad={m_pad}")
    if nnz_pad is not None and len(rows) > nnz_pad:
        raise ValueError(f"nnz={len(rows)} exceeds nnz_pad={nnz_pad}")
    adj = coo_from_lists([(rows, cols, vals)], [n_dst], nnz_pad=nnz_pad)
    return Block(adj=adj, src_ids=np.asarray(src_ids, np.int64),
                 n_dst=int(n_dst), n_src=int(n_src), m_pad=int(m_pad),
                 max_deg=max_deg)
