"""Batching planner — the paper's §IV-B/§IV-C resource-assignment logic,
re-derived for Hopper shared memory.

Paper (P100/CUDA)                         | Here (H100, sm_90a)
------------------------------------------+----------------------------------
shared memory per block: 32-64 KB         | 232,448 B per block (dynamic smem)
case 1: m_A*n_B*4 <= smem -> whole output | case 1: one column panel covers n_B
        resident in shared memory         |
case 2: column cache-blocking into p subs | case 2: split n_B into p panels of
        (Fig. 5-(b)/(d))                  |         32-lane multiples
case 3: m_A > 8192 -> don't batch, use a  | case 3: m_pad > LARGE_M, or not even
        large-matrix kernel               |         one 32-lane panel fits smem
one thread block per (matrix x panel)     | the same: grid (batch, p)
subWarp = next_pow2(n_B) capped at 32     | the same (``sub_warp``)

A panel is at most ``PANEL_MAX`` columns so that a thread of the fused,
hybrid and GEMM kernels keeps its share of a panel row (4 columns) in
registers. The planner sees
only shapes and emits a :class:`BatchPlan` that the kernels, the plain
versions and the tests share.
"""
from __future__ import annotations

import dataclasses
import math

SMEM_BYTES = 232_448     # shared memory one block may use on sm_90a
WARP = 32                # lanes per warp; panels are multiples of it
PANEL_MAX = 4 * WARP     # widest column panel a kernel block takes
LARGE_M = 8192           # paper's case-3 threshold, kept verbatim
CHUNK = 128              # nnz chunk: the fused kernel's loop-bound unit,
                         # kept from the reference (see runtime_chunks)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def sub_warp(n_block: int) -> int:
    """Lanes per row (paper §IV-C): next_pow2(n_B) capped at one warp."""
    sw = 1
    while sw < min(n_block, WARP):
        sw *= 2
    return sw


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    """Static blocking decision for one batched SpMM or fused-layer call.

    ``smem_bytes`` is the dynamic shared memory one block of the kernel
    takes.
    """

    batch: int
    m_pad: int
    n_b: int
    n_block: int        # column panel width
    p: int              # number of column panels = ceil(n_b / n_block)
    case: int           # 1, 2 or 3 (paper Fig. 5)
    smem_bytes: int


def _panel(n: int, fixed_bytes: int, bytes_per_col: int) -> int | None:
    """Widest panel (≤ PANEL_MAX, a multiple of WARP unless ``n`` is
    narrower) whose working set ``fixed + bytes_per_col · n_block`` fits one
    block's shared memory; None when not even one warp-wide panel does."""
    n_block = min(_round_up(n, WARP), PANEL_MAX) if n >= WARP else n
    while fixed_bytes + bytes_per_col * n_block > SMEM_BYTES:
        if n_block <= WARP:
            return None
        n_block = _round_up(n_block // 2, WARP)
    return n_block


def plan_batched_spmm(*, batch: int, m_pad: int, n_b: int,
                      fixed_bytes: int = 0, itemsize: int = 4) -> BatchPlan:
    """Column panels for the ELL, COO, CSR and hybrid kernels. A block holds
    one ``(m_pad, n_block)`` panel of ``itemsize``-byte elements in shared
    memory: the staged B panel of the ELL and hybrid kernels (2 bytes for a
    bf16 B), plus ``fixed_bytes`` beside it (the hybrid kernel's row
    permutation). The COO kernel's panel is its atomic accumulator, which
    stays f32 whatever B's type, so the COO kernel is planned at 4 bytes.
    The CSR kernel stages nothing and takes any plan; it is planned as the
    ELL kernel is, so that case 3 names the same matrices for both.
    Unlike the reference's VMEM plan, the index stream (k_pad or nnz_pad
    slots) is read from global memory and takes no shared memory."""
    n_block = (None if m_pad > LARGE_M
               else _panel(n_b, fixed_bytes, m_pad * itemsize))
    if n_block is None:
        return BatchPlan(batch, m_pad, n_b, n_b, 1, 3, 0)
    p = -(-n_b // n_block)
    return BatchPlan(batch, m_pad, n_b, n_block, p, 1 if p == 1 else 2,
                     fixed_bytes + m_pad * n_block * itemsize)


# Hybrid dispatch defaults, the reference's: a row whose density
# ``deg / m_pad`` reaches TAU is a hub and goes to the dense slab; the rest
# stay in the row-split CSR remainder, bounded by ``dmin - 1`` slots a row.
HYBRID_TAU = 0.25
HYBRID_NBINS = 8
SUBLANES = 8             # the reference rounds m_pad, d_pad and bins to it


@dataclasses.dataclass(frozen=True)
class HybridPlan:
    """The reference's static record of the degree-binned hybrid split.

    ``spmm`` is the Hopper column-panel plan of the hybrid kernel (its
    ``m_pad`` is the reference's, rounded up to 8). A row with
    ``deg >= dmin`` is a hub. ``d_pad`` is the height of the dense hub slab:
    every hub holds at least ``dmin`` non-zeros, so ``nnz_pad // dmin``
    bounds their count, and ``d_pad == 0`` means no slab at all. ``bins``
    are the reference's work bins of the degree-sorted row axis; the CUDA
    kernel bounds each row by its own length and does not read them.
    """

    spmm: BatchPlan
    dmin: int
    d_pad: int
    bins: tuple[tuple[int, int], ...]


def plan_hybrid(*, batch: int, m_pad: int, n_b: int,
                nnz_pad: int, itemsize: int = 4) -> HybridPlan:
    """The reference's ``plan_hybrid`` at its defaults (HYBRID_TAU,
    HYBRID_NBINS): ``dmin``, ``d_pad`` and ``bins`` are derived from
    ``m_pad`` rounded up to 8, as the reference derives them, so that rows
    classify alike in both packages. The panels of ``itemsize``-byte B
    elements leave room for the kernel's ``m_pad`` int32 row permutation
    beside the B panel."""
    m_pad = _round_up(max(m_pad, 1), SUBLANES)
    spmm = plan_batched_spmm(batch=batch, m_pad=m_pad, n_b=n_b,
                             fixed_bytes=4 * m_pad, itemsize=itemsize)
    dmin = max(1, math.ceil(HYBRID_TAU * m_pad))
    d_pad = (0 if nnz_pad < dmin
             else min(m_pad, _round_up(max(1, nnz_pad // dmin), SUBLANES)))
    rows_per_bin = max(SUBLANES,
                       _round_up(max(1, m_pad // HYBRID_NBINS), SUBLANES))
    bins = tuple((s, min(s + rows_per_bin, m_pad))
                 for s in range(0, m_pad, rows_per_bin))
    return HybridPlan(spmm, dmin, d_pad, bins)


def plan_batched_gemm(*, batch: int, m: int, n: int, k: int) -> BatchPlan:
    """Column panels for the batched GEMM kernel (the gemmBatched analogue):
    a block keeps the whole ``(m, k)`` A tile and one ``(k, n_block)`` B
    panel in shared memory and C in registers. Case 3 when the A tile and
    one 32-lane panel do not fit."""
    n_block = (None if max(m, k) > LARGE_M
               else _panel(n, m * k * 4, k * 4))
    if n_block is None:
        return BatchPlan(batch, m, n, n, 1, 3, 0)
    p = -(-n // n_block)
    return BatchPlan(batch, m, n, n_block, p, 1 if p == 1 else 2,
                     (m * k + k * n_block) * 4)


def chunk_counts(nnz_per_sample) -> tuple[int, ...]:
    """Skew-aware packing record: ``ceil(nnz / CHUNK)`` per sample, or
    ``Σ_ch ceil(nnz_ch / CHUNK)`` for per-(sample × channel) rows (ceils do
    not commute with the channel sum)."""

    def one(n):
        try:
            return sum(-(-int(c) // CHUNK) for c in n)
        except TypeError:
            return -(-int(n) // CHUNK)

    return tuple(one(n) for n in nnz_per_sample)


def plan_fused_graph_conv(*, batch: int, m_pad: int, n_in: int,
                          n_out: int, itemsize: int = 4) -> BatchPlan:
    """Blocking plan for the fused graph-conv kernel. One block keeps in
    shared memory the sample's X tile ``(m_pad, n_in)`` of ``itemsize``-byte
    elements (2 for bf16 X), one channel's ``U_ch`` panel ``(m_pad,
    n_block)`` and the accumulator ``(m_pad, n_block)``, both f32 whatever
    X's type (padded to 16 bytes, where the f32 panels start); W and the
    index stream are read from global memory (L2)."""
    x_tile = _round_up(m_pad * n_in * itemsize, 16)
    n_block = (None if m_pad > LARGE_M
               else _panel(n_out, x_tile, 2 * m_pad * 4))
    if n_block is None:
        return BatchPlan(batch, m_pad, n_out, n_out, 1, 3, 0)
    p = -(-n_out // n_block)
    return BatchPlan(batch, m_pad, n_out, n_block, p, 1 if p == 1 else 2,
                     x_tile + 2 * m_pad * n_block * 4)
