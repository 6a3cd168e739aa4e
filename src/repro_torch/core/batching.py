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
    takes. ``large`` (fused kernel only) keeps each block's panels in a
    global scratch, where they do not fit shared memory.
    """

    batch: int
    m_pad: int
    n_b: int
    n_block: int        # column panel width
    p: int              # number of column panels = ceil(n_b / n_block)
    case: int           # 1, 2 or 3 (paper Fig. 5)
    smem_bytes: int
    large: bool = False  # fused kernel: panels in global scratch, not smem


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
    permutation). The COO kernels are planned at 4 bytes whatever B's
    type: for them the plan decides case 3 (the large entries, whose
    accumulator is f32) and the column panel width.
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


# The fused kernel's blocks (csrc/fused_graph_conv.cu): row tiles of 64
# rows, k-tiles 32 deep through a ring of shared memory, panels kept at a
# tile width of 16, 32, 64 or 128 columns.
FUSED_TM = 64
FUSED_TK = 32
# narrow the fused kernel's panels until the grid has a block for each of
# the H100's 132 SMs, or the panels are 16 columns wide (32 in bf16, where
# a 16-column panel leaves the tensor cores two products a k-step): the
# widths that ran fastest on an H100 at Tox21, Reaction100 and the powerlaw
# batch (chip_smoke.py's [panels] lines)
FUSED_FILL_BLOCKS = 132


def fused_tile_cols(n_block: int) -> int:
    """The tile width the fused kernel keeps a panel of ``n_block``
    columns at: the narrowest of 16, 32, 64 and 128 that holds it."""
    return next(t for t in (16, 32, 64, PANEL_MAX) if n_block <= t)


def fused_tile_rows(m_pad: int, tile_cols: int, itemsize: int) -> int:
    """The fused kernel's row tile: 64 rows, or 56 for f32 at 128 columns
    where 56-row tiles pad ``m_pad`` less (m_pad 56)."""
    rows56 = -(-m_pad // 56) * 56 < -(-m_pad // FUSED_TM) * FUSED_TM
    return 56 if itemsize == 4 and tile_cols == PANEL_MAX and rows56 \
        else FUSED_TM


def fused_ring_bytes(tile_cols: int, itemsize: int,
                     rows: int = FUSED_TM) -> int:
    """Shared memory of the fused kernel's ring: stages (three for bf16 or
    at most 32 columns, else two) of an X (or slab) tile of ``rows`` x 32
    and a W tile of 32 x ``tile_cols``, rows padded by 4 f32 (X) or 8 bf16
    elements (X and W)."""
    bf16 = itemsize == 2
    stages = 3 if bf16 or tile_cols <= 32 else 2
    pad = 8 if bf16 else 4
    return stages * (rows * (FUSED_TK + pad)
                     + FUSED_TK * (tile_cols + (pad if bf16 else 0))
                     ) * itemsize


def fused_panel_floats(m_pad: int, tile_cols: int) -> int:
    """f32 elements of one block's U_ch panel (``m_pad`` rounded up to 32
    rows) and accumulator (``m_pad`` rows), ``tile_cols`` wide: in shared
    memory, or in the large-matrix scratch."""
    return (_round_up(m_pad, FUSED_TK) + m_pad) * tile_cols


def fused_large_scratch(*, batch: int, channels: int, m_pad: int,
                        n_out: int, n_block: int) -> tuple[int, int]:
    """The large-matrix branch's scratch: ``(floats, group)``. It holds
    ``U`` of ``group`` channels at a time, each ``batch × m_pad × ldu`` f32
    (``ldu`` = n_out rounded up to 4), and, where ``group`` is fewer than
    ``channels``, one more such block for the accumulator between the
    groups. ``group`` is every channel where their ``U`` takes at most
    twice the U_ch and accumulator panels that the branch's former design
    kept per block (``batch × p × fused_panel_floats``, the plan of
    ``n_block`` columns), else as many as fit that budget beside the
    accumulator (at least one). The kernel derives the same group from the
    size it is given."""
    ldu = _round_up(n_out, 4)
    per_ch = batch * m_pad * ldu
    budget = 2 * batch * -(-n_out // n_block) * fused_panel_floats(
        m_pad, fused_tile_cols(n_block))
    if channels * per_ch <= budget:
        return channels * per_ch, channels
    group = max(1, budget // per_ch - 1)
    return (group + 1) * per_ch, group


def plan_fused_graph_conv(*, batch: int, m_pad: int, n_in: int,
                          n_out: int, itemsize: int = 4) -> BatchPlan:
    """Blocking plan for the fused graph-conv kernel, case 3 exactly where
    the reference's is (m_pad > LARGE_M). A block stages X and W k-tiles of
    ``itemsize``-byte elements (2 for bf16) through its ring and keeps one
    channel's ``U_ch`` panel and the accumulator, both f32, in shared
    memory; ``smem_bytes`` is that working set. The widest panel (≤
    PANEL_MAX) that fits is taken; where not even a 32-column panel fits
    (m_pad past ~750 in f32), the plan is ``large``: the panels live in a
    global scratch and shared memory holds the ring alone. Then the panels
    narrow, down to 16 columns (32 in bf16), until the grid (batch × p)
    reaches FUSED_FILL_BLOCKS. ``n_in`` does not enter: X streams through
    the ring."""
    if m_pad > LARGE_M:
        return BatchPlan(batch, m_pad, n_out, n_out, 1, 3, 0)

    def ring(nb: int) -> int:
        tc = fused_tile_cols(nb)
        return fused_ring_bytes(tc, itemsize,
                                fused_tile_rows(m_pad, tc, itemsize))

    def smem(nb: int) -> int:
        return ring(nb) + 4 * fused_panel_floats(m_pad, fused_tile_cols(nb))

    n_block = min(_round_up(n_out, WARP), PANEL_MAX) if n_out >= WARP \
        else n_out
    while smem(n_block) > SMEM_BYTES and n_block > WARP:
        n_block = _round_up(n_block // 2, WARP)
    large = smem(n_block) > SMEM_BYTES
    narrowest = 32 if itemsize == 2 else 16
    while (batch * -(-n_out // n_block) < FUSED_FILL_BLOCKS
           and n_block > narrowest):
        n_block = _round_up(n_block // 2, narrowest)
    p = -(-n_out // n_block)
    return BatchPlan(batch, m_pad, n_out, n_block, p, 1 if p == 1 else 2,
                     ring(n_block) if large else smem(n_block), large)


def tier_ladder(
    *,
    m_max: int,
    nnz_max: int,
    levels: int = 3,
    m_min: int = 2 * SUBLANES,
    nnz_min: int = 64,
) -> tuple[tuple[int, int], ...]:
    """Geometry ladder of the serving scheduler's bucketing policy (the
    reference's): ``levels`` (m_pad, nnz_pad) rungs halving down from the
    dataset maxima, rows rounded to ``SUBLANES`` and nnz slots to 8 (as
    ``coo_from_lists`` pads them). The top rung always covers (``m_max``,
    ``nnz_max``), so every admissible request has a bucket; lower rungs
    stop small molecules paying worst-case padding.
    """
    if levels < 1:
        raise ValueError(f"levels must be >= 1, got {levels}")
    m_top = _round_up(max(m_max, 1), SUBLANES)
    nnz_top = _round_up(max(nnz_max, 1), 8)
    ms, nnzs = [], []
    m, nz = m_top, nnz_top
    for _ in range(levels):
        ms.append(max(_round_up(m, SUBLANES), _round_up(m_min, SUBLANES)))
        nnzs.append(max(_round_up(nz, 8), _round_up(nnz_min, 8)))
        m //= 2
        nz //= 2
    return tuple(sorted(set(zip(ms, nnzs))))
