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

A panel is at most ``PANEL_MAX`` columns so that a thread of the fused kernel
keeps its share of a panel row (4 columns) in registers. The planner sees
only shapes and emits a :class:`BatchPlan` that the kernels, the plain
versions and the tests share.
"""
from __future__ import annotations

import dataclasses

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


def plan_batched_spmm(*, batch: int, m_pad: int, n_b: int) -> BatchPlan:
    """Column panels for the ELL and COO kernels. A block holds one
    ``(m_pad, n_block)`` f32 panel in shared memory: the staged B panel of
    the ELL kernel, the atomic accumulator of the COO kernel. Unlike the
    reference's VMEM plan, the index stream (k_pad or nnz_pad slots) is read
    from global memory and takes no shared memory."""
    n_block = None if m_pad > LARGE_M else _panel(n_b, 0, m_pad * 4)
    if n_block is None:
        return BatchPlan(batch, m_pad, n_b, n_b, 1, 3, 0)
    p = -(-n_b // n_block)
    return BatchPlan(batch, m_pad, n_b, n_block, p, 1 if p == 1 else 2,
                     m_pad * n_block * 4)


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
                          n_out: int) -> BatchPlan:
    """Blocking plan for the fused graph-conv kernel. One block keeps in
    shared memory the sample's X tile ``(m_pad, n_in)``, one channel's
    ``U_ch`` panel ``(m_pad, n_block)`` and the accumulator
    ``(m_pad, n_block)``; W and the index stream are read from global
    memory (L2)."""
    n_block = (None if m_pad > LARGE_M
               else _panel(n_out, m_pad * n_in * 4, 2 * m_pad * 4))
    if n_block is None:
        return BatchPlan(batch, m_pad, n_out, n_out, 1, 3, 0)
    p = -(-n_out // n_block)
    return BatchPlan(batch, m_pad, n_out, n_block, p, 1 if p == 1 else 2,
                     (m_pad * n_in + 2 * m_pad * n_block) * 4)
