"""Plain PyTorch versions of every kernel in this package.

They are the ground truth the CUDA kernels are held against on the card,
what the kernel wrappers run on CPU tensors, and — ``spmm_coo_single`` — the
paper's non-batched baseline (TensorFlow's SparseTensorDenseMatMul, Fig. 2).

Out-of-range ids contribute nothing. The reference gets that from JAX's
scatter, which drops an update to row ``m_pad``; ``index_add_`` would raise
instead, and the kernels' own padding uses exactly that row-id sentinel, so
the scatters here route every masked slot to a dump row that is cut off.
Sums accumulate in f32.
"""
from __future__ import annotations

import torch

from repro_torch.core.batching import CHUNK
from repro_torch.core.formats import (
    BatchedCOO,
    BatchedCSR,
    BatchedELL,
    csr_slot_rows,
)


def _in_range(ids: torch.Tensor, n: int) -> torch.Tensor:
    return (ids >= 0) & (ids < n)


def _scatter_rows(msg: torch.Tensor, rid: torch.Tensor, keep: torch.Tensor,
                  m_out: int) -> torch.Tensor:
    """out[s, rid[s, i]] += msg[s, i] over the slots where ``keep`` holds:
    msg (batch, slots, n) f32, rid/keep (batch, slots) → (batch, m_out, n)."""
    batch, slots, n = msg.shape
    rows = torch.where(keep, rid.long(), m_out)
    base = torch.arange(batch, device=msg.device)[:, None] * (m_out + 1)
    out = msg.new_zeros((batch * (m_out + 1), n))
    out.index_add_(0, (base + rows).reshape(-1), msg.reshape(-1, n))
    return out.view(batch, m_out + 1, n)[:, :m_out]


def _gather_rows(b: torch.Tensor, cid: torch.Tensor) -> torch.Tensor:
    """b[s, cid[s, i]] with out-of-range ids clamped (masked by callers):
    b (batch, m, n), cid (batch, slots) → (batch, slots, n) f32."""
    idx = cid.long().clamp(0, b.shape[1] - 1)
    return torch.gather(b.float(), 1, idx[..., None].expand(-1, -1,
                                                            b.shape[-1]))


def _coo_product(row_ids, col_ids, values, slots, b, m_out):
    """The batched COO product ``C[s, rid] += val · B[s, cid]`` over the
    first ``slots[s]`` slots of each sample (all slots when None)."""
    m_in = b.shape[1]
    keep = _in_range(row_ids, m_out) & _in_range(col_ids, m_in)
    if slots is not None:
        slot = torch.arange(row_ids.shape[1], device=row_ids.device)
        keep &= slot[None, :] < slots[:, None]
    msg = values.float()[..., None] * _gather_rows(b, col_ids)
    return _scatter_rows(msg, row_ids, keep, m_out).to(b.dtype)


def spmm_coo_single(row_ids, col_ids, values, b, m_out: int) -> torch.Tensor:
    """C[rid] += val * B[cid] for ONE matrix — SparseTensorDenseMatMul."""
    return _coo_product(row_ids[None], col_ids[None], values[None], None,
                        b[None], m_out)[0]


def batched_spmm_coo_ref(a: BatchedCOO, b: torch.Tensor,
                         m_out: int) -> torch.Tensor:
    """a: BatchedCOO, b: (batch, m_pad, n_b) → (batch, m_out, n_b). Every
    slot is visited, as in the reference: padded slots carry 0.0."""
    return _coo_product(a.row_ids, a.col_ids, a.values, None, b, m_out)


def batched_spmm_coo_plain(row_ids, col_ids, values, b):
    """Plain version of the COO kernel, on its raw operands: every slot is
    visited (padded slots carry 0.0)."""
    return _coo_product(row_ids, col_ids, values, None, b, b.shape[1])


def batched_spmm_ell_ref(a: BatchedELL, b: torch.Tensor) -> torch.Tensor:
    """C[s, i] = Σ_k values[s, i, k] · B[s, col_ids[s, i, k]] — the
    atomic-free row split (SWA-CSR analogue)."""
    return batched_spmm_ell_plain(a.col_ids, a.values, b)


def batched_spmm_ell_plain(col_ids, values, b):
    """Plain version of the ELL kernel, on its raw operands."""
    batch, m_pad, k_pad = col_ids.shape
    rows = _gather_rows(b, col_ids.reshape(batch, m_pad * k_pad))
    rows = rows.view(batch, m_pad, k_pad, -1)
    w = torch.where(_in_range(col_ids, b.shape[1]), values.float(), 0.0)
    return torch.einsum("bmk,bmkn->bmn", w, rows).to(b.dtype)


def batched_spmm_csr_ref(a: BatchedCSR, b: torch.Tensor) -> torch.Tensor:
    """CSR row split: each slot's row comes from a search of ``rpt``, and
    slots at or past ``rpt[-1]`` are masked."""
    return batched_spmm_csr_plain(a.rpt, a.col_ids, a.values, b)


def batched_spmm_csr_plain(rpt, col_ids, values, b):
    """Plain version of the CSR kernel, on its raw operands."""
    rows = csr_slot_rows(rpt, col_ids.shape[1])
    return _coo_product(rows, col_ids, values, rpt[:, -1], b, b.shape[1])


def batched_gemm_ref(a_dense: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """gemmBatched analogue: (batch, m, k) @ (batch, k, n)."""
    return torch.bmm(a_dense.to(b.dtype), b)


def batched_gemm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of the batched GEMM kernel: ``C[s] = A[s]·B[s]`` as the
    kernel sums it, one rank-1 update per k in order, in f32."""
    c = torch.zeros((a.shape[0], a.shape[1], b.shape[-1]),
                    dtype=torch.float32, device=b.device)
    af, bf = a.float(), b.float()
    for k in range(a.shape[2]):
        c += af[:, :, k, None] * bf[:, None, k, :]
    return c.to(b.dtype)


def batched_spmm_hybrid_plain(rank, start_s, rlen_sparse, cid, val, slab, b):
    """Plain version of the hybrid kernel on its prepared operands
    (``batched_spmm_hybrid.hybrid_operands``): in degree-sorted row order,
    row q sums ``val · B[cid]`` over its ``rlen_sparse[q]`` CSR slots from
    ``start_s[q]``, the hub rows ``[0, d_pad)`` add ``slab · B``, and
    ``out[r] = acc[rank[r]]`` puts the rows back in their original order.
    ``slab`` is None when the plan has no hub slab."""
    batch, m_pad, _ = b.shape
    nnz_pad = cid.shape[1]
    # the sorted row that owns each slot: a search over the starts of the
    # rows that have sparse slots (their ranges are disjoint)
    live = rlen_sparse > 0
    key = torch.where(live, start_s, nnz_pad)
    key_s, owner = torch.sort(key, dim=1, stable=True)
    slot = torch.arange(nnz_pad, dtype=key.dtype, device=b.device)
    j = torch.searchsorted(key_s.contiguous(), slot.expand(batch, nnz_pad)
                           .contiguous(), right=True) - 1
    q = torch.gather(owner, 1, j.clamp(min=0))
    keep = (j >= 0) & (slot[None] < torch.gather(start_s + rlen_sparse, 1, q))
    acc = _coo_product(torch.where(keep, q, m_pad), cid, val, None, b, m_pad)
    acc = acc.float()
    if slab is not None:
        d_pad = slab.shape[1]
        acc[:, :d_pad] += torch.einsum("bdm,bmn->bdn", slab.float(),
                                       b.float())
    out = torch.gather(acc, 1, rank.long()[..., None].expand(-1, -1,
                                                             acc.shape[-1]))
    return out.to(b.dtype)


def fused_graph_conv_plain(row_ids, col_ids, values, chunks, x, w, bias,
                           residual=None, epilogue: str = "none", rank=None,
                           slab=None):
    """Plain version of the fused layer kernel:
    ``Y = epi(Σ_ch A_ch·(X·W_ch + b_ch) [+ residual])``, each channel's
    scatter over its first ``chunks[s, ch] · CHUNK`` slots (the reference's
    skew-aware bound). Ids are ``(batch, channels, nnz_pad)``.

    The hybrid branch (``rank`` (batch, m_pad) and ``slab`` (batch,
    channels, d_pad, m_pad), both or neither), in the reference's order:
    the scatter lands in degree-sorted rows (the row ids are sorted
    positions), the head ``Σ_ch slab_ch·U_ch`` is added to rows
    ``[0, d_pad)``, ``acc[rank[r]]`` restores the original row order, then
    the residual and ReLU."""
    if (rank is None) != (slab is None):
        raise ValueError("rank and slab are set together")
    batch, channels, nnz_pad = row_ids.shape
    m_pad, n_out = x.shape[1], w.shape[-1]
    u = (torch.einsum("bmn,cnf->bcmf", x.float(), w.float())
         + bias.float()[None, :, None, :])
    u = u.reshape(batch * channels, m_pad, n_out)

    def flat(t):
        return t.reshape(batch * channels, nnz_pad)

    slots = chunks.reshape(-1).long() * CHUNK
    y = _coo_product(flat(row_ids), flat(col_ids), flat(values), slots, u,
                     m_pad)
    y = y.view(batch, channels, m_pad, n_out).sum(dim=1)
    if slab is not None:
        y = y.float()
        d_pad = slab.shape[2]
        y[:, :d_pad] += torch.einsum(
            "bcdm,bcmf->bdf", slab.float(),
            u.view(batch, channels, m_pad, n_out))
        y = torch.gather(y, 1, rank.long()[..., None].expand(-1, -1, n_out))
    if residual is not None:
        y = y + residual.float()
    if epilogue == "relu":
        y = torch.relu(y)
    return y.to(x.dtype)
