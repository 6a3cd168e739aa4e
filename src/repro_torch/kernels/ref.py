"""Plain PyTorch versions of every kernel in this package.

They are the ground truth the CUDA kernels are held against on the card,
what the kernel wrappers run on CPU tensors, and — ``spmm_coo_single`` — the
paper's non-batched baseline (TensorFlow's SparseTensorDenseMatMul, Fig. 2).

Out-of-range ids contribute nothing. The reference gets that from JAX's
scatter, which drops an update to row ``m_pad``; ``index_add_`` would raise
instead, and the kernels' own padding uses exactly that row-id sentinel, so
the scatters here route every masked slot to a dump row that is cut off.
Sums accumulate in f32, whatever the operands' types: bf16 values and B are
widened, their products summed in f32 and the result rounded to B's type
once at the end, as the kernels do; int8 value codes take their per-matrix
``scale`` on the f32 sum, before that rounding.
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


def _dequant(acc: torch.Tensor, scale) -> torch.Tensor:
    """The i8 policy's epilogue: the f32 sum times its matrix's scale."""
    return acc if scale is None else acc * scale[:, None, None]


def _coo_product(row_ids, col_ids, values, slots, b, m_out, scale=None):
    """The batched COO product ``C[s, rid] += val · B[s, cid]`` over the
    first ``slots[s]`` slots of each sample (all slots when None)."""
    m_in = b.shape[1]
    keep = _in_range(row_ids, m_out) & _in_range(col_ids, m_in)
    if slots is not None:
        slot = torch.arange(row_ids.shape[1], device=row_ids.device)
        keep &= slot[None, :] < slots[:, None]
    msg = values.float()[..., None] * _gather_rows(b, col_ids)
    return _dequant(_scatter_rows(msg, row_ids, keep, m_out),
                    scale).to(b.dtype)


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


def batched_spmm_ell_plain(col_ids, values, b, scale=None):
    """Plain version of the ELL kernel, on its raw operands; ``scale``
    (batch,) f32 when ``values`` are int8 codes."""
    batch, m_pad, k_pad = col_ids.shape
    rows = _gather_rows(b, col_ids.reshape(batch, m_pad * k_pad))
    rows = rows.view(batch, m_pad, k_pad, -1)
    w = torch.where(_in_range(col_ids, b.shape[1]), values.float(), 0.0)
    return _dequant(torch.einsum("bmk,bmkn->bmn", w, rows),
                    scale).to(b.dtype)


def batched_spmm_csr_ref(a: BatchedCSR, b: torch.Tensor) -> torch.Tensor:
    """CSR row split: each slot's row comes from a search of ``rpt``, and
    slots at or past ``rpt[-1]`` are masked."""
    return batched_spmm_csr_plain(a.rpt, a.col_ids, a.values, b)


def batched_spmm_csr_plain(rpt, col_ids, values, b, scale=None):
    """Plain version of the CSR kernel, on its raw operands; ``scale``
    (batch,) f32 when ``values`` are int8 codes."""
    rows = csr_slot_rows(rpt, col_ids.shape[1])
    return _coo_product(rows, col_ids, values, rpt[:, -1], b, b.shape[1],
                        scale)


# ---------------------------------------------------------------------------
# g-SpMM: C[r] = reduce_{edges (r, c)} op(B[c], e)
# ---------------------------------------------------------------------------

# Finite stand-in for -inf in the max accumulators (the reference's): -inf
# would turn the empty-row fix-up into inf - inf under autodiff.
NEG_INF = -3.0e38


def gspmm_combine(u: torch.Tensor, e: torch.Tensor | None,
                  op: str) -> torch.Tensor:
    """The per-edge combine ``op(u, e)``: ``u`` the gathered B rows, ``e``
    the edge value, a scalar broadcast over the features or a ``d_e ==
    n_b`` vector. ``copy_lhs`` ignores ``e``."""
    if op == "copy_lhs":
        return u
    ef = e.float()
    if ef.dim() < u.dim():
        ef = ef[..., None]
    if op == "mul":
        return u * ef
    if op == "add":
        return u + ef
    raise ValueError(f"unknown g-SpMM op {op!r}")


def _slots_below(bound: torch.Tensor, slots: int) -> torch.Tensor:
    """(batch, slots) bool: slot < bound[s]."""
    slot = torch.arange(slots, device=bound.device)
    return slot[None, :] < bound[:, None]


def _gspmm_reduce(msg, rows, keep, deg, m_out: int, reduce: str):
    """Reduce the messages ``msg`` (batch, slots, n) f32 into their rows
    ``rows`` over the slots where ``keep`` holds; ``deg`` (batch, m_out) is
    each row's degree: ``mean`` divides by max(deg, 1), and ``max`` writes
    the 0.0 identity into rows of degree 0."""
    if reduce in ("sum", "mean"):
        out = _scatter_rows(msg, rows, keep, m_out)
        if reduce == "mean":
            out = out / torch.clamp(deg.float(), min=1.0)[..., None]
        return out
    if reduce != "max":
        raise ValueError(f"unknown g-SpMM reduce {reduce!r}")
    batch, _, n = msg.shape
    idx = torch.where(keep, rows.long(), m_out)[..., None].expand(msg.shape)
    out = msg.new_full((batch, m_out + 1, n), NEG_INF)
    out.scatter_reduce_(1, idx, torch.where(keep[..., None], msg, NEG_INF),
                        "amax", include_self=True)
    return torch.where(deg[..., None] > 0, out[:, :m_out], 0.0)


def gspmm_coo_single(row_ids, col_ids, values, b, m_out: int, nnz, *,
                     op: str = "mul", reduce: str = "sum") -> torch.Tensor:
    """g-SpMM of ONE matrix: padding is masked explicitly from ``nnz`` (the
    0.0-valued padding is inert only under (mul, sum)); rows of degree 0
    take 0.0 for every reduce."""
    return _gspmm_oracle(row_ids[None], col_ids[None], values[None],
                         torch.as_tensor(nnz, device=b.device).reshape(1),
                         b[None], m_out, op, reduce)[0]


def _gspmm_oracle(row_ids, col_ids, values, nnz, b, m_out, op, reduce):
    valid = _slots_below(nnz, row_ids.shape[1])
    msg = gspmm_combine(_gather_rows(b, col_ids), values, op)
    keep = valid & _in_range(row_ids, m_out)
    deg = _scatter_rows(keep[..., None].float(), row_ids, keep, m_out)[..., 0]
    return _gspmm_reduce(msg, row_ids, keep, deg, m_out, reduce).to(b.dtype)


def batched_gspmm_ref(a: BatchedCOO, b: torch.Tensor, m_out: int, *,
                      op: str = "mul", reduce: str = "sum") -> torch.Tensor:
    """The batched g-SpMM oracle (the reference's ``batched_gspmm_ref``):
    ``C[s, r] = reduce_{valid slots i with rid = r} op(B[s, cid], e)``."""
    return _gspmm_oracle(a.row_ids, a.col_ids, a.values, a.nnz, b, m_out,
                         op, reduce)


def batched_gspmm_coo_plain(row_ids, col_ids, values, nnz, b, *,
                            op: str, reduce: str) -> torch.Tensor:
    """Plain version of the COO kernel's g-SpMM entry: slots past ``nnz[s]``
    are masked, each row's degree counts its valid slots with the row id
    clipped into ``[0, m_pad)`` (the reference kernel's wrapper), and slots
    whose ids fall outside the matrix add nothing."""
    m = b.shape[1]
    valid = _slots_below(nnz, row_ids.shape[1])
    keep = valid & _in_range(row_ids, m) & _in_range(col_ids, m)
    msg = gspmm_combine(_gather_rows(b, col_ids), values, op)
    deg = torch.zeros(row_ids.shape[0], m, device=b.device).scatter_add_(
        1, row_ids.long().clamp(0, m - 1), valid.float())
    return _gspmm_reduce(msg, row_ids, keep, deg, m, reduce).to(b.dtype)


def batched_gspmm_ell_ref(a: BatchedELL, rlen: torch.Tensor, b: torch.Tensor,
                          *, op: str = "mul",
                          reduce: str = "sum") -> torch.Tensor:
    """Row-split g-SpMM over the ELL layout: slot k of row r is live while
    ``k < rlen[r]`` (the ELL layout cannot tell a real 0.0 edge from
    padding, so the live bound travels beside it)."""
    return batched_gspmm_ell_plain(a.col_ids, a.values, rlen, b, op=op,
                                   reduce=reduce)


def batched_gspmm_ell_plain(col_ids, values, rlen, b, *, op: str,
                            reduce: str) -> torch.Tensor:
    """Plain version of the ELL kernel's g-SpMM entry, on its raw
    operands."""
    batch, m_pad, k_pad = col_ids.shape
    u = _gather_rows(b, col_ids.reshape(batch, m_pad * k_pad))
    msg = gspmm_combine(u.view(batch, m_pad, k_pad, -1), values, op)
    live = ((torch.arange(k_pad, device=b.device)[None, None, :]
             < rlen[..., None]) & _in_range(col_ids, b.shape[1]))[..., None]
    if reduce in ("sum", "mean"):
        out = torch.where(live, msg, 0.0).sum(dim=2)
        if reduce == "mean":
            out = out / torch.clamp(rlen, min=1).float()[..., None]
    elif reduce == "max":
        out = torch.where(live, msg, NEG_INF).amax(dim=2)
        out = torch.where((rlen > 0)[..., None], out, 0.0)
    else:
        raise ValueError(f"unknown g-SpMM reduce {reduce!r}")
    return out.to(b.dtype)


def batched_gspmm_csr_ref(a: BatchedCSR, b: torch.Tensor, *,
                          op: str = "mul", reduce: str = "sum") -> torch.Tensor:
    """CSR g-SpMM: each slot's row from a search of ``rpt``, slots at or
    past ``rpt[-1]`` masked, the degree ``rpt[r+1] - rpt[r]``."""
    return batched_gspmm_csr_plain(a.rpt, a.col_ids, a.values, b, op=op,
                                   reduce=reduce)


def batched_gspmm_csr_plain(rpt, col_ids, values, b, *, op: str,
                            reduce: str) -> torch.Tensor:
    """Plain version of the CSR kernel's g-SpMM entry, on its raw
    operands."""
    nnz_pad = col_ids.shape[1]
    keep = (_slots_below(rpt[:, -1], nnz_pad)
            & _in_range(col_ids, b.shape[1]))
    msg = gspmm_combine(_gather_rows(b, col_ids), values, op)
    return _gspmm_reduce(msg, csr_slot_rows(rpt, nnz_pad), keep,
                         rpt[:, 1:] - rpt[:, :-1], b.shape[1],
                         reduce).to(b.dtype)


def grouped_matmul_ref(x: torch.Tensor, group_ids: torch.Tensor,
                       w: torch.Tensor) -> torch.Tensor:
    """``out[i] = x[i] @ w[group_ids[i]]`` — the ragged grouped matmul, and
    the plain version of the grouped-matmul kernel. One product per group
    (no (M, K, N) gather of the weights); a row whose group id lies outside
    ``[0, E)`` gets 0."""
    out = x.new_zeros((x.shape[0], w.shape[-1]))
    for g in range(w.shape[0]):
        out = torch.where((group_ids == g)[:, None], x @ w[g], out)
    return out


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
    # f32 until the one rounding to B's type at the end
    acc = _coo_product(torch.where(keep, q, m_pad), cid, val, None,
                       b.float(), m_pad)
    if slab is not None:
        d_pad = slab.shape[1]
        acc[:, :d_pad] += torch.einsum("bdm,bmn->bdn", slab.float(),
                                       b.float())
    out = torch.gather(acc, 1, rank.long()[..., None].expand(-1, -1,
                                                             acc.shape[-1]))
    return out.to(b.dtype)


def fused_graph_conv_plain(row_ids, col_ids, values, chunks, x, w, bias,
                           residual=None, epilogue: str = "none", rank=None,
                           slab=None, hubs=None):
    """Plain version of the fused layer kernel:
    ``Y = epi(Σ_ch A_ch·(X·W_ch + b_ch) [+ residual])``, each channel's
    scatter over its first ``chunks[s, ch] · CHUNK`` slots (the reference's
    skew-aware bound). Ids are ``(batch, channels, nnz_pad)``.

    The hybrid branch (``rank`` (batch, m_pad) and ``slab`` (batch,
    channels, d_pad, m_pad), both or neither), in the reference's order:
    the scatter lands in degree-sorted rows (the row ids are sorted
    positions), the head ``Σ_ch slab_ch·U_ch`` is added to rows
    ``[0, d_pad)``, ``acc[rank[r]]`` restores the original row order, then
    the residual and ReLU. ``hubs`` (batch,), when given, keeps each
    sample's first ``hubs[s]`` slab rows only (the kernel's head bound)."""
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
        sl = slab.float()
        if hubs is not None:
            keep = torch.arange(d_pad, device=sl.device) < hubs[:, None]
            sl = sl * keep[:, None, :, None]
        y[:, :d_pad] += torch.einsum(
            "bcdm,bcmf->bdf", sl,
            u.view(batch, channels, m_pad, n_out))
        y = torch.gather(y, 1, rank.long()[..., None].expand(-1, -1, n_out))
    if residual is not None:
        y = y + residual.float()
    if epilogue == "relu":
        y = torch.relu(y)
    return y.to(x.dtype)


FLASH_NEG_INF = -1e30                 # the reference flash kernel's NEG_INF


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          kv_block: int = 64) -> torch.Tensor:
    """Plain version of the flash-attention kernel: the reference kernel's
    blocked online softmax over ``kv_block``-key tiles from position 0, for
    every query row at once (the q tiling does not change a row's
    arithmetic). q (B, Tq, H, hd), k and v (B, Tk, KV, hd) → q's shape and
    type; widened to f32, masked scores ``FLASH_NEG_INF``, p kept in f32,
    ``acc / max(l, 1e-20)``."""
    b, tq, h, hd = q.shape
    tk = k.shape[1]
    groups = h // k.shape[2]
    scale = hd ** -0.5
    kv_block = max(1, min(kv_block, tk))
    qf = q.float().transpose(1, 2)                          # (B, H, Tq, hd)
    kf = k.float().repeat_interleave(groups, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(groups, dim=2).transpose(1, 2)
    qpos = torch.arange(tq, device=q.device)[:, None]
    acc = torch.zeros((b, h, tq, hd), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, tq), FLASH_NEG_INF, device=q.device)
    l = torch.zeros((b, h, tq), device=q.device)
    for k0 in range(0, tk, kv_block):
        kpos = torch.arange(k0, min(k0 + kv_block, tk), device=q.device)
        s = (qf @ kf[:, :, k0:k0 + kv_block].transpose(-1, -2)) * scale
        mask = torch.ones((tq, kpos.numel()), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos
        if window:
            mask &= kpos[None, :] > qpos - window
        s = torch.where(mask, s, FLASH_NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + p @ vf[:, :, k0:k0 + kv_block]
        m = m_new
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.transpose(1, 2).to(q.dtype).contiguous()
