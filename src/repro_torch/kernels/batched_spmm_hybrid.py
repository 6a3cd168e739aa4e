"""Degree-binned hybrid SpMM: hub rows as a dense slab, the rest as a CSR
remainder, the inverse row permutation in the epilogue.

Per matrix, rows are stably sorted by descending degree. A row with
``deg >= plan.dmin`` is a hub: its non-zeros go to a dense ``(d_pad, m_pad)``
slab whose product with B replaces a long slot loop; every other row keeps
its CSR slots, at most ``dmin - 1`` of them. The flat CSR arrays stay in
row order; only the per-row ``start``/``rlen`` pointers are permuted, and
hub rows get ``rlen = 0``, so no non-zero is counted twice.
``out[r] = acc[rank[r]]`` returns the rows in their original order.

The kernel is ``csrc/batched_spmm_hybrid.cu``; the operands are prepared
by :func:`hybrid_operands` in PyTorch ops on the tensors' device (the
reference leaves that prep to XLA), and the plain version is
:func:`repro_torch.kernels.ref.batched_spmm_hybrid_plain`.
:func:`batched_spmm_hybrid_ref` is the registry's plain ``hybrid`` entry:
the same split as a slab product plus an ELL remainder of width
``dmin - 1``. f32, (mul, sum); the kernel's result is bitwise the same from
run to run (no atomics).

:func:`batched_spmm_hybrid_bf16` is the reference kernel's bf16 branch
(``pallas_hybrid_bf16``): bf16 values, slab and B, the CSR column ids
narrowed to int16 after the prep, f32 sums rounded to bf16 once. It counts
its own launches; :func:`hybrid_launch` takes either type.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.batching import HybridPlan
from repro_torch.core.formats import (
    BatchedCOO,
    coo_to_csr,
    coo_to_ell,
    narrow_col_ids,
    row_degrees,
)
from repro_torch.kernels import (
    _build,
    check_operand,
    check_plan,
    on_cpu,
    ref,
    stream_handle,
)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P,) * 8 + (_I,) * 6 + (_P,)


def hub_slab(d_pad: int, m_pad: int, pos, hub, cid, val) -> torch.Tensor:
    """``slab[..., pos, cid] += val`` over the slots where ``hub`` holds, the
    rest sent to a dump row ``d_pad`` that is cut off. pos/hub/cid/val are
    (lead, slots) → (lead, d_pad, m_pad) in ``val``'s dtype."""
    lead, slots = pos.shape
    ok = hub & (cid >= 0) & (cid < m_pad)
    d = torch.where(ok, pos, d_pad).long()
    slab = torch.zeros((lead, d_pad + 1, m_pad), dtype=val.dtype,
                       device=val.device)
    s = torch.arange(lead, device=val.device)[:, None].expand(lead, slots)
    slab.index_put_((s, d, torch.where(ok, cid, 0).long()),
                    torch.where(ok, val, 0), accumulate=True)
    return slab[:, :d_pad].contiguous()


def hybrid_operands(row_ids, col_ids, values, nnz, m_pad: int,
                    plan: HybridPlan):
    """Sort and classify one batch, on the tensors' device and without
    reading anything back to the host. Returns the reference's operands
    less its per-bin loop bounds ``rowmax_bins``, which the CUDA kernel
    does not need (it bounds each row by its own length):
    ``(rank, start_s, rlen_sparse, cid_flat, val_flat, slab)``:

    - ``rank[b, r]``: row r's position in matrix b's descending-degree order;
    - ``start_s``/``rlen_sparse``: the CSR row pointers in sorted order, hub
      rows' lengths zeroed;
    - ``cid_flat``/``val_flat``: the CSR arrays in row order;
    - ``slab``: the ``(batch, d_pad, m_pad)`` hub rows, or None when
      ``plan.d_pad == 0``.
    """
    batch = row_ids.shape[0]
    a = BatchedCOO(row_ids, col_ids, values, nnz,
                   torch.full((batch,), m_pad, dtype=torch.int32,
                              device=row_ids.device))
    deg = row_degrees(a, m_pad)
    perm = torch.argsort(-deg, dim=1, stable=True)       # sorted -> original
    rank = torch.argsort(perm, dim=1, stable=True).to(torch.int32)
    csr = coo_to_csr(a, m_pad)
    start = csr.rpt[:, :-1]
    rlen = csr.rpt[:, 1:] - start
    start_s = torch.gather(start, 1, perm)
    rlen_s = torch.gather(rlen, 1, perm)
    # a stable descending sort puts exactly the hubs first
    n_dense = (deg >= plan.dmin).sum(dim=1).clamp(max=plan.d_pad)
    pos_iota = torch.arange(m_pad, device=deg.device)[None, :]
    rlen_sparse = torch.where(pos_iota < n_dense[:, None], 0, rlen_s)
    slab = None
    if plan.d_pad:
        pos = torch.gather(rank, 1, row_ids.long().clamp(0, m_pad - 1))
        slot = torch.arange(row_ids.shape[1], device=row_ids.device)
        hub = (slot[None, :] < nnz[:, None]) & (pos < n_dense[:, None])
        slab = hub_slab(plan.d_pad, m_pad, pos, hub, col_ids, values)
    return rank, start_s, rlen_sparse, csr.col_ids, csr.values, slab


def _hybrid(row_ids, col_ids, values, nnz, b, plan: HybridPlan,
            bf16: bool) -> torch.Tensor:
    """Checks, the prep, then the plain version on CPU tensors or the
    kernel; ``bf16`` narrows the prepared column ids to int16."""
    if b.dim() != 3 or row_ids.dim() != 2:
        raise ValueError("batched_spmm_hybrid takes 2-D ids and a 3-D b")
    batch, m_pad, n_b = b.shape
    nnz_pad = row_ids.shape[1]
    dt = torch.bfloat16 if bf16 else torch.float32
    for name, t, want in (("row_ids", row_ids, torch.int32),
                          ("col_ids", col_ids, torch.int32),
                          ("values", values, dt)):
        check_operand(name, t, (batch, nnz_pad), want)
    check_operand("nnz", nnz, (batch,), torch.int32)
    check_operand("b", b, (batch, m_pad, n_b), dt)
    check_plan(plan.spmm, batch=batch, m_pad=m_pad, n_b=n_b)
    cpu = on_cpu(row_ids, col_ids, values, nnz, b)
    rank, start_s, rlen_sp, cid, val, slab = hybrid_operands(
        row_ids, col_ids, values, nnz, m_pad, plan)
    if bf16:
        cid = narrow_col_ids(cid, m_pad)
    if cpu:
        return ref.batched_spmm_hybrid_plain(rank, start_s, rlen_sp, cid, val,
                                             slab, b)
    return hybrid_launch(rank, start_s, rlen_sp, cid, val, slab, b,
                         plan=plan)


def batched_spmm_hybrid(row_ids: torch.Tensor, col_ids: torch.Tensor,
                        values: torch.Tensor, nnz: torch.Tensor,
                        b: torch.Tensor, *, plan: HybridPlan) -> torch.Tensor:
    """ids/values (batch, nnz_pad) int32/f32, nnz (batch,) int32, b
    (batch, m_pad, n_b) f32 → (batch, m_pad, n_b) f32, with ``m_pad`` a
    multiple of 8 (the plan's, as in the reference)."""
    return _hybrid(row_ids, col_ids, values, nnz, b, plan, bf16=False)


def batched_spmm_hybrid_bf16(row_ids: torch.Tensor, col_ids: torch.Tensor,
                             values: torch.Tensor, nnz: torch.Tensor,
                             b: torch.Tensor, *,
                             plan: HybridPlan) -> torch.Tensor:
    """ids (batch, nnz_pad) int32, values bf16, nnz (batch,) int32, b
    (batch, m_pad, n_b) bf16 → bf16; the plan sized for a bf16 B panel."""
    return _hybrid(row_ids, col_ids, values, nnz, b, plan, bf16=True)


def hybrid_launch(rank, start_s, rlen_sparse, cid, val, slab, b, *,
                  plan: HybridPlan) -> torch.Tensor:
    """Launch the hybrid kernel on prepared operands (those of
    :func:`hybrid_operands`, all on the current CUDA device): the f32 entry
    for f32 values, slab and B with int32 column ids, the bf16 entry for
    bf16 ones with int16 column ids."""
    batch, m_pad, n_b = b.shape
    nnz_pad = cid.shape[1]
    bf16 = val.dtype == torch.bfloat16
    dt = torch.bfloat16 if bf16 else torch.float32
    for name, t in (("rank", rank), ("start_s", start_s),
                    ("rlen_sparse", rlen_sparse)):
        check_operand(name, t, (batch, m_pad), torch.int32)
    check_operand("cid", cid, (batch, nnz_pad),
                  torch.int16 if bf16 else torch.int32)
    check_operand("val", val, (batch, nnz_pad), dt)
    check_operand("b", b, (batch, m_pad, n_b), dt)
    if (slab is None) != (plan.d_pad == 0):
        raise ValueError(f"slab must be given exactly when d_pad > 0 ({plan})")
    if slab is not None:
        check_operand("slab", slab, (batch, plan.d_pad, m_pad), dt)
    check_plan(plan.spmm, batch=batch, m_pad=m_pad, n_b=n_b)
    if on_cpu(rank, start_s, rlen_sparse, cid, val, slab, b):
        raise ValueError("hybrid_launch takes CUDA tensors")
    out = torch.empty_like(b)
    if out.numel() == 0:
        return out
    entry = "batched_spmm_hybrid_bf16" if bf16 else "batched_spmm_hybrid_f32"
    fn = _build.entry("batched_spmm_hybrid", entry, _ARGTYPES)
    code = fn(rank.data_ptr(), start_s.data_ptr(), rlen_sparse.data_ptr(),
              cid.data_ptr(), val.data_ptr(),
              None if slab is None else slab.data_ptr(), b.data_ptr(),
              out.data_ptr(), batch, m_pad, nnz_pad, n_b, plan.spmm.n_block,
              plan.d_pad, stream_handle())
    _build.check("batched_spmm_hybrid", code)
    counted = batched_spmm_hybrid_bf16 if bf16 else batched_spmm_hybrid
    counted.launches += 1
    return out


batched_spmm_hybrid.launches = 0
batched_spmm_hybrid_bf16.launches = 0


def batched_spmm_hybrid_ref(a: BatchedCOO, b: torch.Tensor, m_pad: int, *,
                            plan: HybridPlan) -> torch.Tensor:
    """The plain ``hybrid`` registry entry (the reference's
    ``batched_spmm_hybrid_xla``): hub rows through a dense slab product,
    the rest through ELL of width ``dmin - 1``, which cannot drop a slot
    because every non-hub row has fewer than ``dmin`` non-zeros. Hub
    slots leave the ELL build through the ``m_pad`` row-id sentinel."""
    deg = row_degrees(a, m_pad)
    is_hub = deg >= plan.dmin
    rid_c = a.row_ids.long().clamp(0, m_pad - 1)
    rid_sp = torch.where(torch.gather(is_hub, 1, rid_c), m_pad, a.row_ids)
    ell = coo_to_ell(BatchedCOO(rid_sp, a.col_ids, a.values, a.nnz,
                                a.n_rows), m_pad, max(1, plan.dmin - 1))
    out = ref.batched_spmm_ell_ref(ell, b)
    if not plan.d_pad:
        return out
    # hubs first, in their original order: slab row h is hub h
    order = torch.argsort((~is_hub).to(torch.int32), dim=1, stable=True)
    inv = torch.argsort(order, dim=1, stable=True)
    n_dense = is_hub.sum(dim=1).clamp(max=plan.d_pad)
    pos = torch.gather(inv, 1, rid_c)
    slot = torch.arange(a.nnz_pad, device=b.device)
    hub = (slot[None, :] < a.nnz[:, None]) & (pos < n_dense[:, None])
    slab = hub_slab(plan.d_pad, m_pad, pos, hub, a.col_ids, a.values)
    head = torch.einsum("bdm,bmn->bdn", slab.float(), b.float())
    valid = torch.arange(plan.d_pad, device=b.device)[None, :] \
        < n_dense[:, None]
    dst = torch.where(valid, order[:, :plan.d_pad], m_pad)
    hub_out = ref._scatter_rows(head, dst, valid, m_pad)
    return (out.float() + hub_out).to(b.dtype)
