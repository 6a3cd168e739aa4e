"""Batched COO SpMM — the paper's batched SWA-SpMM for SparseTensor (split by
non-zero, shared-memory atomics): ``C[s, rid] += val · B[s, cid, :]``.

The kernel is ``csrc/batched_spmm_coo.cu`` (one block per matrix × column
panel, the output panel in shared memory, a sub-warp per non-zero with
``atomicAdd``); the plain version is
:func:`repro_torch.kernels.ref.batched_spmm_coo_plain`. f32, (mul, sum).
It also runs dB = Aᵀ·dC (ids swapped) for the ``pallas_coo``,
``pallas_ell`` and ``fused`` backwards. Every slot is visited, as in the reference: padded slots carry
0.0 and cost the kernel no atomic. Row ids outside ``[0, m_pad)`` — the
``m_pad`` sentinel — add nothing.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.batching import BatchPlan, plan_batched_spmm
from repro_torch.kernels import (
    _build,
    check_operand,
    check_plan,
    on_cpu,
    ref,
    stream_handle,
)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)


def batched_spmm_coo(row_ids: torch.Tensor, col_ids: torch.Tensor,
                     values: torch.Tensor, b: torch.Tensor, *,
                     plan: BatchPlan | None = None) -> torch.Tensor:
    """row_ids/col_ids (batch, nnz_pad) int32, values (batch, nnz_pad) f32,
    b (batch, m_pad, n_b) f32 → (batch, m_pad, n_b) f32."""
    if b.dim() != 3 or row_ids.dim() != 2:
        raise ValueError("batched_spmm_coo takes 2-D ids and a 3-D b")
    batch, nnz_pad = row_ids.shape
    m_pad, n_b = b.shape[1], b.shape[2]
    check_operand("row_ids", row_ids, (batch, nnz_pad), torch.int32)
    check_operand("col_ids", col_ids, (batch, nnz_pad), torch.int32)
    check_operand("values", values, (batch, nnz_pad), torch.float32)
    check_operand("b", b, (batch, m_pad, n_b), torch.float32)
    plan = plan or plan_batched_spmm(batch=batch, m_pad=m_pad, n_b=n_b)
    check_plan(plan, batch=batch, m_pad=m_pad, n_b=n_b)
    if on_cpu(row_ids, col_ids, values, b):
        return ref.batched_spmm_coo_plain(row_ids, col_ids, values, b)
    out = torch.empty_like(b)
    if out.numel() == 0:
        return out
    fn = _build.entry("batched_spmm_coo", "batched_spmm_coo_f32", _ARGTYPES)
    code = fn(row_ids.data_ptr(), col_ids.data_ptr(), values.data_ptr(),
              b.data_ptr(), out.data_ptr(), batch, nnz_pad, m_pad, n_b,
              plan.n_block, stream_handle())
    _build.check("batched_spmm_coo", code)
    batched_spmm_coo.launches += 1
    return out


batched_spmm_coo.launches = 0
