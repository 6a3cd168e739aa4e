"""Batched CSR SpMM — the paper's batched SWA-SpMM for CSR on flat CSR
arrays (row split, no atomics):
``C[s, r, :] = Σ_{rpt[r] ≤ k < rpt[r+1]} val[s, k] · B[s, cid[s, k], :]``.

The kernel is ``csrc/batched_spmm_csr.cu`` (one block per matrix × column
panel, the B panel staged in shared memory, a sub-warp per output row that
walks that row's own slots); the plain version is
:func:`repro_torch.kernels.ref.batched_spmm_csr_plain`. f32, (mul, sum).
Without atomics its result is bitwise the same from run to run.
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


def batched_spmm_csr(rpt: torch.Tensor, col_ids: torch.Tensor,
                     values: torch.Tensor, b: torch.Tensor, *,
                     plan: BatchPlan | None = None) -> torch.Tensor:
    """rpt (batch, m_pad + 1) int32, col_ids/values (batch, nnz_pad)
    int32/f32 (row-sorted, as :func:`repro_torch.core.formats.coo_to_csr`
    leaves them), b (batch, m_pad, n_b) f32 → (batch, m_pad, n_b) f32."""
    if b.dim() != 3 or rpt.dim() != 2 or col_ids.dim() != 2:
        raise ValueError("batched_spmm_csr takes 2-D rpt and ids and a 3-D b")
    batch, m_pad, n_b = b.shape
    nnz_pad = col_ids.shape[1]
    check_operand("rpt", rpt, (batch, m_pad + 1), torch.int32)
    check_operand("col_ids", col_ids, (batch, nnz_pad), torch.int32)
    check_operand("values", values, (batch, nnz_pad), torch.float32)
    check_operand("b", b, (batch, m_pad, n_b), torch.float32)
    plan = plan or plan_batched_spmm(batch=batch, m_pad=m_pad, n_b=n_b)
    check_plan(plan, batch=batch, m_pad=m_pad, n_b=n_b)
    if on_cpu(rpt, col_ids, values, b):
        return ref.batched_spmm_csr_plain(rpt, col_ids, values, b)
    out = torch.empty_like(b)
    if out.numel() == 0:
        return out
    fn = _build.entry("batched_spmm_csr", "batched_spmm_csr_f32", _ARGTYPES)
    code = fn(rpt.data_ptr(), col_ids.data_ptr(), values.data_ptr(),
              b.data_ptr(), out.data_ptr(), batch, m_pad, nnz_pad, n_b,
              plan.n_block, stream_handle())
    _build.check("batched_spmm_csr", code)
    batched_spmm_csr.launches += 1
    return out


batched_spmm_csr.launches = 0
