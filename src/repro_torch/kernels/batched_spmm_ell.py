"""Batched ELL SpMM — the paper's batched SWA-SpMM for CSR (row split, no
atomics): ``C[s, r, :] = Σ_k val[s, r, k] · B[s, cid[s, r, k], :]``.

The kernel is ``csrc/batched_spmm_ell.cu`` (one block per matrix × column
panel, the B panel staged in shared memory, a sub-warp per output row); the
plain version is :func:`repro_torch.kernels.ref.batched_spmm_ell_plain`.
f32, (mul, sum). It runs forwards only: Aᵀ has no per-row bound, so the
backward of ``pallas_ell`` runs the COO kernel.
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
_ARGTYPES = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P)


def batched_spmm_ell(col_ids: torch.Tensor, values: torch.Tensor,
                     b: torch.Tensor, *,
                     plan: BatchPlan | None = None) -> torch.Tensor:
    """col_ids (batch, m_pad, k_pad) int32, values (batch, m_pad, k_pad)
    f32, b (batch, m_pad, n_b) f32 → (batch, m_pad, n_b) f32."""
    if b.dim() != 3 or col_ids.dim() != 3:
        raise ValueError("batched_spmm_ell takes 3-D col_ids and b")
    batch, m_pad, k_pad = col_ids.shape
    n_b = b.shape[-1]
    check_operand("col_ids", col_ids, (batch, m_pad, k_pad), torch.int32)
    check_operand("values", values, (batch, m_pad, k_pad), torch.float32)
    check_operand("b", b, (batch, m_pad, n_b), torch.float32)
    plan = plan or plan_batched_spmm(batch=batch, m_pad=m_pad, n_b=n_b)
    check_plan(plan, batch=batch, m_pad=m_pad, n_b=n_b)
    if on_cpu(col_ids, values, b):
        return ref.batched_spmm_ell_plain(col_ids, values, b)
    out = torch.empty_like(b)
    if out.numel() == 0:
        return out
    fn = _build.entry("batched_spmm_ell", "batched_spmm_ell_f32", _ARGTYPES)
    code = fn(col_ids.data_ptr(), values.data_ptr(), b.data_ptr(),
              out.data_ptr(), batch, m_pad, k_pad, n_b, plan.n_block,
              stream_handle())
    _build.check("batched_spmm_ell", code)
    batched_spmm_ell.launches += 1
    return out


batched_spmm_ell.launches = 0
