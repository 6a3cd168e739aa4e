"""Batched ELL SpMM — the paper's batched SWA-SpMM for CSR (row split, no
atomics): ``C[s, r, :] = Σ_k val[s, r, k] · B[s, cid[s, r, k], :]``.

The kernel is ``csrc/batched_spmm_ell.cu`` (one block per matrix × column
panel, the B panel staged in shared memory, a sub-warp per output row); the
plain version is :func:`repro_torch.kernels.ref.batched_spmm_ell_plain`.
f32, (mul, sum). It runs forwards only: Aᵀ has no per-row bound, so the
backward of ``pallas_ell`` runs the COO kernel.

g-SpMM (the reference kernel's ``rlen``/``op``/``reduce`` operands): given
the row degrees ``rlen`` (batch, m_pad) — the layout cannot tell a real 0.0
edge from padding — another ``(op, reduce)`` or vector edges (batch, m_pad,
k_pad, n_b), the wrapper launches the kernel's g-SpMM entry, whose plain
version is :func:`repro_torch.kernels.ref.batched_gspmm_ell_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.batching import BatchPlan, plan_batched_spmm
from repro_torch.kernels import (
    _build,
    check_operand,
    check_plan,
    gspmm_codes,
    on_cpu,
    ref,
    stream_handle,
)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P)
_GSPMM_ARGTYPES = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P)


def batched_spmm_ell(col_ids: torch.Tensor, values: torch.Tensor,
                     b: torch.Tensor, *, plan: BatchPlan | None = None,
                     rlen: torch.Tensor | None = None, op: str = "mul",
                     reduce: str = "sum") -> torch.Tensor:
    """col_ids (batch, m_pad, k_pad) int32, values (batch, m_pad, k_pad)
    f32, b (batch, m_pad, n_b) f32 → (batch, m_pad, n_b) f32. For g-SpMM
    also ``rlen`` (batch, m_pad) int32, which any ``(op, reduce)`` other
    than (mul, sum) and vector values (batch, m_pad, k_pad, n_b) need."""
    if b.dim() != 3 or col_ids.dim() != 3:
        raise ValueError("batched_spmm_ell takes 3-D col_ids and b")
    batch, m_pad, k_pad = col_ids.shape
    n_b = b.shape[-1]
    gspmm = rlen is not None or (op, reduce) != ("mul", "sum") \
        or values.dim() == 4
    if gspmm and rlen is None:
        raise ValueError(f"g-SpMM ({op}, {reduce}) needs the per-row live "
                         "bound rlen")
    check_operand("col_ids", col_ids, (batch, m_pad, k_pad), torch.int32)
    check_operand("values", values, (batch, m_pad, k_pad) + (
        (n_b,) if values.dim() == 4 else ()), torch.float32)
    check_operand("b", b, (batch, m_pad, n_b), torch.float32)
    if gspmm:
        check_operand("rlen", rlen, (batch, m_pad), torch.int32)
    plan = plan or plan_batched_spmm(batch=batch, m_pad=m_pad, n_b=n_b)
    check_plan(plan, batch=batch, m_pad=m_pad, n_b=n_b)
    if on_cpu(col_ids, values, b, rlen):
        if gspmm:
            return ref.batched_gspmm_ell_plain(col_ids, values, rlen, b,
                                               op=op, reduce=reduce)
        return ref.batched_spmm_ell_plain(col_ids, values, b)
    out = torch.empty_like(b)
    if out.numel() == 0:
        return out
    if gspmm:
        fn = _build.entry("batched_spmm_ell", "batched_gspmm_ell_f32",
                          _GSPMM_ARGTYPES)
        code = fn(col_ids.data_ptr(), values.data_ptr(), rlen.data_ptr(),
                  b.data_ptr(), out.data_ptr(), batch, m_pad, k_pad, n_b,
                  plan.n_block, *gspmm_codes(op, reduce),
                  int(values.dim() == 4), stream_handle())
    else:
        fn = _build.entry("batched_spmm_ell", "batched_spmm_ell_f32",
                          _ARGTYPES)
        code = fn(col_ids.data_ptr(), values.data_ptr(), b.data_ptr(),
                  out.data_ptr(), batch, m_pad, k_pad, n_b, plan.n_block,
                  stream_handle())
    _build.check("batched_spmm_ell", code)
    batched_spmm_ell.launches += 1
    return out


batched_spmm_ell.launches = 0
