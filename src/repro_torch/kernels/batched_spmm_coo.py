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

g-SpMM (the reference kernel's ``nnz``/``op``/``reduce`` operands): given
the per-matrix true ``nnz``, another ``(op, reduce)`` or vector edges
``(batch, nnz_pad, n_b)``, the wrapper launches the kernel's g-SpMM entry,
which masks slots past ``nnz[s]`` and finishes ``mean`` and the empty rows
of ``max`` itself; its plain version is
:func:`repro_torch.kernels.ref.batched_gspmm_coo_plain`. The g-SpMM plan
takes :func:`gspmm_plan`: the block also counts row degrees in shared
memory.
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
_ARGTYPES = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)
_GSPMM_ARGTYPES = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                   _P)


def gspmm_plan(*, batch: int, m_pad: int, n_b: int) -> BatchPlan:
    """The g-SpMM entry's plan: the output panel plus ``m_pad`` int32 row
    degrees in one block's shared memory."""
    return plan_batched_spmm(batch=batch, m_pad=m_pad, n_b=n_b,
                             fixed_bytes=4 * m_pad)


def batched_spmm_coo(row_ids: torch.Tensor, col_ids: torch.Tensor,
                     values: torch.Tensor, b: torch.Tensor, *,
                     plan: BatchPlan | None = None,
                     nnz: torch.Tensor | None = None, op: str = "mul",
                     reduce: str = "sum") -> torch.Tensor:
    """row_ids/col_ids (batch, nnz_pad) int32, values (batch, nnz_pad) f32,
    b (batch, m_pad, n_b) f32 → (batch, m_pad, n_b) f32. For g-SpMM also
    ``nnz`` (batch,) int32, which any ``(op, reduce)`` other than (mul,
    sum) and vector values (batch, nnz_pad, n_b) need."""
    if b.dim() != 3 or row_ids.dim() != 2:
        raise ValueError("batched_spmm_coo takes 2-D ids and a 3-D b")
    batch, nnz_pad = row_ids.shape
    m_pad, n_b = b.shape[1], b.shape[2]
    gspmm = nnz is not None or (op, reduce) != ("mul", "sum") \
        or values.dim() == 3
    if gspmm and nnz is None:
        raise ValueError(f"g-SpMM ({op}, {reduce}) needs the per-matrix "
                         "true nnz for masking")
    check_operand("row_ids", row_ids, (batch, nnz_pad), torch.int32)
    check_operand("col_ids", col_ids, (batch, nnz_pad), torch.int32)
    check_operand("values", values, (batch, nnz_pad) + (
        (n_b,) if values.dim() == 3 else ()), torch.float32)
    check_operand("b", b, (batch, m_pad, n_b), torch.float32)
    if gspmm:
        check_operand("nnz", nnz, (batch,), torch.int32)
        plan = plan or gspmm_plan(batch=batch, m_pad=m_pad, n_b=n_b)
    plan = plan or plan_batched_spmm(batch=batch, m_pad=m_pad, n_b=n_b)
    check_plan(plan, batch=batch, m_pad=m_pad, n_b=n_b)
    if on_cpu(row_ids, col_ids, values, b, nnz):
        if gspmm:
            return ref.batched_gspmm_coo_plain(row_ids, col_ids, values, nnz,
                                               b, op=op, reduce=reduce)
        return ref.batched_spmm_coo_plain(row_ids, col_ids, values, b)
    out = torch.empty_like(b)
    if out.numel() == 0:
        return out
    if gspmm:
        fn = _build.entry("batched_spmm_coo", "batched_gspmm_coo_f32",
                          _GSPMM_ARGTYPES)
        code = fn(row_ids.data_ptr(), col_ids.data_ptr(), values.data_ptr(),
                  nnz.data_ptr(), b.data_ptr(), out.data_ptr(), batch,
                  nnz_pad, m_pad, n_b, plan.n_block, *gspmm_codes(op, reduce),
                  int(values.dim() == 3), stream_handle())
    else:
        fn = _build.entry("batched_spmm_coo", "batched_spmm_coo_f32",
                          _ARGTYPES)
        code = fn(row_ids.data_ptr(), col_ids.data_ptr(), values.data_ptr(),
                  b.data_ptr(), out.data_ptr(), batch, nnz_pad, m_pad, n_b,
                  plan.n_block, stream_handle())
    _build.check("batched_spmm_coo", code)
    batched_spmm_coo.launches += 1
    return out


batched_spmm_coo.launches = 0
