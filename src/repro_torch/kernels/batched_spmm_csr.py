"""Batched CSR SpMM — the paper's batched SWA-SpMM for CSR on flat CSR
arrays (row split, no atomics):
``C[s, r, :] = Σ_{rpt[r] ≤ k < rpt[r+1]} val[s, k] · B[s, cid[s, k], :]``.

The kernel is ``csrc/batched_spmm_csr.cu`` (a sub-warp per output row that
walks that row's own slots and gathers B through the L2, blocks of rows ×
column panels); the plain version is
:func:`repro_torch.kernels.ref.batched_spmm_csr_plain`. f32, (mul, sum).
Without atomics its result is bitwise the same from run to run.

g-SpMM (the reference kernel's ``op``/``reduce`` operands): another
``(op, reduce)`` or vector edges ``(batch, nnz_pad, n_b)`` in the CSR sort
order launch the kernel's g-SpMM entry, whose plain version is
:func:`repro_torch.kernels.ref.batched_gspmm_csr_plain`; each row's slot
range is its mask, so no ``nnz`` is needed.

Reduced precision (the reference kernel's int16 / bf16 / int8 branches):
:func:`batched_spmm_csr_bf16` takes int16 column ids, bf16 values and a
bf16 B and returns bf16; :func:`batched_spmm_csr_i8` takes int16 column
ids, int8 codes, their per-matrix f32 ``scale`` and an f32 B and returns
f32. ``rpt`` stays int32. Both sum in f32 without atomics (identical bits
from run to run); their plain version is the same
:func:`ref.batched_spmm_csr_plain`. Each entry counts its own launches.

Large-matrix entries (paper case 3, where the reference takes its plain
per-sample path): :func:`batched_spmm_csr_large` (f32 and g-SpMM),
:func:`batched_spmm_csr_large_bf16` and :func:`batched_spmm_csr_large_i8`
take the same operands and any plan, case 3 included, and launch the same
kernel entries, which stage nothing in shared memory and so take matrices
of any size. The bf16 and i8 ones also take int32 column ids, for
``m_pad`` past int16's range. Same plain versions, own counters, so that a
caller can tell the case-3 route from the batched one. The hybrid impls
run here at case 3 (``kernels/ops``).
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
_GSPMM_ARGTYPES = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P)
# the bf16 and i8 entries take ids32 before the stream
_BF16_ARGTYPES = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)
_I8_ARGTYPES = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)


def batched_spmm_csr(rpt: torch.Tensor, col_ids: torch.Tensor,
                     values: torch.Tensor, b: torch.Tensor, *,
                     plan: BatchPlan | None = None, op: str = "mul",
                     reduce: str = "sum") -> torch.Tensor:
    """rpt (batch, m_pad + 1) int32, col_ids/values (batch, nnz_pad)
    int32/f32 (row-sorted, as :func:`repro_torch.core.formats.coo_to_csr`
    leaves them; vector values (batch, nnz_pad, n_b)), b (batch, m_pad,
    n_b) f32 → (batch, m_pad, n_b) f32."""
    return _f32(batched_spmm_csr, False, rpt, col_ids, values, b, plan, op,
                reduce)


def batched_spmm_csr_large(rpt: torch.Tensor, col_ids: torch.Tensor,
                           values: torch.Tensor, b: torch.Tensor, *,
                           plan: BatchPlan | None = None, op: str = "mul",
                           reduce: str = "sum") -> torch.Tensor:
    """:func:`batched_spmm_csr` at any plan, planner case 3 included,
    counted apart."""
    return _f32(batched_spmm_csr_large, True, rpt, col_ids, values, b, plan,
                op, reduce)


def _f32(counted, large: bool, rpt, col_ids, values, b, plan, op, reduce):
    """The f32 and g-SpMM entries, batched or large (which only the plan
    check tells apart): checks, then the plain version on CPU tensors or
    the kernel, counted in ``counted``."""
    if b.dim() != 3 or rpt.dim() != 2 or col_ids.dim() != 2:
        raise ValueError("batched_spmm_csr takes 2-D rpt and ids and a 3-D b")
    batch, m_pad, n_b = b.shape
    nnz_pad = col_ids.shape[1]
    gspmm = (op, reduce) != ("mul", "sum") or values.dim() == 3
    check_operand("rpt", rpt, (batch, m_pad + 1), torch.int32)
    check_operand("col_ids", col_ids, (batch, nnz_pad), torch.int32)
    check_operand("values", values, (batch, nnz_pad) + (
        (n_b,) if values.dim() == 3 else ()), torch.float32)
    check_operand("b", b, (batch, m_pad, n_b), torch.float32)
    plan = plan or plan_batched_spmm(batch=batch, m_pad=m_pad, n_b=n_b)
    check_plan(plan, batch=batch, m_pad=m_pad, n_b=n_b, large=large)
    if on_cpu(rpt, col_ids, values, b):
        if gspmm:
            return ref.batched_gspmm_csr_plain(rpt, col_ids, values, b,
                                               op=op, reduce=reduce)
        return ref.batched_spmm_csr_plain(rpt, col_ids, values, b)
    out = torch.empty_like(b)
    if out.numel() == 0:
        return out
    if gspmm:
        fn = _build.entry("batched_spmm_csr", "batched_gspmm_csr_f32",
                          _GSPMM_ARGTYPES)
        code = fn(rpt.data_ptr(), col_ids.data_ptr(), values.data_ptr(),
                  b.data_ptr(), out.data_ptr(), batch, m_pad, nnz_pad, n_b,
                  plan.n_block, *gspmm_codes(op, reduce),
                  int(values.dim() == 3), stream_handle())
    else:
        fn = _build.entry("batched_spmm_csr", "batched_spmm_csr_f32",
                          _ARGTYPES)
        code = fn(rpt.data_ptr(), col_ids.data_ptr(), values.data_ptr(),
                  b.data_ptr(), out.data_ptr(), batch, m_pad, nnz_pad, n_b,
                  plan.n_block, stream_handle())
    _build.check("batched_spmm_csr", code)
    counted.launches += 1
    return out


batched_spmm_csr.launches = 0
batched_spmm_csr_large.launches = 0


def _reduced(counted, rpt: torch.Tensor, col_ids: torch.Tensor,
             values: torch.Tensor, scale: torch.Tensor | None,
             b: torch.Tensor, plan: BatchPlan | None,
             large: bool = False) -> torch.Tensor:
    """The bf16 (``scale`` None) or i8 entry, batched or large: checks, then
    the plain version on CPU tensors or the kernel, counted in
    ``counted``. The large entries also take int32 column ids."""
    if b.dim() != 3 or rpt.dim() != 2 or col_ids.dim() != 2:
        raise ValueError(f"{counted.__name__} takes 2-D rpt and ids and a "
                         "3-D b")
    batch, m_pad, n_b = b.shape
    nnz_pad = col_ids.shape[1]
    i8 = scale is not None
    ids32 = large and col_ids.dtype == torch.int32
    check_operand("rpt", rpt, (batch, m_pad + 1), torch.int32)
    check_operand("col_ids", col_ids, (batch, nnz_pad),
                  torch.int32 if ids32 else torch.int16)
    check_operand("values", values, (batch, nnz_pad),
                  torch.int8 if i8 else torch.bfloat16)
    check_operand("b", b, (batch, m_pad, n_b),
                  torch.float32 if i8 else torch.bfloat16)
    if i8:
        check_operand("scale", scale, (batch,), torch.float32)
    plan = plan or plan_batched_spmm(batch=batch, m_pad=m_pad, n_b=n_b,
                                     itemsize=b.element_size())
    check_plan(plan, batch=batch, m_pad=m_pad, n_b=n_b, large=large)
    if on_cpu(rpt, col_ids, values, scale, b):
        return ref.batched_spmm_csr_plain(rpt, col_ids, values, b, scale)
    out = torch.empty_like(b)
    if out.numel() == 0:
        return out
    fn = _build.entry("batched_spmm_csr",
                      "batched_spmm_csr_i8" if i8 else "batched_spmm_csr_bf16",
                      _I8_ARGTYPES if i8 else _BF16_ARGTYPES)
    code = fn(rpt.data_ptr(), col_ids.data_ptr(), values.data_ptr(),
              *([scale.data_ptr()] if i8 else []), b.data_ptr(),
              out.data_ptr(), batch, m_pad, nnz_pad, n_b, plan.n_block,
              int(ids32), stream_handle())
    _build.check("batched_spmm_csr", code)
    counted.launches += 1
    return out


def batched_spmm_csr_bf16(rpt: torch.Tensor, col_ids: torch.Tensor,
                          values: torch.Tensor, b: torch.Tensor, *,
                          plan: BatchPlan | None = None) -> torch.Tensor:
    """rpt (batch, m_pad + 1) int32, col_ids (batch, nnz_pad) int16, values
    bf16 (row-sorted), b (batch, m_pad, n_b) bf16 → bf16: f32 sums rounded
    to bf16 once."""
    return _reduced(batched_spmm_csr_bf16, rpt, col_ids, values, None, b,
                    plan)


def batched_spmm_csr_i8(rpt: torch.Tensor, col_ids: torch.Tensor,
                        codes: torch.Tensor, scale: torch.Tensor,
                        b: torch.Tensor, *,
                        plan: BatchPlan | None = None) -> torch.Tensor:
    """rpt int32, col_ids (batch, nnz_pad) int16, codes int8 (row-sorted),
    scale (batch,) f32, b (batch, m_pad, n_b) f32 → f32: each f32 sum times
    its matrix's scale."""
    return _reduced(batched_spmm_csr_i8, rpt, col_ids, codes, scale, b,
                    plan)


def batched_spmm_csr_large_bf16(rpt: torch.Tensor, col_ids: torch.Tensor,
                                values: torch.Tensor, b: torch.Tensor, *,
                                plan: BatchPlan | None = None
                                ) -> torch.Tensor:
    """:func:`batched_spmm_csr_bf16` at any plan, counted apart; int16 or
    int32 column ids."""
    return _reduced(batched_spmm_csr_large_bf16, rpt, col_ids, values, None,
                    b, plan, large=True)


def batched_spmm_csr_large_i8(rpt: torch.Tensor, col_ids: torch.Tensor,
                              codes: torch.Tensor, scale: torch.Tensor,
                              b: torch.Tensor, *,
                              plan: BatchPlan | None = None) -> torch.Tensor:
    """:func:`batched_spmm_csr_i8` at any plan, counted apart; int16 or
    int32 column ids."""
    return _reduced(batched_spmm_csr_large_i8, rpt, col_ids, codes, scale, b,
                    plan, large=True)


batched_spmm_csr_bf16.launches = 0
batched_spmm_csr_i8.launches = 0
batched_spmm_csr_large_bf16.launches = 0
batched_spmm_csr_large_i8.launches = 0
