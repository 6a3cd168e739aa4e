"""Batched ELL SpMM — the paper's batched SWA-SpMM for CSR (row split, no
atomics): ``C[s, r, :] = Σ_k val[s, r, k] · B[s, cid[s, r, k], :]``.

The kernel is ``csrc/batched_spmm_ell.cu`` (each matrix's rows split over
blocks, B read through the L2, a sub-warp per output row, four columns a
lane); the plain version is
:func:`repro_torch.kernels.ref.batched_spmm_ell_plain`.
f32, (mul, sum). It runs forwards only: Aᵀ has no per-row bound, so the
backward of ``pallas_ell`` runs the COO kernel.

g-SpMM (the reference kernel's ``rlen``/``op``/``reduce`` operands): given
the row degrees ``rlen`` (batch, m_pad) — the layout cannot tell a real 0.0
edge from padding — another ``(op, reduce)`` or vector edges (batch, m_pad,
k_pad, n_b), the wrapper launches the kernel's g-SpMM entry, whose plain
version is :func:`repro_torch.kernels.ref.batched_gspmm_ell_plain`.

Reduced precision (the reference kernel's int16 / bf16 / int8 branches):
:func:`batched_spmm_ell_bf16` takes int16 ids, bf16 values and a bf16 B
and returns bf16; :func:`batched_spmm_ell_i8` takes int16 ids, int8 codes,
their per-matrix f32 ``scale`` and an f32 B and returns f32. Both sum in
f32; their plain version is the same :func:`ref.batched_spmm_ell_plain`.
Each entry counts its own launches.

Large-matrix entries (paper case 3, where the reference takes its plain
per-sample path): :func:`batched_spmm_ell_large` (f32 and g-SpMM),
:func:`batched_spmm_ell_large_bf16` and :func:`batched_spmm_ell_large_i8`
take the same operands and any plan, case 3 included; the bf16 and i8 ones
also take int32 ids, for ``m_pad`` past int16's range. Since the kernel
reads B through the L2 at every plan, they launch the same kernel entries
as the batched ones (the same bits) and count their launches apart. Same
plain versions.
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
# the bf16 and i8 entries: (cid, val[, scale], b, c, batch, m_pad, k_pad,
# n_b, n_block, ids32, stream)
_BF16_ARGTYPES = (_P,) * 4 + (_I,) * 6 + (_P,)
_I8_ARGTYPES = (_P,) * 5 + (_I,) * 6 + (_P,)


def batched_spmm_ell(col_ids: torch.Tensor, values: torch.Tensor,
                     b: torch.Tensor, *, plan: BatchPlan | None = None,
                     rlen: torch.Tensor | None = None, op: str = "mul",
                     reduce: str = "sum") -> torch.Tensor:
    """col_ids (batch, m_pad, k_pad) int32, values (batch, m_pad, k_pad)
    f32, b (batch, m_pad, n_b) f32 → (batch, m_pad, n_b) f32. For g-SpMM
    also ``rlen`` (batch, m_pad) int32, which any ``(op, reduce)`` other
    than (mul, sum) and vector values (batch, m_pad, k_pad, n_b) need."""
    return _f32(batched_spmm_ell, False, col_ids, values, b, plan, rlen, op,
                reduce)


def batched_spmm_ell_large(col_ids: torch.Tensor, values: torch.Tensor,
                           b: torch.Tensor, *, plan: BatchPlan | None = None,
                           rlen: torch.Tensor | None = None, op: str = "mul",
                           reduce: str = "sum") -> torch.Tensor:
    """:func:`batched_spmm_ell` at any plan, planner case 3 included: the
    same kernel, counted apart."""
    return _f32(batched_spmm_ell_large, True, col_ids, values, b, plan, rlen,
                op, reduce)


def _f32(counted, large: bool, col_ids, values, b, plan, rlen, op, reduce):
    """The f32 and g-SpMM entries of either branch: checks, then the plain
    version on CPU tensors or the kernel, counted in ``counted``."""
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
    check_plan(plan, batch=batch, m_pad=m_pad, n_b=n_b, large=large)
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
    counted.launches += 1
    return out


batched_spmm_ell.launches = 0
batched_spmm_ell_large.launches = 0


def _reduced(counted, entry: str, col_ids: torch.Tensor,
             values: torch.Tensor, scale: torch.Tensor | None,
             b: torch.Tensor, plan: BatchPlan | None,
             large: bool = False) -> torch.Tensor:
    """The bf16 (``scale`` None) or i8 entry ``entry`` (counted in
    ``counted``): checks, then the plain version on CPU tensors or the
    kernel. The large-matrix entries also take int32 ids."""
    if b.dim() != 3 or col_ids.dim() != 3:
        raise ValueError(f"{entry} takes 3-D col_ids and b")
    batch, m_pad, k_pad = col_ids.shape
    n_b = b.shape[-1]
    i8 = scale is not None
    ids32 = large and col_ids.dtype == torch.int32
    check_operand("col_ids", col_ids, (batch, m_pad, k_pad),
                  torch.int32 if ids32 else torch.int16)
    check_operand("values", values, (batch, m_pad, k_pad),
                  torch.int8 if i8 else torch.bfloat16)
    check_operand("b", b, (batch, m_pad, n_b),
                  torch.float32 if i8 else torch.bfloat16)
    if i8:
        check_operand("scale", scale, (batch,), torch.float32)
    plan = plan or plan_batched_spmm(batch=batch, m_pad=m_pad, n_b=n_b,
                                     itemsize=b.element_size())
    check_plan(plan, batch=batch, m_pad=m_pad, n_b=n_b, large=large)
    if on_cpu(col_ids, values, scale, b):
        return ref.batched_spmm_ell_plain(col_ids, values, b, scale)
    out = torch.empty_like(b)
    if out.numel() == 0:
        return out
    args = [col_ids.data_ptr(), values.data_ptr()] \
        + ([scale.data_ptr()] if i8 else []) \
        + [b.data_ptr(), out.data_ptr(), batch, m_pad, k_pad, n_b,
           plan.n_block, int(ids32)]
    fn = _build.entry("batched_spmm_ell", entry,
                      _I8_ARGTYPES if i8 else _BF16_ARGTYPES)
    code = fn(*args, stream_handle())
    _build.check("batched_spmm_ell", code)
    counted.launches += 1
    return out


def batched_spmm_ell_bf16(col_ids: torch.Tensor, values: torch.Tensor,
                          b: torch.Tensor, *,
                          plan: BatchPlan | None = None) -> torch.Tensor:
    """col_ids (batch, m_pad, k_pad) int16, values bf16, b (batch, m_pad,
    n_b) bf16 → bf16: f32 sums rounded to bf16 once."""
    return _reduced(batched_spmm_ell_bf16, "batched_spmm_ell_bf16", col_ids,
                    values, None, b, plan)


def batched_spmm_ell_i8(col_ids: torch.Tensor, codes: torch.Tensor,
                        scale: torch.Tensor, b: torch.Tensor, *,
                        plan: BatchPlan | None = None) -> torch.Tensor:
    """col_ids (batch, m_pad, k_pad) int16, codes int8, scale (batch,) f32,
    b (batch, m_pad, n_b) f32 → f32: each f32 sum times its matrix's
    scale."""
    return _reduced(batched_spmm_ell_i8, "batched_spmm_ell_i8", col_ids,
                    codes, scale, b, plan)


def batched_spmm_ell_large_bf16(col_ids: torch.Tensor, values: torch.Tensor,
                                b: torch.Tensor, *,
                                plan: BatchPlan | None = None
                                ) -> torch.Tensor:
    """:func:`batched_spmm_ell_bf16` at any plan, case 3 included; int16
    or int32 ids. The same kernel entry, counted apart."""
    return _reduced(batched_spmm_ell_large_bf16, "batched_spmm_ell_bf16",
                    col_ids, values, None, b, plan, large=True)


def batched_spmm_ell_large_i8(col_ids: torch.Tensor, codes: torch.Tensor,
                              scale: torch.Tensor, b: torch.Tensor, *,
                              plan: BatchPlan | None = None) -> torch.Tensor:
    """:func:`batched_spmm_ell_i8` at any plan, case 3 included; int16 or
    int32 ids. The same kernel entry, counted apart."""
    return _reduced(batched_spmm_ell_large_i8, "batched_spmm_ell_i8",
                    col_ids, codes, scale, b, plan, large=True)


batched_spmm_ell_bf16.launches = 0
batched_spmm_ell_i8.launches = 0
batched_spmm_ell_large_bf16.launches = 0
batched_spmm_ell_large_i8.launches = 0
