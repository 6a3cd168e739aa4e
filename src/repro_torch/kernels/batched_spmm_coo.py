"""Batched COO SpMM — the paper's batched SWA-SpMM for SparseTensor (the
slots of a matrix in any order): ``C[s, rid] += val · B[s, cid, :]``.

The kernel is ``csrc/batched_spmm_coo.cu``: a block owns rows of one
matrix (the whole matrix at the main-path shapes), buckets the matrix's
slots by row in shared memory (per-(row, warp) counts, a prefix sum, a
stable placement: each row's slots in increasing slot index), then each
sub-warp walks its rows' slots, gathers B rows through the L2, four
columns a lane, and sums them in registers in slot order, one ``fmaf``
chain an output stored once. No float atomics: the same bits from run to
run and under any block split. The plain version is
:func:`repro_torch.kernels.ref.batched_spmm_coo_plain`. f32, (mul, sum).
It also runs dB = Aᵀ·dC (ids swapped, so the row ids arrive in column
order) for the ``pallas_coo``, ``pallas_ell`` and ``fused`` backwards.
Every slot is visited, as in the reference: a slot whose value is 0.0
(padding) adds nothing, and neither does a row or column id outside
``[0, m_pad)`` (the ``m_pad`` sentinel).

g-SpMM (the reference kernel's ``nnz``/``op``/``reduce`` operands): given
the per-matrix true ``nnz``, another ``(op, reduce)`` or vector edges
``(batch, nnz_pad, n_b)``, the wrapper launches the kernel's g-SpMM entry,
which masks each matrix's slots at or past ``nnz[s]``, counts each row's
degree (every slot below ``nnz[s]`` whose row id, clipped into
``[0, m_pad)``, is that row) and finishes ``mean`` and the empty rows of
``max`` itself; its
plain version is :func:`repro_torch.kernels.ref.batched_gspmm_coo_plain`.
It is planned as the (mul, sum) entries are.

:func:`batched_spmm_coo_bf16` is the reference kernel's bf16 branch: int16
row and column ids, bf16 values and B, f32 sums, bf16 out (rounded once).
Its plain version is :func:`ref.batched_spmm_coo_plain`; it counts its own
launches.

Large-matrix entries (paper case 3, where the reference takes its plain
per-sample path): :func:`batched_spmm_coo_large` (f32 and g-SpMM) and
:func:`batched_spmm_coo_large_bf16` take the same operands and any plan,
case 3 included. A matrix's stream there is far larger than a block
buckets at a time, so the kernel's large-matrix branch first sorts each
run of the stream by row tile (stably: a tile's slots in slot order), then
each walk block stages its tile's slots, buckets them by row and walks
them as the batched entry does, its sums kept in shared memory between
stages. Each output is the batched entry's one chain in slot order, stored
once: no float atomics and no fill, the same bits from run to run and as
the batched entry's. The scratch (the sorted slots and each (tile, run)'s
start) is ``torch.empty``, sized from the shapes. The bf16 one also takes
int32 ids, for ``m_pad`` past int16's range. Same plain versions, own
counters.
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


def _argtypes(pointers: int, ints: int) -> tuple:
    """An entry's ctypes: its pointers (ids, values, [nnz,] b, c[, the
    large-matrix branch's scratch]), its ints (batch, nnz_pad, m_pad, n_b,
    n_block[, op, reduce, vector edges][, ids32]), then the stream."""
    return (_P,) * pointers + (_I,) * ints + (_P,)


def batched_spmm_coo(row_ids: torch.Tensor, col_ids: torch.Tensor,
                     values: torch.Tensor, b: torch.Tensor, *,
                     plan: BatchPlan | None = None,
                     nnz: torch.Tensor | None = None, op: str = "mul",
                     reduce: str = "sum") -> torch.Tensor:
    """row_ids/col_ids (batch, nnz_pad) int32, values (batch, nnz_pad) f32,
    b (batch, m_pad, n_b) f32 → (batch, m_pad, n_b) f32. For g-SpMM also
    ``nnz`` (batch,) int32, which any ``(op, reduce)`` other than (mul,
    sum) and vector values (batch, nnz_pad, n_b) need."""
    return _f32(batched_spmm_coo, False, row_ids, col_ids, values, b, plan,
                nnz, op, reduce)


def batched_spmm_coo_large(row_ids: torch.Tensor, col_ids: torch.Tensor,
                           values: torch.Tensor, b: torch.Tensor, *,
                           plan: BatchPlan | None = None,
                           nnz: torch.Tensor | None = None, op: str = "mul",
                           reduce: str = "sum") -> torch.Tensor:
    """:func:`batched_spmm_coo` through the large-matrix branch (sorted by
    row tile, then walked), at any plan, planner case 3 included."""
    return _f32(batched_spmm_coo_large, True, row_ids, col_ids, values, b,
                plan, nnz, op, reduce)


def _f32(counted, large: bool, row_ids, col_ids, values, b, plan, nnz, op,
         reduce):
    """The f32 and g-SpMM entries of either branch: checks, then the plain
    version on CPU tensors or the kernel, counted in ``counted``."""
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
    plan = plan or plan_batched_spmm(batch=batch, m_pad=m_pad, n_b=n_b)
    check_plan(plan, batch=batch, m_pad=m_pad, n_b=n_b, large=large)
    if on_cpu(row_ids, col_ids, values, b, nnz):
        if gspmm:
            return ref.batched_gspmm_coo_plain(row_ids, col_ids, values, nnz,
                                               b, op=op, reduce=reduce)
        return ref.batched_spmm_coo_plain(row_ids, col_ids, values, b)
    out = torch.empty_like(b)
    if out.numel() == 0:
        return out
    ids = (row_ids.data_ptr(), col_ids.data_ptr(), values.data_ptr())
    ptrs = (b.data_ptr(), out.data_ptr())
    if large:
        ptrs += (_large_scratch(batch, nnz_pad, m_pad, plan, b).data_ptr(),)
    shape = (batch, nnz_pad, m_pad, n_b, plan.n_block)
    entry = ("batched_gspmm_coo" if gspmm else "batched_spmm_coo") \
        + ("_large_f32" if large else "_f32")
    fn = _build.entry("batched_spmm_coo", entry,
                      _argtypes(5 + gspmm + large, 5 + 3 * gspmm))
    if gspmm:
        code = fn(*ids, nnz.data_ptr(), *ptrs, *shape,
                  *gspmm_codes(op, reduce), int(values.dim() == 3),
                  stream_handle())
    else:
        code = fn(*ids, *ptrs, *shape, stream_handle())
    _build.check("batched_spmm_coo", code)
    counted.launches += 1
    return out


batched_spmm_coo.launches = 0
batched_spmm_coo_large.launches = 0


def batched_spmm_coo_bf16(row_ids: torch.Tensor, col_ids: torch.Tensor,
                          values: torch.Tensor, b: torch.Tensor, *,
                          plan: BatchPlan | None = None) -> torch.Tensor:
    """row_ids/col_ids (batch, nnz_pad) int16, values bf16, b (batch, m_pad,
    n_b) bf16 → bf16: f32 sums in registers rounded to bf16 once. The
    plan is the f32 one, as ``ops`` plans every COO entry."""
    return _bf16(batched_spmm_coo_bf16, False, row_ids, col_ids, values, b,
                 plan)


def batched_spmm_coo_large_bf16(row_ids: torch.Tensor, col_ids: torch.Tensor,
                                values: torch.Tensor, b: torch.Tensor, *,
                                plan: BatchPlan | None = None
                                ) -> torch.Tensor:
    """:func:`batched_spmm_coo_bf16` through the large-matrix branch (sorted
    by row tile, then walked; f32 sums rounded to bf16 once at the store);
    int16 or int32 row and column ids."""
    return _bf16(batched_spmm_coo_large_bf16, True, row_ids, col_ids, values,
                 b, plan)


def _bf16(counted, large: bool, row_ids, col_ids, values, b, plan):
    """The bf16 entry of either branch: checks, then the plain version on
    CPU tensors or the kernel, counted in ``counted``. The large branch
    also takes int32 ids."""
    if b.dim() != 3 or row_ids.dim() != 2:
        raise ValueError("batched_spmm_coo_bf16 takes 2-D ids and a 3-D b")
    batch, nnz_pad = row_ids.shape
    m_pad, n_b = b.shape[1], b.shape[2]
    ids32 = large and row_ids.dtype == torch.int32
    id_type = torch.int32 if ids32 else torch.int16
    check_operand("row_ids", row_ids, (batch, nnz_pad), id_type)
    check_operand("col_ids", col_ids, (batch, nnz_pad), id_type)
    check_operand("values", values, (batch, nnz_pad), torch.bfloat16)
    check_operand("b", b, (batch, m_pad, n_b), torch.bfloat16)
    plan = plan or plan_batched_spmm(batch=batch, m_pad=m_pad, n_b=n_b)
    check_plan(plan, batch=batch, m_pad=m_pad, n_b=n_b, large=large)
    if on_cpu(row_ids, col_ids, values, b):
        return ref.batched_spmm_coo_plain(row_ids, col_ids, values, b)
    out = torch.empty_like(b)
    if out.numel() == 0:
        return out
    ids = (row_ids.data_ptr(), col_ids.data_ptr(), values.data_ptr(),
           b.data_ptr())
    shape = (batch, nnz_pad, m_pad, n_b, plan.n_block)
    if large:
        scratch = _large_scratch(batch, nnz_pad, m_pad, plan, b)
        fn = _build.entry("batched_spmm_coo", "batched_spmm_coo_large_bf16",
                          _argtypes(6, 6))
        code = fn(*ids, out.data_ptr(), scratch.data_ptr(), *shape,
                  int(ids32), stream_handle())
    else:
        fn = _build.entry("batched_spmm_coo", "batched_spmm_coo_bf16",
                          _argtypes(5, 5))
        code = fn(*ids, out.data_ptr(), *shape, stream_handle())
    _build.check("batched_spmm_coo", code)
    counted.launches += 1
    return out


batched_spmm_coo_bf16.launches = 0
batched_spmm_coo_large_bf16.launches = 0


def _large_scratch(batch: int, nnz_pad: int, m_pad: int, plan: BatchPlan,
                   b: torch.Tensor) -> torch.Tensor:
    """The large-matrix branch's scratch (``torch.empty``, 4-byte words):
    each matrix's slots sorted by row tile (row ids, column ids, values)
    and where each (tile, run) starts, its size from the shapes alone (the
    kernel library's count)."""
    fn = _build.entry("batched_spmm_coo", "batched_spmm_coo_large_scratch",
                      (_I,) * 4)
    words = fn(batch, nnz_pad, m_pad, plan.n_block)
    if words < 0:
        raise ValueError(f"batched_spmm_coo: m_pad {m_pad} is past what the "
                         "large-matrix branch takes (16,776,960)")
    return torch.empty(batch * words, dtype=torch.int32, device=b.device)
