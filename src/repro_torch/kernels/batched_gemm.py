"""Batched dense GEMM — ``C[s] = A[s] · B[s]``, the gemmBatched baseline the
paper measures against (§V-A), as a hand-written kernel.

The kernel is ``csrc/batched_gemm.cu`` (one block per matrix × column
panel, the A tile and the B panel in shared memory, C in registers, f32
FMAs); the plain version is :func:`repro_torch.kernels.ref.batched_gemm_plain`.
The registry's ``pallas_gemm`` densifies the adjacency outside the kernel
(``coo_to_dense``), as the reference does; ``dense`` is the same product
through ``torch.bmm``.

:func:`batched_gemm_large` is the kernel's K-tiled large-matrix entry, for
the plans whose A tile does not fit a block (``plan_batched_gemm``'s case
3, from m = k ~ 226): A and B pass through shared memory in slabs of 32
along K, C stays in registers, the same fixed-order sums. The reference's
kernel runs at every size, so ``pallas_gemm`` and ``dense_batched_matmul``
take it there. Same plain version, own counter.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.batching import BatchPlan, plan_batched_gemm
from repro_torch.kernels import (
    _build,
    check_operand,
    check_plan,
    on_cpu,
    ref,
    stream_handle,
)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _I, _I, _I, _I, _I, _P)


def batched_gemm(a: torch.Tensor, b: torch.Tensor, *,
                 plan: BatchPlan | None = None) -> torch.Tensor:
    """a (batch, m, k) f32, b (batch, k, n) f32 → (batch, m, n) f32."""
    return _launch(batched_gemm, False, a, b, plan)


def batched_gemm_large(a: torch.Tensor, b: torch.Tensor, *,
                       plan: BatchPlan | None = None) -> torch.Tensor:
    """:func:`batched_gemm` through the K-tiled entry, at any plan, case 3
    included."""
    return _launch(batched_gemm_large, True, a, b, plan)


def _launch(counted, large: bool, a, b, plan):
    if a.dim() != 3 or b.dim() != 3:
        raise ValueError("batched_gemm takes 3-D a and b")
    batch, m, k = a.shape
    n = b.shape[-1]
    check_operand("a", a, (batch, m, k), torch.float32)
    check_operand("b", b, (batch, k, n), torch.float32)
    plan = plan or plan_batched_gemm(batch=batch, m=m, n=n, k=k)
    check_plan(plan, batch=batch, m_pad=m, n_b=n, large=large)
    if on_cpu(a, b):
        return ref.batched_gemm_plain(a, b)
    out = torch.empty((batch, m, n), dtype=b.dtype, device=b.device)
    if out.numel() == 0:
        return out
    entry = "batched_gemm_large_f32" if large else "batched_gemm_f32"
    fn = _build.entry("batched_gemm", entry, _ARGTYPES)
    code = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), batch, m, k, n,
              plan.n_block, stream_handle())
    _build.check("batched_gemm", code)
    counted.launches += 1
    return out


batched_gemm.launches = 0
batched_gemm_large.launches = 0
