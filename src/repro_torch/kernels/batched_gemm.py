"""Batched dense GEMM — ``C[s] = A[s] · B[s]``, the gemmBatched baseline the
paper measures against (§V-A), as a hand-written kernel.

The kernel is ``csrc/batched_gemm.cu`` (one block per row tile × 64-column
panel of one matrix, C in registers, K streamed through a ring of
``cp.async`` slabs, f32 FMAs); the plain version is
:func:`repro_torch.kernels.ref.batched_gemm_plain`. :func:`gemm_tile`
chooses the row tile from the shapes and the card's SM count.
The registry's ``pallas_gemm`` densifies the adjacency outside the kernel
(``coo_to_dense``), as the reference does; ``dense`` is the same product
through ``torch.bmm``.

:func:`batched_gemm_large` takes the plans whose A tile does not fit a
block (``plan_batched_gemm``'s case 3, from m = k ~ 226), where the
reference's kernel runs too, so ``pallas_gemm`` and ``dense_batched_matmul``
take it there. Since the kernel streams K at every size, it launches the
same kernel as :func:`batched_gemm` (the same bits), and counts its
launches apart. Same plain version.
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
_ARGTYPES = (_P, _P, _P) + (_I,) * 6 + (_P,)

PANEL = 64              # columns of C a block owns (16 threads x 4)
TILE_THREAD_ROWS = (4, 8, 9)   # rows a thread holds: the kernel's instances
MAX_ROW_GROUPS = 16     # row groups of 16 threads: 256 threads a block


def gemm_tile(batch: int, m: int, n: int, sms: int) -> tuple[int, int]:
    """The kernel's row tile ``(rows a thread, row groups)``. Up to 128
    rows, one tile of ``ceil(m / tm)`` groups, tm 4 up to 64 rows (twice
    the warps a block to hide the loads' latency) and 8 past it, so that no
    row past m is computed but the last group's
    spare ones. Past 128 rows, 8 or 9 rows a thread in 8 or 16 groups,
    whichever leaves the fewest rows on the busiest of ``sms`` SMs (the
    tiles spread one a block, evenly), the larger tile on a tie (fewer
    re-reads of B): 2 x 9000 takes 126 tiles of 144 rows on 132 SMs, where
    128-row tiles would be 142, a wave and a tenth."""
    if m <= 8 * MAX_ROW_GROUPS:
        tm = 4 if m <= 4 * MAX_ROW_GROUPS else 8
        return tm, -(-m // tm)
    panels = -(-n // PANEL)

    def busiest(tile):
        tm, groups = tile
        bm = tm * groups
        tiles = batch * -(-m // bm) * panels
        return -(-tiles // sms) * bm, -bm

    return min(((tm, g) for tm in TILE_THREAD_ROWS[1:]
                for g in (MAX_ROW_GROUPS, MAX_ROW_GROUPS // 2)), key=busiest)


def batched_gemm(a: torch.Tensor, b: torch.Tensor, *,
                 plan: BatchPlan | None = None) -> torch.Tensor:
    """a (batch, m, k) f32, b (batch, k, n) f32 → (batch, m, n) f32."""
    return _launch(batched_gemm, False, a, b, plan)


def batched_gemm_large(a: torch.Tensor, b: torch.Tensor, *,
                       plan: BatchPlan | None = None) -> torch.Tensor:
    """:func:`batched_gemm` at any plan, case 3 included: the same kernel,
    counted apart."""
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
    sms = torch.cuda.get_device_properties(b.device).multi_processor_count
    tm, groups = gemm_tile(batch, m, n, sms)
    fn = _build.entry("batched_gemm", "batched_gemm_f32", _ARGTYPES)
    code = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), batch, m, k, n, tm,
              groups, stream_handle())
    _build.check("batched_gemm", code)
    counted.launches += 1
    return out


batched_gemm.launches = 0
batched_gemm_large.launches = 0
