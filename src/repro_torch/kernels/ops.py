"""Batched SpMM dispatch: one call multiplies every matrix of a batch.

The app-level contract is the reference's (paper §IV-D): adjacency matrices
arrive as COO batches and ``impl`` selects an entry of :data:`IMPLS`, with
the reference's names. Every impl is differentiable in ``a.values`` and
``b`` through one ``torch.autograd.Function``, the counterpart of the
reference's custom VJP: dB = Aᵀ·dC is a batched SpMM of the class
:func:`bwd_impl_for` picks (:func:`backward_db`) and dValues a batched
gather-dot (:func:`dvalues`), each computed only when asked for. This port
is f32 and (mul, sum); the reference's names that are not in
:data:`IMPLS` (the precision variants ``*_bf16``/``*_i8`` and ``auto``)
raise and are listed in ``ROADMAP.md``.
"""
from __future__ import annotations

import torch

from repro_torch.core import batching
from repro_torch.core.formats import (
    BatchedCOO,
    coo_to_csr,
    coo_to_dense,
    coo_to_ell,
    validate_ell_k_pad,
)
from repro_torch.kernels import ref
from repro_torch.kernels.batched_gemm import batched_gemm
from repro_torch.kernels.batched_spmm_coo import batched_spmm_coo
from repro_torch.kernels.batched_spmm_csr import batched_spmm_csr
from repro_torch.kernels.batched_spmm_ell import batched_spmm_ell
from repro_torch.kernels.batched_spmm_hybrid import (
    batched_spmm_hybrid,
    batched_spmm_hybrid_ref,
)

# - ref:        plain batched COO scatter-add (the oracle)
# - ell:        plain ELL row split (gather + contraction)
# - pallas_ell: batched SWA-CSR on padded rows, the row-split ELL CUDA kernel
# - csr:        plain CSR row split (rpt search + scatter-add)
# - pallas_csr: batched SWA-CSR on flat CSR arrays, the row-split CSR CUDA
#               kernel (no atomics; its own CSR-class backward)
# - pallas_coo:    batched SWA-SparseTensor, the nnz-split COO CUDA kernel
# - hybrid:        plain degree split: hub-row slab product + ELL remainder
#                  of width dmin - 1
# - pallas_hybrid: the degree-sorted hybrid CUDA kernel (hub slab + CSR
#                  remainder, inverse row permutation in the epilogue)
# - dense:         densify + torch.bmm (the gemmBatched library baseline)
# - pallas_gemm:   densify + the batched GEMM CUDA kernel
# - loop:          the NON-batched baseline, one SpMM per sample
# - fused:         the graph-conv LAYER kernel (graph_conv_batched only)
# - fused_hybrid:  the LAYER kernel with the hybrid split folded in
IMPLS = ("ref", "ell", "pallas_ell", "csr", "pallas_csr", "pallas_coo",
         "hybrid", "pallas_hybrid", "dense", "pallas_gemm", "loop", "fused",
         "fused_hybrid")

# impls that run a hand-written kernel on CUDA tensors (the registry keeps
# the reference's names: pallas_* is the kernel class, not the toolchain)
KERNEL_IMPLS = ("pallas_ell", "pallas_csr", "pallas_coo", "pallas_hybrid",
                "pallas_gemm", "fused", "fused_hybrid")


def check_impl(impl: str) -> None:
    """Raise for ``auto`` and for registry names this port does not carry
    (the reference's precision variants)."""
    if impl == "auto":
        raise ValueError(
            "impl='auto' is not ported: the autotune, its roofline constants "
            "and tuning cache are TPU-calibrated (ROADMAP.md, queue 1: "
            f"Autotune). Pin one of {IMPLS}")
    if impl not in IMPLS:
        raise ValueError(
            f"impl={impl!r} is not in the port's registry {IMPLS} (the "
            "reduced-precision *_bf16 / *_i8 variants are not ported); "
            "ROADMAP.md lists what is still to port")


def bwd_impl_for(impl: str) -> str:
    """The impl the backward pass (dB = Aᵀ·dC) runs for a forward ``impl``.

    Aᵀ loses the per-row ELL bound, so ELL-class forwards fall to the COO
    class; the CSR class stays CSR (the swapped COO re-sorts into the exact
    transposed CSR). The hybrid class maps to the CSR class (its remainder
    is the CSR row split): its inverse permutation sits inside the forward,
    so cotangents arrive in original row order and Aᵀ is not re-sorted by
    its own degrees. ``pallas_gemm`` and both fused layers (dU = Aᵀ·dZ)
    take the COO kernel; ``dense`` stays dense."""
    if impl in ("csr", "pallas_csr"):
        return impl
    if impl == "hybrid":
        return "csr"
    if impl == "pallas_hybrid":
        return "pallas_csr"
    if impl.startswith("pallas") or impl.startswith("fused"):
        return "pallas_coo"
    return impl if impl in ("ref", "loop", "dense") else "ref"


def _kernel_case3(impl: str, b: torch.Tensor, m_pad: int) -> None:
    """Paper case 3 (too large for the batched shared-memory strategy): the
    reference takes its plain per-sample path; off the CPU a kernel impl
    (pallas_ell, pallas_csr, pallas_coo, pallas_hybrid, pallas_gemm) must
    run its kernel, and the large-matrix one is not written yet."""
    if impl in KERNEL_IMPLS and b.device.type != "cpu":
        raise ValueError(
            f"impl={impl!r}: m_pad={m_pad} is planner case 3 (the block's "
            "shared-memory working set does not fit, not even with one "
            "32-lane panel); the large-matrix kernel is not written yet "
            "(ROADMAP.md §2, 'Large-matrix kernel')")


def _forward(row_ids, col_ids, nnz, values, b, *, impl: str,
             k_pad: int | None) -> torch.Tensor:
    """One batched SpMM forward of ``impl`` on raw COO operands (no
    autograd): shared by the forward and by :func:`backward_db`."""
    batch, m_pad, n_b = b.shape
    a = BatchedCOO(row_ids, col_ids, values, nnz,
                   torch.full((batch,), m_pad, dtype=torch.int32,
                              device=b.device))
    if impl == "ref":
        return ref.batched_spmm_coo_ref(a, b, m_pad)
    if impl == "loop":
        return torch.stack([
            ref.spmm_coo_single(row_ids[s], col_ids[s], values[s], b[s],
                                m_pad) for s in range(batch)])
    if impl in ("dense", "pallas_gemm"):
        a_dense = coo_to_dense(a, m_pad).to(b.dtype).contiguous()
        if impl == "dense":
            return ref.batched_gemm_ref(a_dense, b)
        gplan = batching.plan_batched_gemm(batch=batch, m=m_pad, n=n_b,
                                           k=m_pad)
        if gplan.case == 3:
            _kernel_case3(impl, b, m_pad)
            return ref.batched_gemm_plain(a_dense, b)
        return batched_gemm(a_dense, b, plan=gplan)
    if impl in ("hybrid", "pallas_hybrid"):
        hplan = batching.plan_hybrid(batch=batch, m_pad=m_pad, n_b=n_b,
                                     nnz_pad=row_ids.shape[1])
        if impl == "hybrid":
            return batched_spmm_hybrid_ref(a, b, m_pad, plan=hplan)
        if hplan.spmm.case == 3:
            _kernel_case3(impl, b, m_pad)
            return ref.batched_spmm_coo_ref(a, b, m_pad)
        return batched_spmm_hybrid(row_ids, col_ids, values, nnz, b,
                                   plan=hplan)
    plan = batching.plan_batched_spmm(batch=batch, m_pad=m_pad, n_b=n_b)
    if impl in ("csr", "pallas_csr"):
        csr = coo_to_csr(a, m_pad)
        if impl == "csr" or plan.case == 3:
            _kernel_case3(impl, b, m_pad)
            return ref.batched_spmm_csr_ref(csr, b)
        return batched_spmm_csr(csr.rpt, csr.col_ids, csr.values, b,
                                plan=plan)
    ell = impl in ("ell", "pallas_ell")
    if ell:
        if k_pad is None:
            raise ValueError(f"{impl} requires k_pad (max nnz/row)")
        validate_ell_k_pad(a, m_pad, k_pad)
    if plan.case == 3:
        _kernel_case3(impl, b, m_pad)
        return ref.batched_spmm_coo_ref(a, b, m_pad)
    if ell:
        e = coo_to_ell(a, m_pad, k_pad)
        if impl == "ell":
            return ref.batched_spmm_ell_ref(e, b)
        return batched_spmm_ell(e.col_ids, e.values, b, plan=plan)
    return batched_spmm_coo(row_ids, col_ids, values, b, plan=plan)


def backward_db(row_ids, col_ids, nnz, values, dc, *,
                impl: str) -> torch.Tensor:
    """dB = Aᵀ·dC for a forward ``impl``: the batched SpMM of
    :func:`bwd_impl_for`'s class with the COO index arrays swapped. For the
    CSR class the swapped COO is then row-sorted, which is the transposed
    CSR in one sort. ``dc`` must be contiguous for the kernels."""
    return _forward(col_ids, row_ids, nnz, values, dc,
                    impl=bwd_impl_for(impl), k_pad=None)


def dvalues(row_ids, col_ids, dc, b) -> torch.Tensor:
    """dValues[s, i] = <dC[s, rid[s, i]], B[s, cid[s, i]]>, the batched
    gather-dot of the backward, over every slot (padded slots too, as in the
    reference). A slot whose row or column id is out of range gives NaN, as
    the reference's filling gather does."""
    def take(t, ids):
        idx = ids.long().clamp(0, t.shape[1] - 1)
        return torch.gather(t.float(), 1,
                            idx[..., None].expand(-1, -1, t.shape[-1]))

    dot = (take(dc, row_ids) * take(b, col_ids)).sum(dim=-1)
    ok = ((row_ids >= 0) & (row_ids < dc.shape[1])
          & (col_ids >= 0) & (col_ids < b.shape[1]))
    return torch.where(ok, dot, float("nan"))


class _SpMM(torch.autograd.Function):
    """C = A·B with the reference's VJP: dB through :func:`backward_db`,
    dValues through :func:`dvalues`."""

    @staticmethod
    def forward(ctx, values, b, row_ids, col_ids, nnz, impl, k_pad):
        ctx.save_for_backward(values, b, row_ids, col_ids, nnz)
        ctx.impl = impl
        return _forward(row_ids, col_ids, nnz, values, b, impl=impl,
                        k_pad=k_pad)

    @staticmethod
    def backward(ctx, dc):
        values, b, row_ids, col_ids, nnz = ctx.saved_tensors
        dc = dc.contiguous()
        dval = db = None
        if ctx.needs_input_grad[0]:
            dval = dvalues(row_ids, col_ids, dc, b).to(values.dtype)
        if ctx.needs_input_grad[1]:
            db = backward_db(row_ids, col_ids, nnz, values, dc,
                             impl=ctx.impl).to(b.dtype)
        return dval, db, None, None, None, None, None


def batched_spmm(a: BatchedCOO, b: torch.Tensor, *, impl: str,
                 k_pad: int | None = None) -> torch.Tensor:
    """C[s] = A[s] @ B[s] for every sample s of the batch.

    a: BatchedCOO over square (m_pad, m_pad) adjacencies with scalar edge
    values; b: (batch, m_pad, n_b). Differentiable in ``a.values`` and
    ``b``; on CUDA tensors a kernel impl's backward runs kernels too."""
    check_impl(impl)
    if impl.startswith("fused"):
        raise ValueError(
            f"impl={impl!r} is the graph-conv LAYER kernel (it needs W and "
            "bias, not a bare dense operand) — call "
            f"repro_torch.core.graph_conv.graph_conv_batched(impl={impl!r})")
    if a.values.dim() != 2:
        raise NotImplementedError(
            "vector edge values are g-SpMM, which is not ported (ROADMAP.md)")
    return _SpMM.apply(a.values, b, a.row_ids, a.col_ids, a.nnz, impl, k_pad)


def batched_gspmm(a: BatchedCOO, b: torch.Tensor, *, op: str = "mul",
                  reduce: str = "sum", impl: str,
                  k_pad: int | None = None) -> torch.Tensor:
    """g-SpMM: only the (mul, sum) scalar-edge corner, which IS
    :func:`batched_spmm`, is ported."""
    if (op, reduce) != ("mul", "sum"):
        raise NotImplementedError(
            f"g-SpMM (op={op!r}, reduce={reduce!r}) is not ported "
            "(ROADMAP.md); only (mul, sum) runs")
    return batched_spmm(a, b, impl=impl, k_pad=k_pad)


def dense_batched_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``C[s] = A[s] · B[s]`` through the batched GEMM kernel (the
    reference's standalone entry point, benchmark use): a (batch, m, k),
    b (batch, k, n) f32."""
    plan = batching.plan_batched_gemm(batch=a.shape[0], m=a.shape[1],
                                      n=b.shape[-1], k=a.shape[2])
    if plan.case == 3:
        raise ValueError(f"{plan}: the A tile does not fit one block's "
                         "shared memory")
    return batched_gemm(a, b, plan=plan)
