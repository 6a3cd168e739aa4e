"""Batched SpMM dispatch: one call multiplies every matrix of a batch.

The app-level contract is the reference's (paper §IV-D): adjacency matrices
arrive as COO batches and ``impl`` selects an entry of :data:`IMPLS`, with
the reference's names. This slice of the port is forward-only at f32 and
(mul, sum); the names it does not carry yet (``csr``, ``hybrid``, the
precision variants, ``auto``) raise and are listed in ``ROADMAP.md``.
"""
from __future__ import annotations

import torch

from repro_torch.core import batching
from repro_torch.core.formats import (
    BatchedCOO,
    coo_to_dense,
    coo_to_ell,
    validate_ell_k_pad,
)
from repro_torch.kernels import ref
from repro_torch.kernels.batched_spmm_coo import batched_spmm_coo
from repro_torch.kernels.batched_spmm_ell import batched_spmm_ell

# - ref:        plain batched COO scatter-add (the oracle)
# - ell:        plain ELL row split (gather + contraction)
# - pallas_ell: batched SWA-CSR, the row-split ELL CUDA kernel
# - pallas_coo: batched SWA-SparseTensor, the nnz-split COO CUDA kernel
# - dense:      densify + torch.bmm (the gemmBatched baseline)
# - loop:       the NON-batched baseline, one SpMM per sample
# - fused:      the graph-conv LAYER kernel (graph_conv_batched only)
IMPLS = ("ref", "ell", "pallas_ell", "pallas_coo", "dense", "loop", "fused")

# impls that run a hand-written kernel on CUDA tensors (the registry keeps
# the reference's names: pallas_* is the kernel class, not the toolchain)
KERNEL_IMPLS = ("pallas_ell", "pallas_coo", "fused")


def check_impl(impl: str) -> None:
    """Raise for ``auto`` and for registry names this port does not carry."""
    if impl == "auto":
        raise ValueError(
            "impl='auto' is not ported: the autotune, its roofline constants "
            "and tuning cache are TPU-calibrated (ROADMAP.md, queue 1: "
            f"Autotune). Pin one of {IMPLS}")
    if impl not in IMPLS:
        raise ValueError(
            f"impl={impl!r} is not in the port's registry {IMPLS}; "
            "ROADMAP.md lists what is still to port")


def reject_grad(impl: str, *tensors) -> None:
    """The kernels are forward-only in this slice of the port."""
    if impl in KERNEL_IMPLS and torch.is_grad_enabled() and any(
            t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"impl={impl!r} is forward-only in this port; its backward "
            "(backward_db via bwd_impl_for, dvalues) comes with the "
            "training slice in ROADMAP.md")


def batched_spmm(a: BatchedCOO, b: torch.Tensor, *, impl: str,
                 k_pad: int | None = None) -> torch.Tensor:
    """C[s] = A[s] @ B[s] for every sample s of the batch.

    a: BatchedCOO over square (m_pad, m_pad) adjacencies with scalar edge
    values; b: (batch, m_pad, n_b). The plain impls are differentiable
    through PyTorch's autograd; the kernel impls are forward-only."""
    check_impl(impl)
    if impl == "fused":
        raise ValueError(
            "impl='fused' is the graph-conv LAYER kernel (it needs W and "
            "bias, not a bare dense operand) — call "
            "repro_torch.core.graph_conv.graph_conv_batched(impl='fused')")
    if a.values.dim() != 2:
        raise NotImplementedError(
            "vector edge values are g-SpMM, which is not ported (ROADMAP.md)")
    reject_grad(impl, a.values, b)
    batch, m_pad, n_b = b.shape
    if impl == "ref":
        return ref.batched_spmm_coo_ref(a, b, m_pad)
    if impl == "loop":
        return torch.stack([
            ref.spmm_coo_single(a.row_ids[s], a.col_ids[s], a.values[s],
                                b[s], m_pad) for s in range(batch)])
    if impl == "dense":
        return ref.batched_gemm_ref(coo_to_dense(a, m_pad), b)
    ell = impl in ("ell", "pallas_ell")
    if ell:
        if k_pad is None:
            raise ValueError(f"{impl} requires k_pad (max nnz/row)")
        validate_ell_k_pad(a, m_pad, k_pad)
    plan = batching.plan_batched_spmm(batch=batch, m_pad=m_pad, n_b=n_b)
    if plan.case == 3:
        # paper case 3: too large for the batched shared-memory strategy.
        # The reference takes its plain per-sample path; off the CPU a
        # kernel impl must run its kernel, and the large-matrix one is not
        # written yet
        if impl in KERNEL_IMPLS and b.device.type != "cpu":
            raise ValueError(
                f"impl={impl!r}: m_pad={m_pad} is planner case 3 (one "
                "32-lane panel does not fit a block's shared memory); the "
                "large-matrix kernel is not written yet (ROADMAP.md §2, "
                "'Large-matrix kernel')")
        return ref.batched_spmm_coo_ref(a, b, m_pad)
    if ell:
        e = coo_to_ell(a, m_pad, k_pad)
        if impl == "ell":
            return ref.batched_spmm_ell_ref(e, b)
        return batched_spmm_ell(e.col_ids, e.values, b, plan=plan)
    return batched_spmm_coo(a.row_ids, a.col_ids, a.values, b, plan=plan)


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
