"""Batched SpMM dispatch: one call multiplies every matrix of a batch.

The app-level contract is the reference's (paper §IV-D): adjacency matrices
arrive as COO batches and ``impl`` selects an entry of :data:`IMPLS`, with
the reference's names. Every impl is differentiable in ``a.values`` and
``b`` through one ``torch.autograd.Function``, the counterpart of the
reference's custom VJP: dB = Aᵀ·dC is a batched SpMM of the class
:func:`bwd_impl_for` picks (:func:`backward_db`) and dValues a batched
gather-dot (:func:`dvalues`), each computed only when asked for.

The reduced-precision variants (``autotune.PRECISION_IMPLS``, DESIGN.md
§10) are registry entries of their own: each runs its base impl's
structure under a storage policy (:func:`_forward`). ``bf16`` casts the
values and B to bfloat16, ``i8`` quantizes the values to int8 codes with a
per-matrix scale; both narrow the ids to int16 on the kernel paths, sum in
f32 and return B's dtype. Their backward classes are :data:`_VARIANT_BWD`.
``impl="auto"`` (the default) resolves to a concrete impl from the call's
shapes through ``repro_torch.autotune`` (:func:`resolve_impl`,
:func:`resolve_gspmm_impl`) before the autograd Function runs; a pinned
impl takes its path directly.

g-SpMM (:func:`batched_gspmm`) generalizes ``C[rid] += val · B[cid]`` into
message passing ``C[r] = reduce(op(B[c], e))`` with ``op ∈``
:data:`GSPMM_OPS`, ``reduce ∈`` :data:`GSPMM_REDUCES` and edge values that
may be per-edge feature vectors ``(batch, nnz_pad, d_e)``. The (mul, sum)
corner with scalar edges IS :func:`batched_spmm`; every other corner runs
the capable subset :data:`GSPMM_IMPLS` with explicit padding masks, its
forward through the ELL, CSR and COO kernels' g-SpMM entries on the card
and its backward (:func:`gspmm_backward`) as plain gather/scatter, as in
the reference.

With telemetry on (``REPRO_TELEMETRY`` or
``repro_torch.observability.telemetry()``) every :func:`batched_spmm` and
:func:`batched_gspmm` dispatch runs inside a ``spmm/{impl}`` span
(:func:`_traced_dispatch`); off, the dispatch pays one predicate.
"""
from __future__ import annotations

import time

import torch

from repro_torch.core import batching
from repro_torch.autotune.cost_model import (
    GSPMM_IMPLS,
    PRECISION_IMPLS,
    precision_of,
    supports_gspmm,
)
from repro_torch.core.formats import (
    INT16_MAX,
    BatchedCOO,
    coo_to_csr,
    coo_to_dense,
    coo_to_ell,
    narrow_col_ids,
    quantize_values_i8,
    row_degrees,
    validate_ell_k_pad,
)
from repro_torch.kernels import GSPMM_OPS, GSPMM_REDUCES, ref
from repro_torch.kernels.batched_gemm import batched_gemm, batched_gemm_large
from repro_torch.kernels.batched_spmm_coo import (
    batched_spmm_coo,
    batched_spmm_coo_bf16,
    batched_spmm_coo_large,
    batched_spmm_coo_large_bf16,
)
from repro_torch.kernels.batched_spmm_csr import (
    batched_spmm_csr,
    batched_spmm_csr_bf16,
    batched_spmm_csr_i8,
    batched_spmm_csr_large,
    batched_spmm_csr_large_bf16,
    batched_spmm_csr_large_i8,
)
from repro_torch.kernels.batched_spmm_ell import (
    batched_spmm_ell,
    batched_spmm_ell_bf16,
    batched_spmm_ell_i8,
    batched_spmm_ell_large,
    batched_spmm_ell_large_bf16,
    batched_spmm_ell_large_i8,
)
from repro_torch.kernels.batched_spmm_hybrid import (
    batched_spmm_hybrid,
    batched_spmm_hybrid_bf16,
    batched_spmm_hybrid_ref,
)
from repro_torch.observability import trace as obs_trace

# - ref:        plain batched COO scatter-add (the oracle)
# - ell:        plain ELL row split (gather + contraction)
# - pallas_ell: batched SWA-CSR on padded rows, the row-split ELL CUDA kernel
# - csr:        plain CSR row split (rpt search + scatter-add)
# - pallas_csr: batched SWA-CSR on flat CSR arrays, the row-split CSR CUDA
#               kernel (no atomics; its own CSR-class backward)
# - pallas_coo:    batched SWA-SparseTensor, the COO CUDA kernel
# - hybrid:        plain degree split: hub-row slab product + ELL remainder
#                  of width dmin - 1
# - pallas_hybrid: the degree-sorted hybrid CUDA kernel (hub slab + CSR
#                  remainder, inverse row permutation in the epilogue)
# - dense:         densify + torch.bmm (the gemmBatched library baseline)
# - pallas_gemm:   densify + the batched GEMM CUDA kernel
# - auto:          resolved per call from its shapes (repro_torch.autotune)
# - loop:          the NON-batched baseline, one SpMM per sample
# - fused:         the graph-conv LAYER kernel (graph_conv_batched only)
# - fused_hybrid:  the LAYER kernel with the hybrid split folded in
# - the PRECISION_IMPLS (ell_bf16, pallas_csr_i8, fused_bf16, ...): the
#   base impl's structure with bf16 or int8 storage (see _forward)
IMPLS = ("auto", "ref", "ell", "pallas_ell", "csr", "pallas_csr", "pallas_coo",
         "hybrid", "pallas_hybrid", "dense", "pallas_gemm", "loop", "fused",
         "fused_hybrid") + tuple(PRECISION_IMPLS)

# impls that run a hand-written kernel on CUDA tensors (the registry keeps
# the reference's names: pallas_* is the kernel class, not the toolchain)
KERNEL_IMPLS = ("pallas_ell", "pallas_csr", "pallas_coo", "pallas_hybrid",
                "pallas_gemm", "fused", "fused_hybrid")


def check_impl(impl: str) -> None:
    """Raise for names outside the registry (``auto`` is in it)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")


def _workload(a: BatchedCOO, b: torch.Tensor, *, k_pad: int | None,
              **axes):
    from repro_torch.autotune import Workload

    batch, m_pad, n_b = b.shape
    return Workload(batch=batch, m_pad=m_pad, nnz_pad=a.row_ids.shape[1],
                    k_pad=k_pad, n_b=n_b, itemsize=b.element_size(), **axes)


def resolve_impl(a: BatchedCOO, b: torch.Tensor, *, impl: str = "auto",
                 k_pad: int | None = None, precision: str = "f32"):
    """Resolve ``impl="auto"`` to the concrete impl for this call's shapes.

    Returns a ``repro_torch.autotune.Decision`` (``.impl`` is the concrete
    string); a concrete ``impl`` passes through as a forced Decision.
    ``precision`` (``"f32"``/``"bf16"``/``"i8"``) is the caller's storage
    policy: under ``auto`` it admits its variants to the ranking, a
    concrete impl carries its own. Kernel impls are ranked only where
    they run, on CUDA tensors. Host work alone: no PyTorch op, no sync."""
    from repro_torch import autotune

    if impl != "auto":
        return autotune.forced_decision(
            _workload(a, b, k_pad=k_pad, dtype=precision_of(impl)[1]), impl)
    batch, m_pad, n_b = b.shape
    return autotune.resolve_auto(
        batch=batch, m_pad=m_pad, nnz_pad=a.row_ids.shape[1], k_pad=k_pad,
        n_b=n_b, itemsize=b.element_size(),
        allow_pallas=b.device.type == "cuda", dtype=precision)


def resolve_gspmm_impl(a: BatchedCOO, b: torch.Tensor, *, op: str = "mul",
                       reduce: str = "sum", impl: str = "auto",
                       k_pad: int | None = None):
    """Resolve ``impl="auto"`` for one g-SpMM call: :func:`resolve_impl`
    with the workload's ``(op, reduce, d_e)`` axes set, so the ladder is
    the g-SpMM-capable subset and the cache key never collides with the
    plain SpMM's."""
    from repro_torch import autotune

    d_e = a.values.shape[2] if a.values.dim() == 3 else None
    w = _workload(a, b, k_pad=k_pad, d_e=d_e, reduce=reduce, op=op)
    if impl != "auto":
        return autotune.forced_decision(w, impl)
    return autotune.select_impl(w, allow_pallas=b.device.type == "cuda",
                                cache=autotune.default_cache())


def resolve_compute_dtype(a_dtype: torch.dtype,
                          b_dtype: torch.dtype) -> torch.dtype:
    """The GEMM class's mixed-dtype policy (DESIGN.md §10): both operands
    meet at their promoted dtype, so a full-precision operand is never
    cast down (bf16 with f32 computes f32)."""
    return torch.promote_types(a_dtype, b_dtype)


def _traced_dispatch(f, values, b, *, impl, decision, workload):
    """Run one dispatch under a telemetry span (the reference's
    ``_traced_dispatch``).

    Only reached when ``observability.enabled()`` — the hot path pays a
    single predicate otherwise. The span (``spmm/{impl}``, for a g-SpMM
    dispatch too, its ``op`` and ``reduce`` in the args) carries the
    workload geometry, the decision's provenance, and the cost model's
    *predicted* seconds and minimum bytes, so a trace viewer (and the regret
    auditor) can line predicted up against measured. A kernel launch
    returns before the kernel has run, so on the card the dispatch is
    bracketed by ``torch.cuda.synchronize()``: the span and the auditor's
    measured time are the wall between two syncs, the reference's
    ``block_until_ready``. A dispatch made while the stream is capturing a
    CUDA graph records its span but neither syncs nor feeds the auditor:
    a capture is not an execution (the reference's traced-call rule).
    """
    from repro_torch.autotune.cost_model import estimate
    from repro_torch.observability.regret import default_auditor

    pred = dict(decision.scores).get(impl) if decision is not None else None
    if pred is None:
        try:
            pred = estimate(workload, impl)
        except ValueError:
            pred = None
        if pred == float("inf"):
            pred = None
    it = workload.itemsize
    # impl-independent floor: value+index slots once, B and C once each
    pred_bytes = (workload.batch * workload.nnz_pad * (it + 8)
                  + 2 * workload.batch * workload.m_pad * workload.n_b * it)
    args = {
        "impl": impl, "key": workload.key(), "batch": workload.batch,
        "m_pad": workload.m_pad, "nnz_pad": workload.nnz_pad,
        "k_pad": workload.k_pad, "n_b": workload.n_b,
        "dtype": workload.dtype, "op": workload.op,
        "reduce": workload.reduce, "predicted_s": pred,
        "predicted_bytes": pred_bytes,
    }
    if decision is not None:
        args["source"] = decision.source
        args["case"] = decision.case
    capturing = b.is_cuda and torch.cuda.is_current_stream_capturing()
    sync = b.is_cuda and not capturing
    if sync:
        torch.cuda.synchronize(b.device)
    t0 = time.perf_counter()
    with obs_trace.TRACER.span(f"spmm/{impl}", cat="kernel", args=args):
        out = f(values, b)
        if sync:
            torch.cuda.synchronize(b.device)
    if not capturing and pred is not None:
        default_auditor().record(workload.key(), impl, predicted_s=pred,
                                 measured_s=time.perf_counter() - t0)
    return out


# The backward class of each precision variant, checked before the base
# rules of bwd_impl_for. bf16 forwards keep a bf16 backward (f32 sums in
# the kernel); the ELL class falls to the COO class as its f32 base does.
# i8 forwards are straight-through: the residuals are the original f32
# values, so dB runs the f32 base class's backward.
_VARIANT_BWD = {
    "ell_bf16": "ref",
    "csr_bf16": "csr_bf16",
    "pallas_ell_bf16": "pallas_coo_bf16",
    "pallas_csr_bf16": "pallas_csr_bf16",
    "pallas_coo_bf16": "pallas_coo_bf16",
    "pallas_ell_i8": "pallas_coo",
    "pallas_csr_i8": "pallas_csr",
    "fused_bf16": "pallas_coo_bf16",
    "pallas_hybrid_bf16": "pallas_csr_bf16",
}


def bwd_impl_for(impl: str) -> str:
    """The impl the backward pass (dB = Aᵀ·dC) runs for a forward ``impl``.

    Aᵀ loses the per-row ELL bound, so ELL-class forwards fall to the COO
    class; the CSR class stays CSR (the swapped COO re-sorts into the exact
    transposed CSR). The hybrid class maps to the CSR class (its remainder
    is the CSR row split): its inverse permutation sits inside the forward,
    so cotangents arrive in original row order and Aᵀ is not re-sorted by
    its own degrees. ``pallas_gemm`` and both fused layers (dU = Aᵀ·dZ)
    take the COO kernel; ``dense`` stays dense. A precision variant maps
    through :data:`_VARIANT_BWD` first."""
    if impl in _VARIANT_BWD:
        return _VARIANT_BWD[impl]
    if impl in ("csr", "pallas_csr"):
        return impl
    if impl == "hybrid":
        return "csr"
    if impl == "pallas_hybrid":
        return "pallas_csr"
    if impl.startswith("pallas") or impl.startswith("fused"):
        return "pallas_coo"
    return impl if impl in ("ref", "loop", "dense") else "ref"


def _kernel_on_card(impl: str, b: torch.Tensor) -> bool:
    """Whether ``impl`` launches a kernel here: a kernel impl (pallas_ell,
    pallas_csr, pallas_coo, pallas_hybrid, pallas_gemm, and their precision
    variants) on a tensor off the CPU. At paper case 3 (too large for the
    batched shared-memory strategy) the reference takes its plain
    per-sample path, and so does the port on the CPU; on the card a kernel
    impl runs its kernel's large-matrix entry instead. Whether case 3
    applies is the plan's, decided by shapes and the variant's element
    size alone."""
    return precision_of(impl)[0] in KERNEL_IMPLS and b.device.type != "cpu"


def _kernel_ids(ids: torch.Tensor, m_pad: int, large: bool) -> torch.Tensor:
    """Ids for a reduced-precision kernel entry: int16; a large-matrix
    entry keeps int32 ids where ``m_pad`` is past int16's range."""
    if large and m_pad > INT16_MAX:
        return ids
    return narrow_col_ids(ids, m_pad)


def _forward(row_ids, col_ids, nnz, values, b, *, impl: str,
             k_pad: int | None) -> torch.Tensor:
    """One batched SpMM forward of ``impl`` on raw COO operands (no
    autograd): shared by the forward and by :func:`backward_db`.

    A precision variant splits into (base impl, policy), the reference's
    policy split: ``bf16`` casts the values and B to bfloat16 (the result
    is B's bf16, f32-summed); ``i8`` quantizes the values to int8 codes
    and a per-matrix scale applied after the f32 sum, B staying f32. Both
    narrow the ids to int16 on the kernel paths only, after the ELL k_pad
    guard and the CSR sort, and the result is cast back to B's dtype."""
    base, policy = precision_of(impl)
    if policy == "f32":
        return _forward_base(row_ids, col_ids, nnz, values, b, impl=impl,
                             base=impl, k_pad=k_pad)
    out_dtype = b.dtype
    scale = None
    if policy == "bf16":
        values, b = values.to(torch.bfloat16), b.to(torch.bfloat16)
    else:
        values, scale = quantize_values_i8(values)
    out = _forward_base(row_ids, col_ids, nnz, values, b.contiguous(),
                        impl=impl, base=base, k_pad=k_pad, scale=scale,
                        policy=policy)
    return out.to(out_dtype)


def _forward_base(row_ids, col_ids, nnz, values, b, *, impl: str, base: str,
                  k_pad: int | None, scale=None,
                  policy: str = "f32") -> torch.Tensor:
    """The forward of ``base`` on operands already in ``policy``'s storage
    (``scale`` the i8 codes' per-matrix scale): the plain impls run their
    plain versions, the kernel impls their kernel's entry for the policy.
    Paper case 3 takes the plain per-sample path on the CPU and the
    kernel's large-matrix entry on the card (:func:`_kernel_on_card`); the
    hybrid impls take the CSR one there, their backward class."""
    batch, m_pad, n_b = b.shape
    a = BatchedCOO(row_ids, col_ids, values, nnz,
                   torch.full((batch,), m_pad, dtype=torch.int32,
                              device=b.device))

    def dequant(out):
        # the i8 policy on a plain path: the kernels' epilogue scale
        return out if scale is None else out * scale[:, None, None]

    if base == "ref":
        return dequant(ref.batched_spmm_coo_ref(a, b, m_pad))
    if base == "loop":
        return torch.stack([
            ref.spmm_coo_single(row_ids[s], col_ids[s], values[s], b[s],
                                m_pad) for s in range(batch)])
    if base in ("dense", "pallas_gemm"):
        a_dense = coo_to_dense(a, m_pad)
        compute = resolve_compute_dtype(a_dense.dtype, b.dtype)
        a_dense, bb = a_dense.to(compute).contiguous(), b.to(compute)
        if base == "dense":
            return ref.batched_gemm_ref(a_dense, bb)
        gplan = batching.plan_batched_gemm(batch=batch, m=m_pad, n=n_b,
                                           k=m_pad)
        if gplan.case == 3 and not _kernel_on_card(impl, b):
            return ref.batched_gemm_plain(a_dense, bb)
        gemm = batched_gemm_large if gplan.case == 3 else batched_gemm
        return gemm(a_dense, bb, plan=gplan)
    itemsize = b.element_size()
    if base in ("hybrid", "pallas_hybrid"):
        hplan = batching.plan_hybrid(batch=batch, m_pad=m_pad, n_b=n_b,
                                     nnz_pad=row_ids.shape[1],
                                     itemsize=itemsize)
        if base == "hybrid":
            return batched_spmm_hybrid_ref(a, b, m_pad, plan=hplan)
        if hplan.spmm.case == 3:
            if not _kernel_on_card(impl, b):
                return ref.batched_spmm_coo_ref(a, b, m_pad)
            # the whole matrix through the CSR large-matrix entry of the
            # policy: the reference's plain COO sum there, and the hybrid's
            # backward class
            csr = coo_to_csr(a, m_pad)
            cplan = batching.plan_batched_spmm(batch=batch, m_pad=m_pad,
                                               n_b=n_b, itemsize=itemsize)
            if policy == "bf16":
                return batched_spmm_csr_large_bf16(
                    csr.rpt, _kernel_ids(csr.col_ids, m_pad, True),
                    csr.values, b, plan=cplan)
            return batched_spmm_csr_large(csr.rpt, csr.col_ids, csr.values,
                                          b, plan=cplan)
        hybrid = (batched_spmm_hybrid_bf16 if policy == "bf16"
                  else batched_spmm_hybrid)
        return hybrid(row_ids, col_ids, values, nnz, b, plan=hplan)
    plan = batching.plan_batched_spmm(batch=batch, m_pad=m_pad, n_b=n_b,
                                      itemsize=itemsize)
    large = plan.case == 3
    if base in ("csr", "pallas_csr"):
        csr = coo_to_csr(a, m_pad)
        if base == "csr" or (large and not _kernel_on_card(impl, b)):
            return dequant(ref.batched_spmm_csr_ref(csr, b))
        if policy == "f32":
            csr_f32 = batched_spmm_csr_large if large else batched_spmm_csr
            return csr_f32(csr.rpt, csr.col_ids, csr.values, b, plan=plan)
        cids = _kernel_ids(csr.col_ids, m_pad, large)
        if policy == "bf16":
            csr_bf16 = (batched_spmm_csr_large_bf16 if large
                        else batched_spmm_csr_bf16)
            return csr_bf16(csr.rpt, cids, csr.values, b, plan=plan)
        csr_i8 = batched_spmm_csr_large_i8 if large else batched_spmm_csr_i8
        return csr_i8(csr.rpt, cids, csr.values, scale, b, plan=plan)
    ell = base in ("ell", "pallas_ell")
    if ell:
        if k_pad is None:
            raise ValueError(f"{impl} requires k_pad (max nnz/row)")
        validate_ell_k_pad(a, m_pad, k_pad)
    if base == "pallas_coo":
        # every COO entry takes the f32 plan (its sums are f32)
        plan = batching.plan_batched_spmm(batch=batch, m_pad=m_pad, n_b=n_b)
        large = plan.case == 3
    if large and not _kernel_on_card(impl, b):
        return dequant(ref.batched_spmm_coo_ref(a, b, m_pad))
    if ell:
        e = coo_to_ell(a, m_pad, k_pad)
        if base == "ell":
            return dequant(ref.batched_spmm_ell_ref(e, b))
        if policy == "f32":
            ell_f32 = batched_spmm_ell_large if large else batched_spmm_ell
            return ell_f32(e.col_ids, e.values, b, plan=plan)
        cids = _kernel_ids(e.col_ids, m_pad, large)
        if policy == "bf16":
            ell_bf16 = (batched_spmm_ell_large_bf16 if large
                        else batched_spmm_ell_bf16)
            return ell_bf16(cids, e.values, b, plan=plan)
        ell_i8 = batched_spmm_ell_large_i8 if large else batched_spmm_ell_i8
        return ell_i8(cids, e.values, scale, b, plan=plan)
    if policy == "f32":
        coo_f32 = batched_spmm_coo_large if large else batched_spmm_coo
        return coo_f32(row_ids, col_ids, values, b, plan=plan)
    coo_bf16 = batched_spmm_coo_large_bf16 if large else batched_spmm_coo_bf16
    return coo_bf16(_kernel_ids(row_ids, m_pad, large),
                    _kernel_ids(col_ids, m_pad, large), values, b, plan=plan)


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
    return (_take_fill(dc, row_ids) * _take_fill(b, col_ids)).sum(dim=-1)


def _take_fill(t: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``t[s, ids[s, i]]`` in f32, with NaN rows for ids outside the matrix
    (the reference's filling gather): t (batch, m, n), ids (batch, slots)."""
    ok = (ids >= 0) & (ids < t.shape[1])
    return torch.where(ok[..., None], ref._gather_rows(t, ids), float("nan"))


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


def _check_spmm_operands(impl: str, a: BatchedCOO) -> None:
    if precision_of(impl)[0].startswith("fused"):
        raise ValueError(
            f"impl={impl!r} is the graph-conv LAYER kernel (it needs W and "
            "bias, not a bare dense operand) — call "
            f"repro_torch.core.graph_conv.graph_conv_batched(impl={impl!r})")
    if a.values.dim() != 2:
        raise ValueError("vector edge values are g-SpMM: call "
                         "batched_gspmm(op='mul', reduce='sum')")


def batched_spmm(a: BatchedCOO, b: torch.Tensor, *, impl: str = "auto",
                 k_pad: int | None = None, precision: str = "f32",
                 mesh=None, mesh_axis: str = "data") -> torch.Tensor:
    """C[s] = A[s] @ B[s] for every sample s of the batch.

    a: BatchedCOO over square (m_pad, m_pad) adjacencies with scalar edge
    values; b: (batch, m_pad, n_b). Differentiable in ``a.values`` and
    ``b``; on CUDA tensors a kernel impl's backward runs kernels too.
    ``impl="auto"`` resolves from the call's shapes (:func:`resolve_impl`)
    with ``precision`` as its storage policy; a concrete impl carries its
    own policy and ignores ``precision``.

    ``mesh=`` (a ``DeviceMesh``) routes the call through
    :func:`repro_torch.distributed.spmm.sharded_batched_spmm`: the batch
    split over ``mesh_axis``, ``auto`` resolved against the per-shard
    workload, the global result on every rank."""
    check_impl(impl)
    if mesh is not None:
        from repro_torch.distributed.spmm import sharded_batched_spmm

        _check_spmm_operands(impl, a)
        return sharded_batched_spmm(a, b, mesh=mesh, axis=mesh_axis,
                                    impl=impl, k_pad=k_pad,
                                    precision=precision)
    tele = obs_trace.enabled()
    decision = None
    if impl == "auto" or tele:
        # telemetry also resolves a CONCRETE impl (a forced Decision), so
        # the span carries the same workload, plan and case provenance
        decision = resolve_impl(a, b, impl=impl, k_pad=k_pad,
                                precision=precision)
        impl = decision.impl
    _check_spmm_operands(impl, a)
    if tele:
        return _traced_dispatch(
            lambda values, b: _SpMM.apply(values, b, a.row_ids, a.col_ids,
                                          a.nnz, impl, k_pad),
            a.values, b, impl=impl, decision=decision,
            workload=decision.workload)
    return _SpMM.apply(a.values, b, a.row_ids, a.col_ids, a.nnz, impl, k_pad)


def _gspmm_forward(row_ids, col_ids, nnz, values, b, *, impl: str,
                   k_pad: int | None, op: str, reduce: str) -> torch.Tensor:
    """One batched g-SpMM forward of ``impl`` (no autograd). Every path
    masks padding from the true ``nnz`` or the row degrees: the 0.0-valued
    padding is inert only under (mul, sum). At paper case 3 a kernel impl
    takes the oracle on the CPU and its kernel's large-matrix entry on the
    card."""
    batch, m_pad, n_b = b.shape
    a = BatchedCOO(row_ids, col_ids, values, nnz,
                   torch.full((batch,), m_pad, dtype=torch.int32,
                              device=b.device))
    if impl == "ref":
        return ref.batched_gspmm_ref(a, b, m_pad, op=op, reduce=reduce)
    if impl == "loop":
        return torch.stack([
            ref.gspmm_coo_single(row_ids[s], col_ids[s], values[s], b[s],
                                 m_pad, nnz[s], op=op, reduce=reduce)
            for s in range(batch)])

    plan = batching.plan_batched_spmm(batch=batch, m_pad=m_pad, n_b=n_b)
    large = plan.case == 3
    # paper case 3 on the CPU: the batched oracle, as in the reference
    oracle = large and not _kernel_on_card(impl, b)
    if impl in ("csr", "pallas_csr"):
        csr = coo_to_csr(a, m_pad)
        if impl == "csr":
            return ref.batched_gspmm_csr_ref(csr, b, op=op, reduce=reduce)
        if oracle:
            return ref.batched_gspmm_ref(a, b, m_pad, op=op, reduce=reduce)
        csr_f32 = batched_spmm_csr_large if large else batched_spmm_csr
        return csr_f32(csr.rpt, csr.col_ids, csr.values, b, plan=plan,
                       op=op, reduce=reduce)
    if impl in ("ell", "pallas_ell"):
        if k_pad is None:
            raise ValueError(f"{impl} requires k_pad (max nnz/row)")
        validate_ell_k_pad(a, m_pad, k_pad)
        # the ELL layout cannot tell a real 0.0 edge from a padded slot, so
        # the per-row live bound travels beside it
        rlen = row_degrees(a, m_pad)
        ell = coo_to_ell(a, m_pad, k_pad)
        if impl == "ell":
            return ref.batched_gspmm_ell_ref(ell, rlen, b, op=op,
                                             reduce=reduce)
        if oracle:
            return ref.batched_gspmm_ref(a, b, m_pad, op=op, reduce=reduce)
        ell_f32 = batched_spmm_ell_large if large else batched_spmm_ell
        return ell_f32(ell.col_ids, ell.values, b, plan=plan, rlen=rlen,
                       op=op, reduce=reduce)
    if impl == "pallas_coo":
        if oracle:
            return ref.batched_gspmm_ref(a, b, m_pad, op=op, reduce=reduce)
        coo_f32 = batched_spmm_coo_large if large else batched_spmm_coo
        return coo_f32(row_ids, col_ids, values, b, plan=plan, nnz=nnz,
                       op=op, reduce=reduce)
    raise ValueError(f"unknown g-SpMM impl {impl!r}; expected one of "
                     f"{GSPMM_IMPLS}")


def _scatter_add(msg: torch.Tensor, ids: torch.Tensor,
                 m: int) -> torch.Tensor:
    """out[s, ids[s, i]] += msg[s, i], ids outside ``[0, m)`` dropped."""
    return ref._scatter_rows(msg, ids, (ids >= 0) & (ids < m), m)


def gspmm_backward(row_ids, col_ids, nnz, values, b, c, dc, *, op: str,
                   reduce: str, impl: str, need_values: bool = True,
                   need_b: bool = True):
    """(dValues, dB) of one g-SpMM forward, the reference's VJP; a gradient
    that is not needed is None.

    ``mean`` pre-scales the cotangent by 1/deg and reduces to the sum
    backward. The (mul, sum/mean) scalar-edge corner keeps the batched SpMM
    backward of ``impl``'s class (:func:`backward_db` with the padded
    values zeroed, :func:`dvalues` masked to the valid slots). Every other
    corner is a gather/scatter: ``max`` routes each row's cotangent to the
    edges whose message equals the row's output (exact f32 equality: the
    forward computed the same expression), ties split evenly; dB scatters
    ``∂msg/∂B`` (e for mul, 1 otherwise) by column; dValues is the
    cotangent times the gathered B rows for mul (summed over the features
    for scalar edges), the bare cotangent for add and 0 for copy_lhs."""
    m_pad = b.shape[1]
    valid = ref._slots_below(nnz, row_ids.shape[1])
    rid_c = row_ids.long().clamp(0, m_pad - 1)
    dcf = dc.float()
    if reduce == "mean":
        # the row degrees, row ids clipped into range (formats.row_degrees)
        deg = dcf.new_zeros(dcf.shape[:2]).scatter_add_(1, rid_c,
                                                        valid.float())
        dcf = dcf / torch.clamp(deg, min=1.0)[..., None]
    scalar = values.dim() == 2
    if op == "mul" and reduce in ("sum", "mean") and scalar:
        dval = db = None
        if need_values:
            dval = (dvalues(row_ids, col_ids, dcf, b) * valid).to(
                values.dtype)
        if need_b:
            db = backward_db(row_ids, col_ids, nnz, values * valid,
                             dcf.contiguous(), impl=impl).to(b.dtype)
        return dval, db
    vmask = valid[..., None]
    u = _take_fill(b, col_ids)
    dmsg = ref._gather_rows(dcf, rid_c)
    if reduce == "max":
        msg = ref.gspmm_combine(u, values, op)
        win = ((msg == ref._gather_rows(c, rid_c)) & vmask).float()
        nwin = _scatter_add(win, rid_c, m_pad)
        dmsg = win * dmsg / torch.clamp(ref._gather_rows(nwin, rid_c),
                                        min=1.0)
    else:
        dmsg = torch.where(vmask, dmsg, 0.0)
    if op == "mul":
        e = values.float()[..., None] if scalar else values.float()
        db = _scatter_add(dmsg * e, col_ids, m_pad)
        dval = (dmsg * u).sum(dim=-1) if scalar else dmsg * u
    elif op == "add":
        db = _scatter_add(dmsg, col_ids, m_pad)
        dval = dmsg.sum(dim=-1) if scalar else dmsg
    else:   # copy_lhs: the edge value never enters the forward
        db = _scatter_add(dmsg, col_ids, m_pad)
        dval = torch.zeros(values.shape, dtype=torch.float32,
                           device=values.device)
    return (dval.to(values.dtype) if need_values else None,
            db.to(b.dtype) if need_b else None)


class _GSpMM(torch.autograd.Function):
    """g-SpMM with the reference's custom VJP (:func:`gspmm_backward`); the
    forward output is kept only for the max backward's routing."""

    @staticmethod
    def forward(ctx, values, b, row_ids, col_ids, nnz, impl, k_pad, op,
                reduce):
        c = _gspmm_forward(row_ids, col_ids, nnz, values, b, impl=impl,
                           k_pad=k_pad, op=op, reduce=reduce)
        ctx.save_for_backward(values, b, row_ids, col_ids, nnz,
                              c if reduce == "max" else None)
        ctx.impl, ctx.op, ctx.reduce = impl, op, reduce
        return c

    @staticmethod
    def backward(ctx, dc):
        values, b, row_ids, col_ids, nnz, c = ctx.saved_tensors
        dval, db = gspmm_backward(
            row_ids, col_ids, nnz, values, b, c, dc, op=ctx.op,
            reduce=ctx.reduce, impl=ctx.impl,
            need_values=ctx.needs_input_grad[0],
            need_b=ctx.needs_input_grad[1])
        return dval, db, None, None, None, None, None, None, None


def batched_gspmm(a: BatchedCOO, b: torch.Tensor, *, op: str = "mul",
                  reduce: str = "sum", impl: str = "auto",
                  k_pad: int | None = None, mesh=None,
                  mesh_axis: str = "data") -> torch.Tensor:
    """Generalized SpMM / message passing: per sample s,
    ``C[s][r] = reduce_{edges (r, c)} op(B[s][c], e)`` with ``e =
    a.values``, scalars (batch, nnz_pad) or vectors (batch, nnz_pad, d_e)
    with ``d_e`` equal to B's width. Differentiable in ``a.values`` and
    ``b``; rows of degree 0 give 0.0 with zero gradient for every reduce.

    (mul, sum) with scalar edges IS :func:`batched_spmm`, over its whole
    registry; every other corner runs :data:`GSPMM_IMPLS`, ``auto``
    resolving over them (:func:`resolve_gspmm_impl`). ``mesh=`` routes the
    call through :func:`repro_torch.distributed.spmm.sharded_batched_gspmm`
    (the batch split over ``mesh_axis``)."""
    if op not in GSPMM_OPS:
        raise ValueError(f"unknown g-SpMM op {op!r}; expected {GSPMM_OPS}")
    if reduce not in GSPMM_REDUCES:
        raise ValueError(
            f"unknown g-SpMM reduce {reduce!r}; expected {GSPMM_REDUCES}")
    if (op, reduce) == ("mul", "sum") and a.values.dim() == 2:
        return batched_spmm(a, b, impl=impl, k_pad=k_pad, mesh=mesh,
                            mesh_axis=mesh_axis)
    check_impl(impl)
    if mesh is not None:
        from repro_torch.distributed.spmm import sharded_batched_gspmm

        return sharded_batched_gspmm(a, b, op=op, reduce=reduce, mesh=mesh,
                                     axis=mesh_axis, impl=impl, k_pad=k_pad)
    tele = obs_trace.enabled()
    decision = None
    if impl == "auto" or tele:
        decision = resolve_gspmm_impl(a, b, op=op, reduce=reduce, impl=impl,
                                      k_pad=k_pad)
        impl = decision.impl
    if not supports_gspmm(impl):
        raise ValueError(
            f"impl {impl!r} cannot run g-SpMM (op={op!r}, reduce={reduce!r});"
            f" the capable set is {GSPMM_IMPLS} at f32")
    if tele:
        return _traced_dispatch(
            lambda values, b: _GSpMM.apply(values, b, a.row_ids, a.col_ids,
                                           a.nnz, impl, k_pad, op, reduce),
            a.values, b, impl=impl, decision=decision,
            workload=decision.workload)
    return _GSpMM.apply(a.values, b, a.row_ids, a.col_ids, a.nnz, impl,
                        k_pad, op, reduce)


def dense_batched_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``C[s] = A[s] · B[s]`` through the batched GEMM kernel (the
    reference's standalone entry point, benchmark use): a (batch, m, k),
    b (batch, k, n) f32. Like the reference, it runs at every size: where
    the A tile does not fit a block, through the K-tiled entry."""
    plan = batching.plan_batched_gemm(batch=a.shape[0], m=a.shape[1],
                                      n=b.shape[-1], k=a.shape[2])
    gemm = batched_gemm_large if plan.case == 3 else batched_gemm
    return gemm(a, b, plan=plan)
