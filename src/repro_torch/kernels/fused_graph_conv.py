"""Fused graph-conv layer: ``Y = epi(Σ_ch A_ch·(X·W_ch + b_ch) [+ res])`` in
ONE kernel launch per layer (paper Fig. 7 taken to one op).

The kernel is ``csrc/fused_graph_conv.cu``: one block per (sample ×
output-column panel) streams X and W through shared memory in k-tiles and
keeps one channel's ``U_ch`` panel and the accumulator there; ``U_ch``
never reaches device memory, and each (sample × channel) scatter visits
only its real ``ceil(nnz / CHUNK)`` chunks (the reference's skew-aware
bound). Matrices whose panels do not fit a block (``plan.large``) take
the kernel's large-matrix branch: two kernels in the one entry call, the
first writing every ``U_ch`` to a scratch the wrapper allocates
(:func:`repro_torch.core.batching.fused_large_scratch`), the second
owning output rows, bitwise repeatable. The plain version is
:func:`repro_torch.kernels.ref.fused_graph_conv_plain`. The backward
(:func:`fused_bwd`) is the reference's: dU = Aᵀ·dZ through the COO kernel,
then dense contractions. f32.

``impl="fused_hybrid"`` (:func:`fused_hybrid_forward`) folds the
degree-binned hybrid split into the same kernel: rows whose degree over
all channels reaches the hub threshold leave the scatter for per-channel
dense slabs, the accumulator is kept in degree-sorted row order and the
epilogue restores the original order; the head runs over each sample's
hub rows only (``hubs``). The backward runs on the original arrays,
unchanged.

``impl="fused_bf16"`` (:func:`fused_forward_bf16`) is the reference
kernel's bf16 branch: int16 ids, bf16 values, X, W, bias and Y. The
transform ``U = X·W + b`` runs on the tensor cores (bf16 products summed in
f32) and is never rounded; only Y is stored as bf16. Its backward takes dU
through the bf16 COO kernel (``bwd_impl_for``) and returns each gradient in
its operand's bf16 dtype, as the reference's does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.batching import (
    CHUNK,
    BatchPlan,
    HybridPlan,
    fused_large_scratch,
    plan_fused_graph_conv,
    plan_hybrid,
)
from repro_torch.kernels import (
    _build,
    check_operand,
    check_plan,
    on_cpu,
    ref,
    stream_handle,
)
from repro_torch.kernels.batched_spmm_hybrid import hub_slab
from repro_torch.kernels.ops import _forward, bwd_impl_for, dvalues

EPILOGUES = ("none", "relu")
FUSED_IMPLS = ("fused", "fused_hybrid", "fused_bf16")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = (_P,) * 10 + (_L,) + (_I,) * 10 + (_P,)
_HYBRID_ARGTYPES = (_P,) * 13 + (_L,) + (_I,) * 11 + (_P,)


def fused_forward(row_ids: torch.Tensor, col_ids: torch.Tensor,
                  values: torch.Tensor, chunks: torch.Tensor, x: torch.Tensor,
                  w: torch.Tensor, bias: torch.Tensor,
                  residual: torch.Tensor | None = None,
                  rank: torch.Tensor | None = None,
                  slab: torch.Tensor | None = None, *,
                  plan: BatchPlan | None = None,
                  epilogue: str = "none",
                  hubs: torch.Tensor | None = None) -> torch.Tensor:
    """Raw fused forward. ids/values (batch, channels, nnz_pad) int32/f32,
    chunks (batch, channels) int32 CHUNK counts (:func:`runtime_chunks`;
    0.0-valued slots inside them add nothing), x (batch, m_pad, n_in),
    w (channels, n_in, n_out), bias (channels, n_out), residual
    (batch, m_pad, n_out) or None → (batch, m_pad, n_out) f32.

    ``rank`` (batch, m_pad) int32 and ``slab`` (batch, channels, d_pad,
    m_pad) f32, set together by :func:`fused_hybrid_forward`, switch on the
    hybrid branch (the row ids are then degree-sorted positions); its
    launches count in ``fused_hybrid_forward.launches``. ``hubs`` (batch,)
    int32 bounds each sample's head to its first ``hubs[s]`` slab rows (the
    rest taken as zero, as :func:`fused_hybrid_operands` builds them);
    None runs all ``d_pad``."""
    return _fused(row_ids, col_ids, values, chunks, x, w, bias, residual,
                  rank, slab, hubs, plan, epilogue, bf16=False)


def fused_forward_bf16(row_ids: torch.Tensor, col_ids: torch.Tensor,
                       values: torch.Tensor, chunks: torch.Tensor,
                       x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                       residual: torch.Tensor | None = None, *,
                       plan: BatchPlan | None = None,
                       epilogue: str = "none") -> torch.Tensor:
    """The bf16 entry: ids (batch, channels, nnz_pad) int16, values, x, w,
    bias and residual bf16 → Y (batch, m_pad, n_out) bf16, rounded once
    from the f32 accumulator; the plan sized for bf16 k-tiles."""
    return _fused(row_ids, col_ids, values, chunks, x, w, bias, residual,
                  None, None, None, plan, epilogue, bf16=True)


def _fused(row_ids, col_ids, values, chunks, x, w, bias, residual, rank,
           slab, hubs, plan, epilogue, *, bf16: bool) -> torch.Tensor:
    """Checks, then the plain version on CPU tensors or the f32, hybrid or
    bf16 entry of the kernel, each counted in its own wrapper."""
    if (rank is None) != (slab is None):
        raise ValueError("rank and slab are set together")
    if hubs is not None and slab is None:
        raise ValueError("hubs bounds the hybrid branch: it needs the slab")
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue={epilogue!r}; expected one of {EPILOGUES}")
    if row_ids.dim() != 3 or x.dim() != 3 or w.dim() != 3:
        raise ValueError("fused_forward takes 3-D ids, x and w")
    batch, channels, nnz_pad = row_ids.shape
    m_pad, n_in = x.shape[1], x.shape[2]
    n_out = w.shape[-1]
    ids = (batch, channels, nnz_pad)
    id_t = torch.int16 if bf16 else torch.int32
    dt = torch.bfloat16 if bf16 else torch.float32
    check_operand("row_ids", row_ids, ids, id_t)
    check_operand("col_ids", col_ids, ids, id_t)
    check_operand("values", values, ids, dt)
    check_operand("chunks", chunks, (batch, channels), torch.int32)
    check_operand("x", x, (batch, m_pad, n_in), dt)
    check_operand("w", w, (channels, n_in, n_out), dt)
    check_operand("bias", bias, (channels, n_out), dt)
    if residual is not None:
        check_operand("residual", residual, (batch, m_pad, n_out), dt)
    if slab is not None:
        d_pad = slab.shape[2] if slab.dim() == 4 else -1
        if not 1 <= d_pad <= m_pad:
            raise ValueError(f"slab: shape {tuple(slab.shape)}, expected "
                             f"(batch, channels, d_pad, m_pad), 1 <= d_pad "
                             f"<= m_pad")
        check_operand("rank", rank, (batch, m_pad), torch.int32)
        check_operand("slab", slab, (batch, channels, d_pad, m_pad),
                      torch.float32)
        if hubs is not None:
            check_operand("hubs", hubs, (batch,), torch.int32)
    plan = plan or plan_fused_graph_conv(batch=batch, m_pad=m_pad, n_in=n_in,
                                         n_out=n_out,
                                         itemsize=x.element_size())
    check_plan(plan, batch=batch, m_pad=m_pad, n_b=n_out)
    if on_cpu(row_ids, col_ids, values, chunks, x, w, bias, residual, rank,
              slab, hubs):
        return ref.fused_graph_conv_plain(row_ids, col_ids, values, chunks,
                                          x, w, bias, residual, epilogue,
                                          rank, slab, hubs)
    out = torch.empty((batch, m_pad, n_out), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    scratch, floats = None, 0
    if plan.large:
        floats, _ = fused_large_scratch(batch=batch, channels=channels,
                                        m_pad=m_pad, n_out=n_out,
                                        n_block=plan.n_block)
        scratch = torch.empty(floats, dtype=torch.float32, device=x.device)
    head = (row_ids.data_ptr(), col_ids.data_ptr(), values.data_ptr(),
            chunks.data_ptr(), x.data_ptr(), w.data_ptr(), bias.data_ptr(),
            None if residual is None else residual.data_ptr())
    tail = (None if scratch is None else scratch.data_ptr(), floats, batch,
            channels, nnz_pad, CHUNK, m_pad, n_in, n_out, plan.n_block)
    relu, large = int(epilogue == "relu"), int(plan.large)
    if slab is None:
        entry = "fused_graph_conv_bf16" if bf16 else "fused_graph_conv_f32"
        fn = _build.entry("fused_graph_conv", entry, _ARGTYPES)
        code = fn(*head, out.data_ptr(), *tail, relu, large, stream_handle())
        counted = fused_forward_bf16 if bf16 else fused_forward
    else:
        fn = _build.entry("fused_graph_conv", "fused_graph_conv_hybrid_f32",
                          _HYBRID_ARGTYPES)
        code = fn(*head, rank.data_ptr(), slab.data_ptr(),
                  None if hubs is None else hubs.data_ptr(), out.data_ptr(),
                  *tail, slab.shape[2], relu, large, stream_handle())
        counted = fused_hybrid_forward
    _build.check("fused_graph_conv", code)
    counted.launches += 1
    return out


fused_forward.launches = 0
fused_forward_bf16.launches = 0


def runtime_chunks(nnz: torch.Tensor) -> torch.Tensor:
    """Skew-aware chunk counts ``ceil(nnz / CHUNK)`` per (sample × channel),
    from the BatchedCOO ``nnz`` metadata."""
    return ((nnz + CHUNK - 1) // CHUNK).to(torch.int32)


def fused_hybrid_operands(row_ids: torch.Tensor, col_ids: torch.Tensor,
                          values: torch.Tensor, m_pad: int,
                          hplan: HybridPlan):
    """The prep of :func:`fused_hybrid_forward`, on the tensors' device and
    without reading anything back to the host: ``(rid_s, cid_s, val_s,
    chunks, rank, slab, hubs)`` for :func:`fused_forward` (``hubs`` by
    keyword).

    A row's degree is summed over the channels, counting the slots whose
    value is non-zero (padding carries 0.0 and may sit anywhere in the
    visited chunks). Rows are stably sorted by descending degree; every
    slot targets its row's sorted position, and the slots of the first
    ``n_dense`` sorted rows (the hubs, ``hubs`` per sample, int32) leave the
    scatter for per-channel ``(d_pad, m_pad)`` slabs through the ``m_pad``
    sentinel; slab rows at or past ``hubs`` stay zero. The live sparse slots
    are compacted to the front of each channel, so the chunk counts shrink
    by what the slabs took. Needs ``hplan.d_pad > 0``."""
    batch, channels, nnz_pad = row_ids.shape
    live = values != 0
    rid_c = row_ids.long().clamp(0, m_pad - 1)
    cid_c = col_ids.clamp(0, m_pad - 1)
    deg = torch.zeros((batch, m_pad + 1), dtype=torch.int32,
                      device=row_ids.device)
    deg.scatter_add_(1, torch.where(live, rid_c, m_pad).reshape(batch, -1),
                     torch.ones_like(rid_c, dtype=torch.int32)
                     .reshape(batch, -1))
    deg = deg[:, :m_pad]
    perm = torch.argsort(-deg, dim=1, stable=True)
    rank = torch.argsort(perm, dim=1, stable=True).to(torch.int32)
    n_dense = (deg >= hplan.dmin).sum(dim=1).clamp(max=hplan.d_pad)
    # every slot's sorted row; the hubs are the first n_dense sorted rows
    pos = torch.gather(rank, 1, rid_c.reshape(batch, -1)).reshape(
        rid_c.shape)
    is_hub = pos < n_dense[:, None, None]
    rid_m = torch.where(is_hub, m_pad, pos)
    live_sp = live & ~is_hub
    order = torch.argsort((~live_sp).to(torch.int32), dim=2, stable=True)
    rid_s = torch.gather(rid_m, 2, order)
    cid_s = torch.gather(col_ids, 2, order)
    val_s = torch.gather(values, 2, order)
    chunks = runtime_chunks(live_sp.sum(dim=2))
    flat = batch * channels, nnz_pad
    slab = hub_slab(hplan.d_pad, m_pad, pos.reshape(flat),
                    is_hub.reshape(flat), cid_c.reshape(flat),
                    values.reshape(flat))
    return (rid_s, cid_s, val_s, chunks, rank,
            slab.view(batch, channels, hplan.d_pad, m_pad),
            n_dense.to(torch.int32))


def fused_hybrid_forward(row_ids: torch.Tensor, col_ids: torch.Tensor,
                         values: torch.Tensor, nnz: torch.Tensor,
                         x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                         residual: torch.Tensor | None = None, *,
                         plan: BatchPlan | None = None, hplan: HybridPlan,
                         epilogue: str = "none") -> torch.Tensor:
    """The hybrid split folded into the fused kernel, the reference's
    ``fused_hybrid_forward``: :func:`fused_hybrid_operands` in PyTorch ops,
    then one :func:`fused_forward` launch whose accumulator is in sorted
    row order and whose epilogue restores the original order. With
    ``hplan.d_pad == 0`` no row can be a hub and the plain fused kernel
    runs, as in the reference. The kernel's head runs over each sample's
    hub rows only."""
    m_pad = x.shape[1]
    if hplan.spmm.m_pad != m_pad:
        raise ValueError(f"{hplan} does not match m_pad={m_pad} (the hybrid "
                         "split takes m_pad a multiple of 8)")
    if hplan.d_pad == 0:
        return fused_forward(row_ids, col_ids, values, runtime_chunks(nnz),
                             x, w, bias, residual, plan=plan,
                             epilogue=epilogue)
    rid_s, cid_s, val_s, chunks, rank, slab, hubs = fused_hybrid_operands(
        row_ids, col_ids, values, m_pad, hplan)
    return fused_forward(rid_s, cid_s, val_s, chunks, x, w, bias, residual,
                         rank, slab, plan=plan, epilogue=epilogue, hubs=hubs)


fused_hybrid_forward.launches = 0


def fused_bwd(rids, cids, values, x, w, bias, y, dy, *, epilogue: str,
              bwd_impl: str, needs: tuple[bool, ...]):
    """Backward through the fused layer: (dvalues, dx, dw, dbias,
    dresidual), each None unless ``needs`` (values, x, w, bias, residual)
    asks for it.

    dZ = dY masked by the epilogue; dU_ch = A_chᵀ·dZ runs as ONE
    channel-stacked batched SpMM of ``bwd_impl`` with the ids swapped, over
    every slot (``nnz = nnz_pad``: padded slots carry 0.0); dValues is the
    gather-dot of dZ against the recomputed U_ch; dX, dW and dbias are dense
    contractions of dU."""
    need_val, need_x, need_w, need_b, need_res = needs
    batch, channels, nnz_pad = rids.shape
    m_pad, n_out = x.shape[1], w.shape[-1]
    dz = dy.float()
    if epilogue == "relu":
        dz = dz * (y > 0)

    def flat(t):
        return t.transpose(0, 1).reshape(channels * batch, nnz_pad)

    rids_f, cids_f, vals_f = flat(rids), flat(cids), flat(values)
    # channel-major stacking, materialised: the kernels take contiguous
    # operands
    dz_f = dz[None].expand(channels, batch, m_pad, n_out).reshape(
        channels * batch, m_pad, n_out).contiguous()
    dvals = dx = dw = db = None
    if need_val:
        u = (torch.einsum("bmn,cnf->cbmf", x.float(), w.float())
             + bias.float()[:, None, None, :])
        dvals = dvalues(rids_f, cids_f, dz_f,
                        u.reshape(channels * batch, m_pad, n_out))
        dvals = dvals.reshape(channels, batch, nnz_pad).transpose(0, 1)
        dvals = dvals.to(values.dtype)
    if need_x or need_w or need_b:
        nnz_f = torch.full((channels * batch,), nnz_pad, dtype=torch.int32,
                           device=dz.device)
        du = _forward(cids_f, rids_f, nnz_f, vals_f, dz_f, impl=bwd_impl,
                      k_pad=None).float().reshape(channels, batch, m_pad,
                                                  n_out)
        if need_x:
            dx = torch.einsum("cbmf,cnf->bmn", du, w.float()).to(x.dtype)
        if need_w:
            dw = torch.einsum("bmn,cbmf->cnf", x.float(), du).to(w.dtype)
        if need_b:
            db = du.sum(dim=(1, 2)).to(bias.dtype)
    return dvals, dx, dw, db, (dz if need_res else None)


class _FusedGraphConv(torch.autograd.Function):
    """The fused layer with the reference's VJP (:func:`fused_bwd`)."""

    @staticmethod
    def forward(ctx, values, x, w, bias, residual, rids, cids, nnz, plan,
                hplan, epilogue, impl):
        if impl == "fused_bf16":
            y = fused_forward_bf16(rids, cids, values, runtime_chunks(nnz), x,
                                   w, bias, residual, plan=plan,
                                   epilogue=epilogue)
        elif hplan is None:
            y = fused_forward(rids, cids, values, runtime_chunks(nnz), x, w,
                              bias, residual, plan=plan, epilogue=epilogue)
        else:
            y = fused_hybrid_forward(rids, cids, values, nnz, x, w, bias,
                                     residual, plan=plan, hplan=hplan,
                                     epilogue=epilogue)
        ctx.save_for_backward(rids, cids, values, x, w, bias, y)
        ctx.epilogue = epilogue
        ctx.impl = impl
        return y

    @staticmethod
    def backward(ctx, dy):
        rids, cids, values, x, w, bias, y = ctx.saved_tensors
        grads = fused_bwd(rids, cids, values, x, w, bias, y, dy,
                          epilogue=ctx.epilogue,
                          bwd_impl=bwd_impl_for(ctx.impl),
                          needs=ctx.needs_input_grad[:5])
        return grads + (None,) * 7


def fused_graph_conv(row_ids: torch.Tensor, col_ids: torch.Tensor,
                     values: torch.Tensor, nnz: torch.Tensor,
                     x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, *,
                     epilogue: str = "none",
                     residual: torch.Tensor | None = None,
                     impl: str = "fused") -> torch.Tensor:
    """``Y = epilogue(Σ_ch A_ch·(X·W_ch + b_ch) [+ residual])`` in one device
    op, ``nnz`` (batch, channels) being each channel's true non-zero count.
    ``impl`` is ``"fused"``, ``"fused_hybrid"`` (hub rows judged on the
    layer's whole edge budget, ``channels · nnz_pad`` slots) or
    ``"fused_bf16"`` (int16 ids and bf16 operands, as
    :func:`repro_torch.core.graph_conv.graph_conv_batched` casts them).
    Differentiable in ``values``, ``x``, ``w``, ``bias`` and ``residual``;
    on CUDA tensors the backward's dU runs the COO kernel (its bf16 entry
    for ``fused_bf16``)."""
    if impl not in FUSED_IMPLS:
        raise ValueError(f"impl={impl!r}; expected one of {FUSED_IMPLS}")
    batch, channels, nnz_pad = row_ids.shape
    plan = plan_fused_graph_conv(batch=batch, m_pad=x.shape[1],
                                 n_in=x.shape[2], n_out=w.shape[-1],
                                 itemsize=x.element_size())
    if plan.case == 3:
        raise ValueError(
            f"m_pad={plan.m_pad} is planner case 3 (> LARGE_M): the fused "
            "kernel does not batch matrices this large — use the stacked "
            "graph_conv_batched fallback")
    hplan = None
    if impl == "fused_hybrid":
        hplan = plan_hybrid(batch=batch, m_pad=x.shape[1], n_b=w.shape[-1],
                            nnz_pad=channels * nnz_pad)
    return _FusedGraphConv.apply(values, x, w, bias, residual, row_ids,
                                 col_ids, nnz, plan, hplan, epilogue, impl)
