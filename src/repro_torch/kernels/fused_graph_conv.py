"""Fused graph-conv layer: ``Y = epi(Σ_ch A_ch·(X·W_ch + b_ch) [+ res])`` in
ONE kernel launch per layer (paper Fig. 7 taken to one op).

The kernel is ``csrc/fused_graph_conv.cu``: one block per (sample ×
output-column panel) keeps the X tile, one channel's ``U_ch`` panel and the
accumulator in shared memory; ``U_ch`` never reaches device memory, and each
(sample × channel) scatter visits only its real ``ceil(nnz / CHUNK)`` chunks
(the reference's skew-aware bound). The plain version is
:func:`repro_torch.kernels.ref.fused_graph_conv_plain`. The backward
(:func:`fused_bwd`) is the reference's: dU = Aᵀ·dZ through the COO kernel,
then dense contractions. f32; the reference's hybrid ``rank``/``slab``
branch is not ported.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.batching import (
    CHUNK,
    BatchPlan,
    plan_fused_graph_conv,
)
from repro_torch.kernels import (
    _build,
    check_operand,
    check_plan,
    on_cpu,
    ref,
    stream_handle,
)
from repro_torch.kernels.ops import _forward, bwd_impl_for, dvalues

EPILOGUES = ("none", "relu")

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P,) * 9 + (_I,) * 9 + (_P,)


def fused_forward(row_ids: torch.Tensor, col_ids: torch.Tensor,
                  values: torch.Tensor, chunks: torch.Tensor, x: torch.Tensor,
                  w: torch.Tensor, bias: torch.Tensor,
                  residual: torch.Tensor | None = None, *,
                  plan: BatchPlan | None = None,
                  epilogue: str = "none") -> torch.Tensor:
    """Raw fused forward. ids/values (batch, channels, nnz_pad) int32/f32,
    chunks (batch, channels) int32 CHUNK counts (:func:`runtime_chunks`;
    0.0-valued slots inside them add nothing), x (batch, m_pad, n_in),
    w (channels, n_in, n_out), bias (channels, n_out), residual
    (batch, m_pad, n_out) or None → (batch, m_pad, n_out) f32."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue={epilogue!r}; expected one of {EPILOGUES}")
    if row_ids.dim() != 3 or x.dim() != 3 or w.dim() != 3:
        raise ValueError("fused_forward takes 3-D ids, x and w")
    batch, channels, nnz_pad = row_ids.shape
    m_pad, n_in = x.shape[1], x.shape[2]
    n_out = w.shape[-1]
    ids = (batch, channels, nnz_pad)
    check_operand("row_ids", row_ids, ids, torch.int32)
    check_operand("col_ids", col_ids, ids, torch.int32)
    check_operand("values", values, ids, torch.float32)
    check_operand("chunks", chunks, (batch, channels), torch.int32)
    check_operand("x", x, (batch, m_pad, n_in), torch.float32)
    check_operand("w", w, (channels, n_in, n_out), torch.float32)
    check_operand("bias", bias, (channels, n_out), torch.float32)
    if residual is not None:
        check_operand("residual", residual, (batch, m_pad, n_out),
                      torch.float32)
    plan = plan or plan_fused_graph_conv(batch=batch, m_pad=m_pad, n_in=n_in,
                                         n_out=n_out)
    check_plan(plan, batch=batch, m_pad=m_pad, n_b=n_out)
    if on_cpu(row_ids, col_ids, values, chunks, x, w, bias, residual):
        return ref.fused_graph_conv_plain(row_ids, col_ids, values, chunks,
                                          x, w, bias, residual, epilogue)
    out = torch.empty((batch, m_pad, n_out), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = _build.entry("fused_graph_conv", "fused_graph_conv_f32", _ARGTYPES)
    code = fn(row_ids.data_ptr(), col_ids.data_ptr(), values.data_ptr(),
              chunks.data_ptr(), x.data_ptr(), w.data_ptr(), bias.data_ptr(),
              None if residual is None else residual.data_ptr(),
              out.data_ptr(), batch, channels, nnz_pad, CHUNK, m_pad, n_in,
              n_out, plan.n_block, int(epilogue == "relu"), stream_handle())
    _build.check("fused_graph_conv", code)
    fused_forward.launches += 1
    return out


fused_forward.launches = 0


def runtime_chunks(nnz: torch.Tensor) -> torch.Tensor:
    """Skew-aware chunk counts ``ceil(nnz / CHUNK)`` per (sample × channel),
    from the BatchedCOO ``nnz`` metadata."""
    return ((nnz + CHUNK - 1) // CHUNK).to(torch.int32)


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
    def forward(ctx, values, x, w, bias, residual, rids, cids, chunks, plan,
                epilogue):
        y = fused_forward(rids, cids, values, chunks, x, w, bias, residual,
                          plan=plan, epilogue=epilogue)
        ctx.save_for_backward(rids, cids, values, x, w, bias, y)
        ctx.epilogue = epilogue
        return y

    @staticmethod
    def backward(ctx, dy):
        rids, cids, values, x, w, bias, y = ctx.saved_tensors
        grads = fused_bwd(rids, cids, values, x, w, bias, y, dy,
                          epilogue=ctx.epilogue,
                          bwd_impl=bwd_impl_for("fused"),
                          needs=ctx.needs_input_grad[:5])
        return grads + (None,) * 5


def fused_graph_conv(row_ids: torch.Tensor, col_ids: torch.Tensor,
                     values: torch.Tensor, nnz: torch.Tensor,
                     x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, *,
                     epilogue: str = "none",
                     residual: torch.Tensor | None = None) -> torch.Tensor:
    """``Y = epilogue(Σ_ch A_ch·(X·W_ch + b_ch) [+ residual])`` in one device
    op, ``nnz`` (batch, channels) being each channel's true non-zero count.
    Differentiable in ``values``, ``x``, ``w``, ``bias`` and ``residual``;
    on CUDA tensors the backward's dU runs the COO kernel."""
    plan = plan_fused_graph_conv(batch=x.shape[0], m_pad=x.shape[1],
                                 n_in=x.shape[2], n_out=w.shape[-1])
    if plan.case == 3:
        raise ValueError(
            f"m_pad={plan.m_pad} is planner case 3: the fused kernel does "
            "not batch matrices this large — use the stacked "
            "graph_conv_batched fallback")
    return _FusedGraphConv.apply(values, x, w, bias, residual, row_ids,
                                 col_ids, runtime_chunks(nnz), plan,
                                 epilogue)
