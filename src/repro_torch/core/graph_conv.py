"""Graph convolution layer — paper Fig. 6 (non-batched) and Fig. 7 (batched).

Y = Σ_ch A_ch · (X · W_ch + bias_ch), summed over edge channels (bond types
in ChemGCN). The strategies compute the same function with different op
structure:

- ``graph_conv_nonbatched``  Fig. 6: one op per (sample × channel);
- ``graph_conv_batched``     Fig. 7 and beyond: ``impl="fused"``,
  ``"fused_hybrid"`` or ``"fused_bf16"`` runs the whole layer as ONE
  kernel; any SpMM impl (a precision variant too) runs the stacked form —
  one feature-transform einsum, ONE ``(channels·batch)`` batched SpMM, one
  channel sum.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from repro_torch.autotune.cost_model import precision_of
from repro_torch.core.formats import BatchedCOO, narrow_col_ids
from repro_torch.kernels.fused_graph_conv import fused_graph_conv
from repro_torch.kernels.ops import batched_spmm, check_impl
from repro_torch.kernels.ref import spmm_coo_single


def init_graph_conv(n_in: int, n_out: int, channels: int, *,
                    generator: torch.Generator | None = None,
                    device=None) -> dict:
    """W ~ U(-1/√n_in, 1/√n_in), zero bias (the reference's init, drawn from
    ``generator``)."""
    scale = 1.0 / math.sqrt(n_in)
    w = torch.rand((channels, n_in, n_out), generator=generator,
                   dtype=torch.float32) * (2 * scale) - scale
    return {"w": w.to(device),
            "b": torch.zeros((channels, n_out), dtype=torch.float32,
                             device=device)}


def stack_channels(adj: Sequence[BatchedCOO]):
    """Per-channel BatchedCOOs → channel-axis arrays for the fused kernel:
    (batch, channels, nnz_max) row/col/values + (batch, channels) true nnz.
    Channels with a smaller nnz_pad are padded with value 0.0, index 0."""
    nnz_max = max(a.nnz_pad for a in adj)

    def pad(t):
        return torch.nn.functional.pad(t, (0, nnz_max - t.shape[1]))

    rids = torch.stack([pad(a.row_ids) for a in adj], dim=1)
    cids = torch.stack([pad(a.col_ids) for a in adj], dim=1)
    vals = torch.stack([pad(a.values) for a in adj], dim=1)
    nnz = torch.stack([a.nnz for a in adj], dim=1)
    return rids, cids, vals, nnz


def flatten_channels(adj: Sequence[BatchedCOO]) -> BatchedCOO:
    """Concatenate the channel axis into the batch axis: one BatchedCOO of
    ``channels·batch`` samples (channel-major), for the stacked form's
    single SpMM call."""
    rids, cids, vals, nnz = stack_channels(adj)
    batch, channels, nnz_pad = rids.shape

    def flat(t):
        return t.transpose(0, 1).reshape(channels * batch, nnz_pad)

    return BatchedCOO(row_ids=flat(rids), col_ids=flat(cids),
                      values=flat(vals), nnz=nnz.transpose(0, 1).reshape(-1),
                      n_rows=adj[0].n_rows.repeat(channels))


def graph_conv_batched(params, adj: Sequence[BatchedCOO], x: torch.Tensor,
                       *, impl: str, k_pad: int | None = None,
                       epilogue: str = "none") -> torch.Tensor:
    """Paper Fig. 7 and beyond: the whole mini-batch's layer in O(1) ops.

    ``impl="fused"`` / ``"fused_hybrid"`` / ``"fused_bf16"`` runs the layer
    kernel; any other impl runs the stacked form with that SpMM (a
    precision variant applies its policy inside ``batched_spmm``).
    ``epilogue`` ("none"|"relu") runs inside the fused kernel, as a torch
    op otherwise.

    ``fused_bf16`` narrows the ids to int16 and casts the values, X, W and
    bias to bfloat16 before the kernel, and Y back to X's dtype after it,
    as the reference does. The casts are autograd ops, so the gradients
    are rounded to bf16 where the reference's ``astype`` VJPs round
    them."""
    check_impl(impl)
    base, policy = precision_of(impl)
    if base.startswith("fused"):
        rids, cids, vals, nnz = stack_channels(adj)
        xx, ww, bb = x, params["w"], params["b"]
        if policy == "bf16":
            m_pad = x.shape[1]
            rids = narrow_col_ids(rids, m_pad)
            cids = narrow_col_ids(cids, m_pad)
            vals, xx, ww, bb = (t.to(torch.bfloat16)
                                for t in (vals, xx, ww, bb))
        y = fused_graph_conv(rids, cids, vals, nnz, xx, ww, bb,
                             epilogue=epilogue, impl=impl)
        return y.to(x.dtype) if policy != "f32" else y
    channels = len(adj)
    batch, m_pad = x.shape[0], x.shape[1]
    n_out = params["w"].shape[-1]
    u = (torch.einsum("bmn,cnf->cbmf", x, params["w"])
         + params["b"][:, None, None, :])
    c = batched_spmm(flatten_channels(adj),
                     u.reshape(channels * batch, m_pad, n_out),
                     impl=impl, k_pad=k_pad)
    y = c.reshape(channels, batch, m_pad, n_out).sum(dim=0)
    return torch.relu(y) if epilogue == "relu" else y


def graph_conv_nonbatched(params, adj: Sequence[BatchedCOO],
                          x: torch.Tensor) -> torch.Tensor:
    """Paper Fig. 6: the per-(sample × channel) loop, the launch-per-sample
    structure the paper measures as its baseline."""
    rids, cids, vals, _ = stack_channels(adj)
    m_pad = x.shape[1]
    out = []
    for s in range(x.shape[0]):
        y = torch.zeros((m_pad, params["w"].shape[-1]), dtype=x.dtype,
                        device=x.device)
        for ch in range(len(adj)):
            u = x[s] @ params["w"][ch] + params["b"][ch]
            y = y + spmm_coo_single(rids[s, ch], cids[s, ch], vals[s, ch], u,
                                    m_pad)
        out.append(y)
    return torch.stack(out)
