"""Graph convolution layer — paper Fig. 6 (non-batched) and Fig. 7 (batched).

Y = Σ_ch A_ch · (X · W_ch + bias_ch), summed over edge channels (bond types
in ChemGCN). The strategies compute the same function with different op
structure:

- ``graph_conv_nonbatched``  Fig. 6: one op per (sample × channel);
- ``graph_conv_batched``     Fig. 7 and beyond: ``impl="fused"``,
  ``"fused_hybrid"`` or ``"fused_bf16"`` runs the whole layer as ONE
  kernel; any SpMM impl (a precision variant too) runs the stacked form —
  one feature-transform einsum, ONE ``(channels·batch)`` batched SpMM, one
  channel sum. ``impl="auto"`` resolves per LAYER workload
  (:func:`resolve_graph_conv_impl`).
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


def resolve_graph_conv_impl(adj: Sequence[BatchedCOO], x: torch.Tensor,
                            n_out: int, *, impl: str = "auto",
                            k_pad: int | None = None, mesh=None,
                            mesh_axis: str = "data",
                            precision: str = "f32"):
    """Resolve ``impl`` against the LAYER workload of one graph-conv call:
    a ``repro_torch.autotune.Decision`` whose candidates are the fused
    kernels beside every SpMM impl priced as the stacked layer, and under a
    reduced ``precision`` their variants. Kernel impls are ranked only on
    CUDA tensors. With ``mesh=``, against the per-shard workload each rank
    runs. Host work alone: no PyTorch op, no sync."""
    from repro_torch import autotune

    batch, m_pad, n_in = x.shape
    dtype = precision_of(impl)[1] if impl != "auto" else precision
    w = autotune.Workload(
        batch=batch, m_pad=m_pad, nnz_pad=max(a.nnz_pad for a in adj),
        k_pad=k_pad, n_b=n_out, itemsize=x.element_size(),
        channels=len(adj), n_in=n_in, dtype=dtype)
    if mesh is not None:
        from repro_torch.distributed.spmm import shard_count

        w = w.shard(shard_count(mesh, mesh_axis))
    if impl != "auto":
        return autotune.forced_decision(w, impl)
    return autotune.select_graph_conv_impl(
        w, allow_pallas=x.device.type == "cuda",
        cache=autotune.default_cache())


def graph_conv_batched(params, adj: Sequence[BatchedCOO], x: torch.Tensor,
                       *, impl: str = "auto", k_pad: int | None = None,
                       mesh=None, epilogue: str = "none",
                       precision: str = "f32") -> torch.Tensor:
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
    them.

    ``impl="auto"`` resolves per layer workload with ``precision``
    ("f32"|"bf16"|"i8") as its storage policy; a pinned variant applies
    its own.

    ``mesh=`` (a ``DeviceMesh``) shards the batch over its ``"data"`` axis:
    the fused layer runs once per rank's slice
    (``distributed.spmm.sharded_fused_graph_conv``), the stacked form's
    SpMM through ``sharded_batched_spmm`` with the einsum and channel sum
    on the global tensors of every rank."""
    check_impl(impl)
    concrete = impl
    if impl == "auto":
        concrete = resolve_graph_conv_impl(
            adj, x, params["w"].shape[-1], k_pad=k_pad, mesh=mesh,
            precision=precision).impl
    base, policy = precision_of(concrete)
    if base.startswith("fused"):
        rids, cids, vals, nnz = stack_channels(adj)
        xx, ww, bb = x, params["w"], params["b"]
        if policy == "bf16":
            m_pad = x.shape[1]
            rids = narrow_col_ids(rids, m_pad)
            cids = narrow_col_ids(cids, m_pad)
            vals, xx, ww, bb = (t.to(torch.bfloat16)
                                for t in (vals, xx, ww, bb))
        if mesh is not None:
            from repro_torch.distributed.spmm import sharded_fused_graph_conv

            y = sharded_fused_graph_conv(rids, cids, vals, nnz, xx, ww, bb,
                                         mesh=mesh, epilogue=epilogue,
                                         impl=concrete)
        else:
            y = fused_graph_conv(rids, cids, vals, nnz, xx, ww, bb,
                                 epilogue=epilogue, impl=concrete)
        return y.to(x.dtype) if policy != "f32" else y
    channels = len(adj)
    batch, m_pad = x.shape[0], x.shape[1]
    n_out = params["w"].shape[-1]
    u = (torch.einsum("bmn,cnf->cbmf", x, params["w"])
         + params["b"][:, None, None, :])
    # on a mesh under "auto" the sharded SpMM re-resolves against the
    # per-shard stacked workload it runs; otherwise the layer's pick
    spmm_impl = "auto" if impl == "auto" and mesh is not None else concrete
    c = batched_spmm(flatten_channels(adj),
                     u.reshape(channels * batch, m_pad, n_out),
                     impl=spmm_impl, k_pad=k_pad, mesh=mesh,
                     precision=precision)
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
