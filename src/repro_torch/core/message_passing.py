"""Message passing, the g-SpMM primitive as a layer building block beside
``repro_torch.core.graph_conv``: per sample,
``out[r] = reduce_{edges (r, c)} op(x[c], e)`` with a static ``(op,
reduce)`` and edge values ``e`` that are scalars or per-edge feature
vectors — ONE batched call for the whole mini-batch, or one per rank's
slice under a mesh. The GNN layers built on it are in
``repro_torch.models.gnn``.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import BatchedCOO
from repro_torch.kernels.ops import batched_gspmm, resolve_gspmm_impl


def resolve_message_passing_impl(adj: BatchedCOO, x: torch.Tensor, *,
                                 op: str = "mul", reduce: str = "sum",
                                 impl: str = "auto",
                                 k_pad: int | None = None, mesh=None,
                                 mesh_axis: str = "data"):
    """Resolve ``impl`` against one message-passing call's workload: a
    ``repro_torch.autotune.Decision`` over the g-SpMM-capable ladder. With
    ``mesh=``, against the per-shard workload each rank runs."""
    if mesh is not None:
        from repro_torch.distributed.spmm import resolve_sharded_gspmm_impl

        return resolve_sharded_gspmm_impl(adj, x, mesh, op=op, reduce=reduce,
                                          axis=mesh_axis, impl=impl,
                                          k_pad=k_pad)
    return resolve_gspmm_impl(adj, x, op=op, reduce=reduce, impl=impl,
                              k_pad=k_pad)


def message_passing(adj: BatchedCOO, x: torch.Tensor, *, op: str = "mul",
                    reduce: str = "sum", impl: str = "auto",
                    k_pad: int | None = None, mesh=None,
                    mesh_axis: str = "data") -> torch.Tensor:
    """One batched message-passing step over x (batch, m_pad, n_b) with
    ``e = adj.values``, scalar per edge or a (batch, nnz_pad, d_e) vector
    with ``d_e == n_b``. Differentiable in ``adj.values`` and ``x``; rows of
    degree 0 give 0.0 for every reduce. (mul, sum) with scalar edges is
    exactly ``batched_spmm``. ``mesh=`` shards the batch over
    ``mesh_axis`` (``repro_torch.distributed.spmm``)."""
    return batched_gspmm(adj, x, op=op, reduce=reduce, impl=impl,
                         k_pad=k_pad, mesh=mesh, mesh_axis=mesh_axis)
