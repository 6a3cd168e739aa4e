"""GNN layers on the g-SpMM message-passing primitive, the reference's
``models/gnn.py``. Both keep the paper's batched discipline — a handful of
batched ops per layer for the WHOLE mini-batch, no loop over samples or
heads:

- ``gat_layer`` (Graph Attention, arXiv:1710.10903): one einsum for every
  head's transform, two gathers of node-level scores per edge,
  :func:`~repro_torch.kernels.segment_softmax.segment_softmax` over each
  destination row's incoming edges, then ONE vector-edge (mul, sum) g-SpMM
  for every head, the heads flattened into the batch axis and the
  attention weights carried as edge feature vectors.
- ``rgcn_layer`` (Relational GCN, arXiv:1703.06103): every relation's
  transform in ONE ragged
  :func:`~repro_torch.kernels.grouped_matmul.grouped_matmul` over
  relation-major tokens, then ONE (copy_lhs, mean) g-SpMM over the
  relation-flattened batch.

Parameters are the reference's trees (GAT: ``w``, ``a_src``, ``a_dst``,
``b``; R-GCN: ``w_rel``, ``w_self``, ``b``), drawn from a
``torch.Generator`` with the reference's shapes and distributions.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from repro_torch.core.formats import BatchedCOO
from repro_torch.core.graph_conv import flatten_channels
from repro_torch.core.message_passing import message_passing
from repro_torch.kernels.grouped_matmul import grouped_matmul
from repro_torch.kernels.segment_softmax import segment_softmax


def _uniform(shape, scale, generator, device):
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return (u * (2 * scale) - scale).to(device)


def init_gat_layer(n_in: int, n_out: int, heads: int, *,
                   generator: torch.Generator | None = None,
                   device=None) -> dict:
    """Multi-head GAT parameters: per-head transform ``w`` to ``n_out //
    heads`` features, split attention vectors ``a_src``/``a_dst``
    (a·[h_i ‖ h_j] = a_src·h_j + a_dst·h_i) and a bias over the
    concatenated heads."""
    if n_out % heads:
        raise ValueError(f"n_out={n_out} not divisible by heads={heads}")
    d_head = n_out // heads
    scale = 1.0 / math.sqrt(n_in)
    return {
        "w": _uniform((heads, n_in, d_head), scale, generator, device),
        "a_src": _uniform((heads, d_head), scale, generator, device),
        "a_dst": _uniform((heads, d_head), scale, generator, device),
        "b": torch.zeros((n_out,), dtype=torch.float32, device=device),
    }


def gat_layer(params, adj: BatchedCOO, x: torch.Tensor, *,
              impl: str = "auto",
              k_pad: int | None = None, mesh=None,
              negative_slope: float = 0.2) -> torch.Tensor:
    """One multi-head graph-attention layer over x (batch, m_pad, n_in) →
    (batch, m_pad, n_out), the heads' outputs concatenated.

    ``alpha = segment_softmax(LeakyReLU(a_src·h[cid] + a_dst·h[rid]))`` per
    head, then ``out[r] = Σ_edges alpha · h[cid]`` for all heads as ONE
    (mul, sum) g-SpMM with head-major ``heads·batch`` samples and ``alpha``
    repeated over the head width as vector edges. The edge values of
    ``adj`` are ignored. The reference's gathers clamp an out-of-range id
    (the padding row id ``m_pad`` reads row ``m_pad - 1``); so do these,
    and ``segment_softmax`` masks those slots. ``mesh=`` shards the
    aggregation's head-flattened batch over the mesh's ``"data"`` axis; the
    transform, scores and softmax run on every rank's global tensors."""
    heads, _, d_head = params["w"].shape
    batch, m_pad, _ = x.shape
    nnz_pad = adj.row_ids.shape[1]

    h = torch.einsum("bmn,hnf->hbmf", x, params["w"])   # (heads, b, m, d)
    s_src = torch.einsum("hbmf,hf->hbm", h, params["a_src"])
    s_dst = torch.einsum("hbmf,hf->hbm", h, params["a_dst"])

    def gather(s, ids):
        idx = ids.long().clamp(0, m_pad - 1).expand(heads, batch, nnz_pad)
        return torch.gather(s, 2, idx)

    logits = gather(s_src, adj.col_ids) + gather(s_dst, adj.row_ids)
    logits = torch.where(logits >= 0, logits, negative_slope * logits)
    alpha = segment_softmax(logits.permute(1, 2, 0), adj.row_ids,
                            nnz=adj.nnz, m_pad=m_pad)   # (b, nnz_pad, heads)

    def flat(t):
        return t.expand((heads,) + t.shape).reshape(
            (heads * batch,) + t.shape[1:])

    e_vec = alpha.permute(2, 0, 1).reshape(heads * batch, nnz_pad, 1) \
        .expand(-1, -1, d_head).contiguous()
    a_flat = BatchedCOO(row_ids=flat(adj.row_ids), col_ids=flat(adj.col_ids),
                        values=e_vec, nnz=flat(adj.nnz),
                        n_rows=flat(adj.n_rows))
    out = message_passing(a_flat, h.reshape(heads * batch, m_pad, d_head),
                          op="mul", reduce="sum", impl=impl, k_pad=k_pad,
                          mesh=mesh)
    out = out.reshape(heads, batch, m_pad, d_head)
    return (out.permute(1, 2, 0, 3).reshape(batch, m_pad, heads * d_head)
            + params["b"])


def init_rgcn_layer(n_in: int, n_out: int, relations: int, *,
                    generator: torch.Generator | None = None,
                    device=None) -> dict:
    """R-GCN parameters: one weight per relation, stacked for the grouped
    matmul, a self-loop weight and a bias."""
    scale = 1.0 / math.sqrt(n_in)
    return {
        "w_rel": _uniform((relations, n_in, n_out), scale, generator, device),
        "w_self": _uniform((n_in, n_out), scale, generator, device),
        "b": torch.zeros((n_out,), dtype=torch.float32, device=device),
    }


def rgcn_layer(params, adj: Sequence[BatchedCOO], x: torch.Tensor, *,
               impl: str = "auto",
               k_pad: int | None = None, mesh=None) -> torch.Tensor:
    """One R-GCN layer: ``out[i] = Σ_r mean_{j ∈ N_r(i)} x[j]·W_r
    + x[i]·W_self + b``.

    The relation transforms are ONE grouped matmul over relation-major
    tokens (every graph's node block repeated per relation: equal groups of
    ``batch·m_pad`` rows, the reference's layout), the mean aggregation of
    every relation ONE (copy_lhs, mean) g-SpMM over the relation-flattened
    batch. ``x @ w_self`` is a plain product, outside the kernels.
    ``mesh=`` shards the aggregation's relation-flattened batch over the
    mesh's ``"data"`` axis; the grouped matmul stays local and replicated,
    as in the reference."""
    relations = len(adj)
    batch, m_pad, n_in = x.shape
    n_out = params["w_rel"].shape[-1]
    tokens = m_pad * batch

    xt = x.reshape(1, tokens, n_in).expand(relations, tokens, n_in) \
        .reshape(-1, n_in)
    sizes = torch.full((relations,), tokens, dtype=torch.int32,
                       device=x.device)
    h = grouped_matmul(xt, params["w_rel"], sizes)
    h = h.reshape(relations * batch, m_pad, n_out)
    agg = message_passing(flatten_channels(adj), h, op="copy_lhs",
                          reduce="mean", impl=impl, k_pad=k_pad, mesh=mesh)
    y = agg.reshape(relations, batch, m_pad, n_out).sum(dim=0)
    return y + x @ params["w_self"] + params["b"]
