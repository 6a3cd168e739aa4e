"""Per-row (segment) softmax over edge scores, the GAT normalizer:
``alpha[i] = exp(s[i] - max_row(s)) / Σ_{j: rid[j] = rid[i]} exp(s[j] - …)``
over each destination row's incoming edges (the valid slots of a
:class:`~repro_torch.core.formats.BatchedCOO` batch).

Plain PyTorch (the reference computes it in XLA, with no Pallas kernel).
The per-row max is subtracted before ``exp`` and the shifted argument is
masked to 0 first, so no inf appears; padded slots (``i ≥ nnz``) give
exactly 0 and take exactly 0 gradient; a row's denominator is clamped at
1e-30. Row ids are clipped into ``[0, m_pad)``. The backward is the
reference's VJP, ``ds[i] = alpha[i] · (g[i] - t[rid[i]])`` with
``t[r] = Σ_{j in row r} alpha[j] · g[j]``, not autograd through the
scatters. Scores are ``(batch, nnz_pad)`` or multi-head
``(batch, nnz_pad, h)``, one softmax per head.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import NEG_INF, _gather_rows


def _softmax(s, rid, valid, m_pad):
    batch, _, h = s.shape
    idx = rid[..., None].expand(s.shape)
    smax = s.new_full((batch, m_pad, h), NEG_INF).scatter_reduce_(
        1, idx, torch.where(valid, s, NEG_INF), "amax", include_self=True)
    # mask BEFORE exp: s - NEG_INF on an all-padding row would overflow
    shifted = torch.where(valid, s - _gather_rows(smax, rid), 0.0)
    z = torch.where(valid, torch.exp(shifted), 0.0)
    denom = s.new_zeros((batch, m_pad, h)).scatter_add_(1, idx, z)
    return z / torch.clamp(_gather_rows(denom, rid), min=1e-30)


class _SegmentSoftmax(torch.autograd.Function):

    @staticmethod
    def forward(ctx, s, rid, valid, m_pad):
        out = _softmax(s, rid, valid, m_pad)
        ctx.save_for_backward(out, rid)
        ctx.m_pad = m_pad
        return out

    @staticmethod
    def backward(ctx, g):
        out, rid = ctx.saved_tensors
        og = out * g.float()
        t = og.new_zeros((out.shape[0], ctx.m_pad, out.shape[-1]))
        t.scatter_add_(1, rid[..., None].expand(out.shape), og)
        return out * (g.float() - _gather_rows(t, rid)), None, None, None


def segment_softmax(scores: torch.Tensor, row_ids: torch.Tensor, *,
                    nnz: torch.Tensor, m_pad: int) -> torch.Tensor:
    """Numerically stable softmax of ``scores`` over each destination row's
    incoming edges; differentiable in ``scores``."""
    squeeze = scores.dim() == 2
    s3 = (scores[..., None] if squeeze else scores).float()
    slot = torch.arange(scores.shape[1], device=scores.device)
    valid = (slot[None, :] < nnz[:, None])[..., None]
    rid = row_ids.long().clamp(0, m_pad - 1)
    out = _SegmentSoftmax.apply(s3, rid, valid, m_pad).to(scores.dtype)
    return out[..., 0] if squeeze else out
