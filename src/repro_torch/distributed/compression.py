"""Gradient compression: int8 error feedback (EF-SGD style), the
reference's ``distributed/compression.py``.

Each gradient leaf, plus the residual carried from the last step, is
quantized to int8 with one f32 scale per leaf (``max|g| / 127``, round half
to even as ``jnp.round``) and dequantized; the quantization error is the
new residual, added back at the next step (Karimireddy et al., 2019). The
arithmetic is the reference's, so on the same f32 inputs both packages give
the same bits.

On a mesh (``shards=``, a ``lm_mesh.Shards``) the gradients and the
residuals are this rank's moment shards, and the scale is still the whole
leaf's: the local ``max|g|`` is all-reduced (max) over the axes that split
the leaf, one all-reduce for all the leaves split alike.
"""
from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.distributed.sharding import split_axes
from repro_torch.launch.mesh import all_reduce_max


def _quant(g: torch.Tensor, err: torch.Tensor, top=None):
    """(dequantized, residual) of ``g + err``; ``top`` is the leaf's
    ``max|g + err|`` when this is one shard of it."""
    g = g.float() + err
    if top is None:
        top = g.abs().max()
    scale = torch.clamp(top, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq, g.sub_(deq)


def _leaf_maxima(grads: list, errs: list, shards) -> list:
    """Each leaf's ``max|g + err|`` over all its shards."""
    mesh = shards.mesh
    local = [(g.float() + e).abs().max() for g, e in zip(grads, errs)]
    out = list(local)
    groups: dict[tuple, list[int]] = {}
    for i, (_, m_spec) in enumerate(shards.pairs()):
        axes = tuple(split_axes(m_spec, mesh))
        if axes:
            groups.setdefault(axes, []).append(i)
    for axes, idx in groups.items():
        top = torch.stack([local[i] for i in idx])
        for a in axes:
            top = all_reduce_max(top, mesh, a)
        for j, i in enumerate(idx):
            out[i] = top[j]
    return out


def ef_init(params):
    """Zero f32 residuals shaped like ``params``."""
    return tree.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         params)


def ef_int8_compress_decompress(grads, ef_err, shards=None):
    """Returns (the dequantized grads, f32, and the new residuals), both
    shaped like ``grads``."""
    g_l, e_l = tree.leaves(grads), tree.leaves(ef_err)
    tops = ([None] * len(g_l) if shards is None
            else _leaf_maxima(g_l, e_l, shards))
    out = [_quant(g, e, top) for g, e, top in zip(g_l, e_l, tops,
                                                  strict=True)]
    return (tree.unflatten(grads, [o[0] for o in out]),
            tree.unflatten(grads, [o[1] for o in out]))
