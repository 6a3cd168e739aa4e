"""Gradient compression: int8 error feedback (EF-SGD style), the
reference's ``distributed/compression.py``.

Each gradient leaf, plus the residual carried from the last step, is
quantized to int8 with one f32 scale per leaf (``max|g| / 127``, round half
to even as ``jnp.round``) and dequantized; the quantization error is the
new residual, added back at the next step (Karimireddy et al., 2019). The
arithmetic is the reference's, so on the same f32 inputs both packages give
the same bits.
"""
from __future__ import annotations

import torch

from repro_torch import tree


def _quant(g: torch.Tensor, err: torch.Tensor):
    g = g.float() + err
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq, g.sub_(deq)


def ef_init(params):
    """Zero f32 residuals shaped like ``params``."""
    return tree.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         params)


def ef_int8_compress_decompress(grads, ef_err):
    """Returns (the dequantized grads, f32, and the new residuals), both
    shaped like ``grads``."""
    out = [_quant(g, e) for g, e in zip(tree.leaves(grads),
                                        tree.leaves(ef_err), strict=True)]
    return (tree.unflatten(grads, [o[0] for o in out]),
            tree.unflatten(grads, [o[1] for o in out]))
