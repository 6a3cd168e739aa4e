"""AdamW over a pytree of tensors, the reference's ``optim/adam.py``.

The state mirrors the parameter tree: ``m`` and ``v`` have its structure
(f32) and ``step`` is a 0-d int32 tensor. The arithmetic is the
reference's, bias corrections in f32 included. Unlike the reference, which
is functional, :func:`adam_update` updates the parameters, ``m`` and ``v``
in place and returns them.

On a mesh (``shards=``, a ``lm_mesh.Shards``) every tensor is this rank's
shard: the parameters by ``shards.params``, the moments and the gradients
by ``shards.moments``. The global norm sums each leaf's squares over the
axes that split it (a replicated leaf counts once). Under ZeRO-1 a moment
is split over "data" where its parameter is not: each data rank updates
its slice of the parameter, then the slices are all-gathered; under FSDP
the parameter is split like its moments and stays so.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch import tree
from repro_torch.distributed import lm_mesh
from repro_torch.distributed.sharding import split_axes
from repro_torch.launch.mesh import all_reduce_sum


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 0.0       # 0 disables


def adam_init(params: Any, shards: "lm_mesh.Shards | None" = None) -> dict:
    """Zero moments shaped like ``params`` (this rank's moment shards of
    its parameter shards under ``shards``) and ``step`` 0, on the
    parameters' device."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)

    first = tree.leaves(params)[0]
    if shards is None:
        m = tree.tree_map(zeros, params)
        v = tree.tree_map(zeros, params)
    else:
        like = [zeros(lm_mesh.narrow(p, lm_mesh.extra_axes(*pair,
                                                           shards.mesh),
                                     shards.mesh))
                for p, pair in zip(tree.leaves(params), shards.pairs(),
                                   strict=True)]
        m = tree.unflatten(params, like)
        v = tree.unflatten(params, [torch.zeros_like(x) for x in like])
    return {"m": m, "v": v,
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def global_norm(grads: Any, shards: "lm_mesh.Shards | None" = None
                ) -> torch.Tensor:
    """sqrt(Σ g²) over every leaf, in f32. Under ``shards`` the gradients
    are moment shards: each leaf's squares are summed over the axes that
    split it, so a replicated leaf counts once."""
    if shards is None:
        return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in tree.leaves(grads)))
    mesh = shards.mesh
    by_axes: dict[tuple, torch.Tensor] = {}
    for g, (_, m_spec) in zip(tree.leaves(grads), shards.pairs(),
                              strict=True):
        axes = tuple(split_axes(m_spec, mesh))
        sq = torch.sum(torch.square(g.float()))
        by_axes[axes] = by_axes[axes] + sq if axes in by_axes else sq
    total = None
    for axes, sq in by_axes.items():
        for a in axes:
            sq = all_reduce_sum(sq, mesh, a)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads: Any, max_norm: float,
                        shards: "lm_mesh.Shards | None" = None):
    """(grads scaled so their global norm is at most ``max_norm``, the norm
    before scaling)."""
    gnorm = global_norm(grads, shards)
    scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
    return tree.tree_map(lambda g: g * scale.to(g.dtype), grads), gnorm


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """Linear warm-up to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to 0 at ``total``; takes and returns f32 tensors."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = base_lr * step / max(1.0, warmup)
        t = torch.clamp((step - warmup) / max(1.0, total - warmup), 0, 1)
        cos = 0.5 * base_lr * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, cos)

    return lr


@torch.no_grad()
def adam_update(cfg: AdamConfig, params: Any, grads: Any, state: dict,
                lr_schedule=None, shards: "lm_mesh.Shards | None" = None):
    """One AdamW step: returns (params, state), the parameters, ``m`` and
    ``v`` updated in place; other entries of ``state`` are kept. Under
    ``shards`` the gradients are this rank's moment shards."""
    if cfg.grad_clip > 0:
        grads, _ = clip_by_global_norm(grads, cfg.grad_clip, shards)
    step = state["step"] + 1
    lr = lr_schedule(step) if lr_schedule else cfg.lr
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)
    pairs = [None] * len(tree.leaves(params)) if shards is None \
        else shards.pairs()
    for p, g, m, v, pair in zip(tree.leaves(params), tree.leaves(grads),
                                tree.leaves(state["m"]),
                                tree.leaves(state["v"]), pairs, strict=True):
        extra = {} if pair is None else lm_mesh.extra_axes(*pair,
                                                           shards.mesh)
        p_part = lm_mesh.narrow(p, extra, shards.mesh) if extra else p
        g32 = g.float()
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g32)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g32))
        update = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if cfg.weight_decay:
            update = update + cfg.weight_decay * p_part.float()
        new = p_part.float() - lr * update
        if extra:      # ZeRO-1: every data rank's slice of the parameter
            new = lm_mesh.widen(new.to(p.dtype), extra, shards.mesh)
        p.copy_(new)
    return params, {**state, "step": step}
