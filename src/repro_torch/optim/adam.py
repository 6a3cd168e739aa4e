"""AdamW over a pytree of tensors, the reference's ``optim/adam.py``.

The state mirrors the parameter tree: ``m`` and ``v`` have its structure
(f32) and ``step`` is a 0-d int32 tensor. The arithmetic is the
reference's, bias corrections in f32 included. Unlike the reference, which
is functional, :func:`adam_update` updates the parameters, ``m`` and ``v``
in place and returns them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch import tree


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 0.0       # 0 disables


def adam_init(params: Any) -> dict:
    """Zero moments shaped like ``params`` and ``step`` 0, on the
    parameters' device."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)

    first = tree.leaves(params)[0]
    return {"m": tree.tree_map(zeros, params),
            "v": tree.tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def global_norm(grads: Any) -> torch.Tensor:
    """sqrt(Σ g²) over every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree.leaves(grads)))


def clip_by_global_norm(grads: Any, max_norm: float):
    """(grads scaled so their global norm is at most ``max_norm``, the norm
    before scaling)."""
    gnorm = global_norm(grads)
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
                lr_schedule=None):
    """One AdamW step: returns (params, state), the parameters, ``m`` and
    ``v`` updated in place; other entries of ``state`` are kept."""
    if cfg.grad_clip > 0:
        grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
    step = state["step"] + 1
    lr = lr_schedule(step) if lr_schedule else cfg.lr
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)
    for p, g, m, v in zip(tree.leaves(params), tree.leaves(grads),
                          tree.leaves(state["m"]), tree.leaves(state["v"]),
                          strict=True):
        g32 = g.float()
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g32)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g32))
        update = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if cfg.weight_decay:
            update = update + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * update)
    return params, {**state, "step": step}
