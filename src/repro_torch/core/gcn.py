"""ChemGCN — the paper's target application (§IV-D, §V-B).

A stack of graph-convolution layers, masked batch-norm after each, ReLU, a
masked sum readout over nodes and a dense head: Tox21 has 12 binary tasks
(sigmoid cross-entropy), Reaction100 100 classes (softmax cross-entropy,
:func:`gcn_loss`). ``GCNConfig.layer`` picks the conv layer: ``"gcn"``
(the channel-summed graph conv, paper eq. (2)), ``"gat"`` (multi-head
attention over the first channel's connectivity) or ``"rgcn"`` (the
channels as relations), the last two from ``repro_torch.models.gnn``.
Parameters are a pytree of tensors with the reference's names
(``convs[i]`` per layer kind, ``bns[i].scale/bias``, ``head.w/b``);
:class:`GCN` holds them as an ``nn.Module``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.autotune.cost_model import POLICIES
from repro_torch.core.formats import BatchedCOO
from repro_torch.core.graph_conv import (
    graph_conv_batched,
    graph_conv_nonbatched,
    init_graph_conv,
)
from repro_torch.models.gnn import (
    gat_layer,
    init_gat_layer,
    init_rgcn_layer,
    rgcn_layer,
)


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    """The reference's ``GCNConfig`` without ``interpret`` (the port picks
    plain or kernel execution from the tensors' device). ``impl`` must be
    pinned: ``"auto"`` raises in this port. A pinned impl carries its own
    storage policy (``"fused_bf16"``, ``"pallas_csr_i8"``, ...);
    ``precision`` steers only ``"auto"``, as in the reference, so under a
    pinned impl it is checked and otherwise ignored."""

    n_features: int = 62
    channels: int = 4
    conv_widths: tuple[int, ...] = (64, 64)
    n_tasks: int = 12
    task: str = "multitask_binary"   # or "multiclass"
    layer: str = "gcn"               # "gcn", "gat" or "rgcn"
    heads: int = 4                   # attention heads (layer="gat"; every
                                     # conv width must divide by it)
    impl: str = "auto"
    k_pad: int = 8
    batched: bool = True             # Fig. 7 (True) vs Fig. 6 (False)
    precision: str = "f32"           # "f32", "bf16" or "i8" (auto only)
    bn_mode: str = "batch"           # "batch" or per-graph "sample"

    @staticmethod
    def tox21(**kw) -> "GCNConfig":
        return GCNConfig(conv_widths=(64, 64), n_tasks=12,
                         task="multitask_binary", **kw)

    @staticmethod
    def reaction100(**kw) -> "GCNConfig":
        return GCNConfig(conv_widths=(512, 512, 512), n_tasks=100,
                         task="multiclass", **kw)


LAYERS = ("gcn", "gat", "rgcn")


def check_config(cfg: GCNConfig) -> None:
    """Raise for an unknown layer kind or storage policy."""
    if cfg.layer not in LAYERS:
        raise ValueError(f"unknown layer kind {cfg.layer!r}: expected 'gcn', "
                         "'gat' or 'rgcn'")
    if cfg.precision not in POLICIES:
        raise ValueError(f"unknown precision {cfg.precision!r}: expected one "
                         f"of {POLICIES}")


def _init_conv(cfg: GCNConfig, n_in: int, n_out: int, *, generator,
               device) -> dict:
    """One conv layer's parameters for ``cfg.layer``."""
    if cfg.layer == "gat":
        return init_gat_layer(n_in, n_out, cfg.heads, generator=generator,
                              device=device)
    if cfg.layer == "rgcn":
        return init_rgcn_layer(n_in, n_out, cfg.channels,
                               generator=generator, device=device)
    return init_graph_conv(n_in, n_out, cfg.channels, generator=generator,
                           device=device)


def init_gcn(cfg: GCNConfig, *, generator: torch.Generator | None = None,
             device=None) -> dict:
    """Random parameters drawn from ``generator`` (the reference's shapes and
    distributions; the numbers differ from ``jax.random``'s)."""
    check_config(cfg)
    device = resolve_device(device)
    params = {"convs": [], "bns": []}
    n_in = cfg.n_features
    for w in cfg.conv_widths:
        params["convs"].append(_init_conv(cfg, n_in, w, generator=generator,
                                          device=device))
        params["bns"].append({
            "scale": torch.ones((w,), dtype=torch.float32, device=device),
            "bias": torch.zeros((w,), dtype=torch.float32, device=device),
        })
        n_in = w
    scale = 1.0 / math.sqrt(n_in)
    head_w = torch.rand((n_in, cfg.n_tasks), generator=generator,
                        dtype=torch.float32) * (2 * scale) - scale
    params["head"] = {
        "w": head_w.to(device),
        "b": torch.zeros((cfg.n_tasks,), dtype=torch.float32, device=device),
    }
    return params


def _batch_norm(p, x, mask, mode: str = "batch"):
    """Masked batch-norm over real nodes only. ``mode="batch"`` reduces over
    (batch, nodes); ``mode="sample"`` over each graph's own nodes, so a
    request's logits do not depend on which graphs share its wave."""
    if mode not in ("batch", "sample"):
        raise ValueError(f"unknown bn_mode {mode!r}: expected 'batch' or "
                         "'sample'")
    if mode == "sample":
        denom = torch.clamp(mask.sum(dim=(1, 2), keepdim=True), min=1.0)
        mean = (x * mask).sum(dim=1, keepdim=True) / denom
        var = (((x - mean) * mask) ** 2).sum(dim=1, keepdim=True) / denom
    else:
        denom = torch.clamp(mask.sum(), min=1.0)
        mean = (x * mask).sum(dim=(0, 1)) / denom
        var = (((x - mean) * mask) ** 2).sum(dim=(0, 1)) / denom
    xn = (x - mean) * torch.rsqrt(var + 1e-5)
    return xn * p["scale"] + p["bias"]


def apply_gcn(params, cfg: GCNConfig, adj: Sequence[BatchedCOO],
              x: torch.Tensor, n_nodes: torch.Tensor) -> torch.Tensor:
    """Logits (batch, n_tasks) for x (batch, m_pad, n_features) and per-channel
    adjacencies; runs on the device the tensors lie on."""
    check_config(cfg)
    if cfg.layer != "gcn" and not cfg.batched:
        # GAT and R-GCN exist only on the batched g-SpMM stack: there is no
        # Fig. 6 per-sample baseline for them
        raise ValueError(f"layer={cfg.layer!r} requires batched=True")
    mask = (torch.arange(x.shape[1], device=x.device)[None, :, None]
            < n_nodes[:, None, None]).to(x.dtype)
    h = x
    for conv_p, bn_p in zip(params["convs"], params["bns"]):
        if cfg.layer == "gat":
            h = gat_layer(conv_p, adj[0], h, impl=cfg.impl, k_pad=cfg.k_pad)
        elif cfg.layer == "rgcn":
            h = rgcn_layer(conv_p, adj, h, impl=cfg.impl, k_pad=cfg.k_pad)
        elif cfg.batched:
            h = graph_conv_batched(conv_p, adj, h, impl=cfg.impl,
                                   k_pad=cfg.k_pad)
        else:
            h = graph_conv_nonbatched(conv_p, adj, h)
        h = _batch_norm(bn_p, h * mask, mask, cfg.bn_mode)
        h = torch.relu(h) * mask
    readout = h.sum(dim=1)
    return readout @ params["head"]["w"] + params["head"]["b"]


def gcn_loss(params, cfg: GCNConfig, adj: Sequence[BatchedCOO],
             x: torch.Tensor, n_nodes: torch.Tensor,
             labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(loss, accuracy) as 0-d tensors, with the reference's expressions:
    the stable sigmoid cross-entropy over 12 binary tasks (labels
    (batch, n_tasks) in {0, 1}), or softmax cross-entropy over classes
    (labels (batch,) class ids)."""
    logits = apply_gcn(params, cfg, adj, x, n_nodes)
    if cfg.task == "multitask_binary":
        z = logits
        loss = (torch.clamp(z, min=0) - z * labels
                + torch.log1p(torch.exp(-torch.abs(z)))).mean()
        acc = ((z > 0).to(torch.float32) == labels).to(torch.float32).mean()
    else:
        ids = labels.long()
        logp = torch.log_softmax(logits, dim=-1)
        loss = -torch.gather(logp, 1, ids[:, None]).mean()
        acc = (logits.argmax(dim=-1) == ids).to(torch.float32).mean()
    return loss, acc


class GCN(nn.Module):
    """ChemGCN as a module: parameters named as the reference's pytree
    (``convs.0.w``, ``convs.0.a_src`` for GAT, ``convs.0.w_rel`` for R-GCN,
    ``bns.0.scale``, ``head.w`` …), trainable; ``forward`` is
    :func:`apply_gcn`."""

    def __init__(self, cfg: GCNConfig, params: dict | None = None, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        if params is None:
            params = init_gcn(cfg, generator=generator, device=device)
        self.cfg = cfg

        def bag(d):
            return nn.ParameterDict({k: nn.Parameter(v) for k, v in d.items()})

        self.convs = nn.ModuleList(bag(p) for p in params["convs"])
        self.bns = nn.ModuleList(bag(p) for p in params["bns"])
        self.head = bag(params["head"])

    @property
    def params(self) -> dict:
        """The parameters as the reference's pytree of tensors."""
        return {"convs": [dict(p) for p in self.convs],
                "bns": [dict(p) for p in self.bns],
                "head": dict(self.head)}

    def forward(self, adj: Sequence[BatchedCOO], x: torch.Tensor,
                n_nodes: torch.Tensor) -> torch.Tensor:
        return apply_gcn(self.params, self.cfg, adj, x, n_nodes)
