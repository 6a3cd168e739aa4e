"""The reference's ChemGCN parameters and Adam state → the port's.

The caller hands over the reference's pytree with its leaves as numpy
arrays (``jax.tree.map(np.asarray, params)``); nothing here imports JAX. The
result is the same pytree of tensors, so both packages compute the same
function and take the same optimizer steps.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.gcn import GCNConfig


def params_from_jax(np_params, cfg: GCNConfig, *, device=None) -> dict:
    """Copy a reference ChemGCN pytree (numpy leaves) onto ``device``,
    checking every shape against ``cfg``."""
    device = resolve_device(device)

    def leaf(a, shape, name):
        a = np.asarray(a, np.float32)
        if a.shape != shape:
            raise ValueError(f"{name}: shape {a.shape}, expected {shape}")
        return torch.from_numpy(a.copy()).to(device)

    n_layers = len(cfg.conv_widths)
    if len(np_params["convs"]) != n_layers or len(np_params["bns"]) != n_layers:
        raise ValueError(f"expected {n_layers} conv layers for {cfg}")
    out = {"convs": [], "bns": []}
    n_in = cfg.n_features
    for i, w in enumerate(cfg.conv_widths):
        conv, bn = np_params["convs"][i], np_params["bns"][i]
        out["convs"].append({
            "w": leaf(conv["w"], (cfg.channels, n_in, w), f"convs[{i}].w"),
            "b": leaf(conv["b"], (cfg.channels, w), f"convs[{i}].b")})
        out["bns"].append({
            "scale": leaf(bn["scale"], (w,), f"bns[{i}].scale"),
            "bias": leaf(bn["bias"], (w,), f"bns[{i}].bias")})
        n_in = w
    out["head"] = {
        "w": leaf(np_params["head"]["w"], (n_in, cfg.n_tasks), "head.w"),
        "b": leaf(np_params["head"]["b"], (cfg.n_tasks,), "head.b")}
    return out


def opt_state_from_jax(np_state, cfg: GCNConfig, *, device=None) -> dict:
    """Copy a reference Adam state (``adam_init``/``adam_update``'s dict,
    numpy leaves) onto ``device``: ``m`` and ``v`` shaped like the ChemGCN
    parameters of ``cfg``, ``step`` a 0-d int32 tensor."""
    device = resolve_device(device)
    step = np.asarray(np_state["step"])
    if step.shape != ():
        raise ValueError(f"step: shape {step.shape}, expected ()")
    return {"m": params_from_jax(np_state["m"], cfg, device=device),
            "v": params_from_jax(np_state["v"], cfg, device=device),
            "step": torch.tensor(int(step), dtype=torch.int32,
                                 device=device)}
