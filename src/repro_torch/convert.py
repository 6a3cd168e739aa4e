"""The reference's ChemGCN and LM parameters and Adam state → the port's.

The caller hands over the reference's pytree with its leaves as numpy
arrays (``jax.tree.map(np.asarray, params)``); nothing here imports JAX. The
result is the same pytree of tensors, so both packages compute the same
function and take the same optimizer steps.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.gcn import GCNConfig
from repro_torch.models.lm import param_shapes


def _conv_shapes(cfg: GCNConfig, n_in: int, n_out: int) -> dict:
    """Each leaf's shape in one conv layer of ``cfg.layer``."""
    if cfg.layer == "gat":
        if n_out % cfg.heads:
            raise ValueError(f"n_out={n_out} not divisible by "
                             f"heads={cfg.heads}")
        d_head = n_out // cfg.heads
        return {"w": (cfg.heads, n_in, d_head), "a_src": (cfg.heads, d_head),
                "a_dst": (cfg.heads, d_head), "b": (n_out,)}
    if cfg.layer == "rgcn":
        return {"w_rel": (cfg.channels, n_in, n_out),
                "w_self": (n_in, n_out), "b": (n_out,)}
    return {"w": (cfg.channels, n_in, n_out), "b": (cfg.channels, n_out)}


def params_from_jax(np_params, cfg: GCNConfig, *, device=None) -> dict:
    """Copy a reference ChemGCN pytree (numpy leaves) onto ``device``,
    checking every leaf's name and shape against ``cfg`` (``cfg.layer``
    picks the conv layers' trees: GCN ``w``/``b``, GAT ``w``/``a_src``/
    ``a_dst``/``b``, R-GCN ``w_rel``/``w_self``/``b``)."""
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
        shapes = _conv_shapes(cfg, n_in, w)
        if set(conv) != set(shapes):
            raise ValueError(f"convs[{i}]: leaves {sorted(conv)}, expected "
                             f"{sorted(shapes)} for layer={cfg.layer!r}")
        out["convs"].append({k: leaf(conv[k], shape, f"convs[{i}].{k}")
                             for k, shape in shapes.items()})
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


def lm_params_from_jax(np_params, cfg: ModelConfig, *, device=None) -> dict:
    """Copy a reference LM pytree (numpy leaves) onto ``device``, checking
    every leaf's name, shape and dtype against ``cfg`` (:func:`repro_torch.
    models.lm.param_shapes`: weights in ``cfg.dtype``, norm scales and the
    MoE router in f32; the expert stacks and the shared expert of an
    ``attn_moe`` sublayer included) and keeping each leaf's dtype. A bf16 leaf (an
    ``ml_dtypes.bfloat16`` array, which ``torch.from_numpy`` rejects) goes
    through float32, exactly."""
    device = resolve_device(device)

    def walk(src, spec, path):
        if isinstance(spec, dict):
            if not isinstance(src, dict) or set(src) != set(spec):
                got = sorted(src) if isinstance(src, dict) else type(src)
                raise ValueError(f"{path or 'params'}: leaves {got}, "
                                 f"expected {sorted(spec)} for {cfg.name}")
            return {k: walk(src[k], spec[k], f"{path}.{k}" if path else k)
                    for k in spec}
        a = np.asarray(src)
        if a.shape != spec[0]:
            raise ValueError(f"{path}: shape {a.shape}, expected {spec[0]}")
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))
        if t.dtype != spec[1]:
            raise ValueError(f"{path}: dtype {a.dtype}, expected {spec[1]}")
        return t.to(device)

    return walk(np_params, param_shapes(cfg), "")
