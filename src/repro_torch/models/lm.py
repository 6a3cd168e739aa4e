"""The LM zoo's decoder-only transformers (the reference's ``models/lm.py``
for block patterns of ``attn_dense`` and ``attn_moe`` sublayers: the dense
Llama-3, Qwen3, StableLM and Yi, and the MoE Mixtral (``("attn_moe",)``)
and Llama-4 (``("attn_dense", "attn_moe")``)).

Entry points, named as the reference's:

  init_params(cfg, generator=, device=)             → params
  forward(params, cfg, batch, remat=)              → (logits, aux)
  loss_fn(params, cfg, batch, remat=, aux_weight=) → (loss, metrics)
  prefill(params, cfg, batch)                      → (last_logits, enc_out)
  decode_step(params, cfg, tokens, caches, pos)    → (logits, caches)
  init_decode_state(cfg, batch, cache_len, device=) → caches

Parameters are the reference's pytree as dicts of tensors: every block's
leaves stacked on a leading ``n_blocks`` axis, one subtree per position of
the block pattern (``params["blocks"]["0_attn_dense"]``,
``["1_attn_moe"]``), which a Python loop walks in place of ``lax.scan``.
Caches are stacked the same way, one per pattern position (``caches["0"]
["k"]``, (n_blocks, B, S, KV, hd)), and ``decode_step`` writes them in
place. ``prefill`` returns ``(last_logits, enc_out)``, as the reference's
does (its docstring names caches; ``enc_out`` is None without an encoder).

``remat=True`` checkpoints each block (``torch.utils.checkpoint``,
non-reentrant) under ``tuning.flags().remat_policy``: ``"full"``
recomputes the block in the backward, ``"dots"`` keeps the weight
products (``aten.mm`` / ``aten.addmm``, the matmuls without batch
dimensions) and recomputes the rest, attention's batched products among
it (the counterpart of ``dots_with_no_batch_dims_saveable``), ``"none"``
checkpoints nothing. The SSM, hybrid, audio and VLM families are not
ported yet; their configs raise ``NotImplementedError`` naming their
ROADMAP.md item.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch import resolve_device, tree, tuning
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (
    attention_apply,
    ffn_apply,
    moe_apply,
    rms_norm,
    unported,
)

SUBLAYERS = ("attn_dense", "attn_moe")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the ROADMAP.md queue 1 item of each family that is not ported yet
_FAMILY_ITEM = {"ssm": "SSM", "hybrid": "SSM", "audio": "whisper",
                "vlm": "llava"}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless ``cfg`` is on the ported path:
    a decoder-only transformer of ``attn_dense`` / ``attn_moe`` sublayers
    with no frontend."""
    if (cfg.family not in ("dense", "moe")
            or not set(cfg.block_pattern) <= set(SUBLAYERS)
            or cfg.attn_every or cfg.encoder_layers
            or cfg.frontend != "none"):
        item = _FAMILY_ITEM.get(cfg.family, cfg.family)
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family (block pattern "
            f"{cfg.block_pattern}) is {unported(item)}; the port runs the "
            "dense and MoE decoder-only paths")


def _ffn_shapes(lead: tuple, d: int, f: int, dt) -> dict:
    return {"w_gate": (lead + (d, f), dt), "w_up": (lead + (d, f), dt),
            "w_down": (lead + (f, d), dt)}


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter pytree of ``cfg`` with ``(shape, dtype)`` leaves: the
    reference's names and shapes, norm scales and the MoE router in f32,
    weights in ``cfg.dtype``."""
    check_ported(cfg)
    dt, f32 = _dtype(cfg), torch.float32
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    nb, f, e, vocab = cfg.n_blocks, cfg.d_ff, cfg.n_experts, cfg.vocab
    attn = {"wq": ((nb, d, h * hd), dt), "wk": ((nb, d, kv * hd), dt),
            "wv": ((nb, d, kv * hd), dt), "wo": ((nb, h * hd, d), dt)}
    if cfg.qk_norm:
        attn["q_norm"] = {"scale": ((nb, hd), f32)}
        attn["k_norm"] = {"scale": ((nb, hd), f32)}
    blocks = {}
    for i, kind in enumerate(cfg.block_pattern):
        block = {"ln1": {"scale": ((nb, d), f32)}, "attn": attn,
                 "ln2": {"scale": ((nb, d), f32)}}
        if kind == "attn_dense":
            block["ffn"] = _ffn_shapes((nb,), d, f, dt)
        else:
            block["moe"] = {"router": ((nb, d, e), f32),
                            **_ffn_shapes((nb, e), d, f, dt)}
            if cfg.shared_expert:
                block["moe"]["shared"] = _ffn_shapes((nb,), d, f, dt)
        blocks[f"{i}_{kind}"] = block
    shapes = {"embed": ((vocab, d), dt), "final_norm": {"scale": ((d,), f32)},
              "blocks": blocks}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = ((d, vocab), dt)
    return shapes


def _is_shape(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[1],
                                                               torch.dtype)


def init_params(cfg: ModelConfig, *, generator: torch.Generator | None = None,
                device=None) -> dict:
    """Random parameters of ``cfg`` on ``device`` (the current CUDA device
    unless asked for another): norm scales 1, every other leaf N(0, 0.02²)
    drawn from ``generator`` (a generator on ``device``; seed 0 when none)
    straight into its stacked tensor, leaf by leaf in the tree's order, so
    the largest transient is no more than the parameters themselves. The
    draws are not ``jax.random``'s: to hold the port against the reference,
    convert the reference's parameters
    (:func:`repro_torch.convert.lm_params_from_jax`)."""
    shapes = param_shapes(cfg)
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    def build(node, name=""):
        if not _is_shape(node):
            return {k: build(v, k) for k, v in sorted(node.items())}
        shape, dtype = node
        t = torch.empty(shape, dtype=dtype, device=device)
        if name == "scale":
            return t.fill_(1.0)
        return t.normal_(0.0, 0.02, generator=generator)

    return build(shapes)


# ---------------------------------------------------------------------------
# Cache init
# ---------------------------------------------------------------------------

def _attn_cache(cfg, batch, cache_len, dtype, device):
    length = min(cache_len, cfg.window) if cfg.window else cache_len
    length = -(-length // 128) * 128     # the reference's 128-alignment
    shape = (cfg.n_blocks, batch, length, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_decode_state(cfg: ModelConfig, batch: int, cache_len: int, *,
                      device=None) -> dict:
    """Zero decode caches sized for ``cache_len`` past tokens (+8 slots of
    room), one per position of the block pattern (``"0"``, ``"1"`` …),
    stacked over the blocks, on ``device``."""
    check_ported(cfg)
    device = resolve_device(device)
    return {f"{i}": _attn_cache(cfg, batch, cache_len + 8, _dtype(cfg),
                                device)
            for i in range(len(cfg.block_pattern))}


# ---------------------------------------------------------------------------
# Backbone
# ---------------------------------------------------------------------------

def _apply_sublayer(kind, p, cfg, x, *, positions, cache, cache_pos):
    """One sublayer: pre-norm attention, then the SwiGLU FFN
    (``attn_dense``) or the MoE (``attn_moe``), each with a residual.
    Returns (x, cache, aux), aux 0 for a dense sublayer."""
    a, cache = attention_apply(p["attn"], cfg,
                               rms_norm(p["ln1"], x, cfg.norm_eps),
                               positions=positions, kv_cache=cache,
                               cache_pos=cache_pos)
    x = x + a
    h = rms_norm(p["ln2"], x, cfg.norm_eps)
    if kind == "attn_dense":
        return x + ffn_apply(p["ffn"], h), cache, \
            torch.zeros((), dtype=torch.float32, device=x.device)
    mo, aux = moe_apply(p["moe"], cfg, h)
    return x + mo, cache, aux


def _dots_policy(ctx, op, *args, **kwargs):
    """Keep the weight products (matmuls without batch dimensions),
    recompute everything else."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_checkpoint(body, remat: bool):
    """``body`` under the per-block checkpoint of
    ``tuning.flags().remat_policy`` (the flags of this call: the backward's
    recompute runs under them too, wherever the backward is called)."""
    if not remat:
        return body
    fl = tuning.flags()
    if fl.remat_policy == "none":
        return body

    def replay(*args):
        with tuning.use_flags(**dataclasses.asdict(fl)):
            return body(*args)

    kw = {}
    if fl.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    return functools.partial(checkpoint, replay, use_reentrant=False,
                             preserve_rng_state=False, **kw)


def _unstack(stacked, n: int) -> list:
    """The ``n`` per-block trees of a tree stacked on axis 0 (views: the
    gradient of the stack is assembled once, and a write into a cache
    block lands in the stacked cache)."""
    flat = [torch.unbind(t) for t in tree.leaves(stacked)]
    return [tree.unflatten(stacked, [u[i] for u in flat]) for i in range(n)]


def _run_blocks(params, cfg: ModelConfig, h, *, positions, caches,
                cache_pos, remat=False):
    """The blocks in order (a loop in place of the reference's scan), each
    its pattern's sublayers in turn. Returns (h, caches, aux), aux the sum
    of every MoE sublayer's (f32, in the reference's order)."""
    check_ported(cfg)
    pattern, nb = cfg.block_pattern, cfg.n_blocks
    subs = [_unstack(params["blocks"][f"{i}_{kind}"], nb)
            for i, kind in enumerate(pattern)]
    cache_blocks = None if caches is None else [
        _unstack(caches[f"{i}"], nb) for i in range(len(pattern))]

    def block(b, h, aux):
        for i, kind in enumerate(pattern):
            cache = None if cache_blocks is None else cache_blocks[i][b]
            h, _, a = _apply_sublayer(kind, subs[i][b], cfg, h,
                                      positions=positions, cache=cache,
                                      cache_pos=cache_pos)
            aux = aux + a
        return h, aux

    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for b in range(nb):
        h, aux = _maybe_checkpoint(functools.partial(block, b), remat)(h, aux)
    return h, caches, aux


def _embed(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    return params["embed"][batch["tokens"].long()]


def _logits(params, cfg: ModelConfig, h) -> torch.Tensor:
    h = rms_norm(params["final_norm"], h, cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ head


def _positions(b: int, t: int, device) -> torch.Tensor:
    return torch.arange(t, device=device).expand(b, t)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def forward(params, cfg: ModelConfig, batch: dict, *, remat: bool = False):
    """Full-sequence forward: batch ``{"tokens": (B, T)}`` → (logits (B, T,
    vocab) in ``cfg.dtype``, aux: the MoE load-balance loss summed over the
    MoE sublayers, 0.0 without one)."""
    h = _embed(params, cfg, batch)
    positions = _positions(h.shape[0], h.shape[1], h.device)
    h, _, aux = _run_blocks(params, cfg, h, positions=positions, caches=None,
                            cache_pos=None, remat=remat)
    return _logits(params, cfg, h), aux


def loss_fn(params, cfg: ModelConfig, batch: dict, *, remat: bool = False,
            aux_weight: float = 0.01):
    """Next-token cross-entropy over ``batch["tokens"]`` (B, T), masked by
    ``batch["loss_mask"]`` where given, plus ``aux_weight · aux /
    max(n_layers, 1)``. The logits are taken in ``cfg.dtype``, as the
    reference's, and cast to f32 for the log-sum-exp. Returns (total,
    {"nll", "aux", "tokens"}), all 0-d f32 tensors."""
    logits, aux = forward(params, cfg, batch, remat=remat)
    logits = logits[:, :-1].float()
    targets = batch["tokens"][:, 1:].long()
    if "loss_mask" in batch:
        mask = batch["loss_mask"][:, 1:].float()
    else:
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=logits.device)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets[..., None])[..., 0]
    nll = (logz - gold) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = nll.sum() / denom
    total = loss + aux_weight * aux / max(cfg.n_layers, 1)
    return total, {"nll": loss, "aux": aux, "tokens": denom}


def prefill(params, cfg: ModelConfig, batch: dict):
    """Process a full prompt: the blocks without caches, then the logits of
    the last position. Returns (last_logits (B, 1, vocab), enc_out), as the
    reference does (``enc_out`` is None: no encoder on this path)."""
    h = _embed(params, cfg, batch)
    positions = _positions(h.shape[0], h.shape[1], h.device)
    h, _, _ = _run_blocks(params, cfg, h, positions=positions, caches=None,
                          cache_pos=None)
    return _logits(params, cfg, h[:, -1:]), None


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor, caches,
                pos):
    """One decode step: tokens (B, 1) at absolute position ``pos`` (an int
    or a 0-d tensor), caches updated in place. Returns (logits (B, 1,
    vocab), caches)."""
    pos = int(pos)
    h = _embed(params, cfg, {"tokens": tokens})
    positions = torch.full(h.shape[:2], pos, dtype=torch.int64,
                           device=h.device)
    h, caches, _ = _run_blocks(params, cfg, h, positions=positions,
                               caches=caches, cache_pos=pos)
    return _logits(params, cfg, h), caches


class LM(nn.Module):
    """The decoder-only LM as a module: parameters named as the
    reference's pytree (``embed``, ``blocks.0_attn_dense.attn.wq`` …);
    ``forward`` is :func:`forward`'s logits. ``params`` gives the pytree the
    functions take."""

    def __init__(self, cfg: ModelConfig, params: dict | None = None, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        if params is None:
            params = init_params(cfg, generator=generator, device=device)
        self.cfg = cfg
        _register(self, params)

    @property
    def params(self) -> dict:
        return _as_tree(self)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self.params, self.cfg, {"tokens": tokens})[0]


def _register(module: nn.Module, params: dict) -> None:
    for k, v in params.items():
        if isinstance(v, dict):
            child = nn.Module()
            _register(child, v)
            module.add_module(k, child)
        else:
            module.register_parameter(k, nn.Parameter(v))


def _as_tree(module: nn.Module) -> dict:
    out = dict(module.named_parameters(recurse=False))
    out.update({k: _as_tree(c) for k, c in module.named_children()})
    return out
