"""The LM zoo's decoder-only dense path (the reference's ``models/lm.py``
for ``block_pattern == ("attn_dense",)``: Llama-3, Qwen3, StableLM, Yi).

Entry points, named as the reference's:

  init_params(cfg, generator=, device=)             → params
  forward(params, cfg, batch)                      → (logits, aux)
  prefill(params, cfg, batch)                      → (last_logits, enc_out)
  decode_step(params, cfg, tokens, caches, pos)    → (logits, caches)
  init_decode_state(cfg, batch, cache_len, device=) → caches

Parameters are the reference's pytree as dicts of tensors: every block's
leaves stacked on a leading ``n_blocks`` axis (``params["blocks"]
["0_attn_dense"]``), which a Python loop walks in place of ``lax.scan``.
Caches are stacked the same way (``caches["0"]["k"]``, (n_blocks, B, S,
KV, hd)) and ``decode_step`` writes them in place. ``prefill`` returns
``(last_logits, enc_out)``, as the reference's does (its docstring names
caches; ``enc_out`` is None without an encoder). The other families (MoE,
SSM, hybrid, audio, VLM), ``loss_fn`` and remat are not ported yet
(ROADMAP.md queue 1: the LM zoo); their configs raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch import resolve_device, tree
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (
    UNPORTED,
    _normal,
    attention_apply,
    ffn_apply,
    init_attention,
    init_ffn,
    init_rms_norm,
    rms_norm,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless ``cfg`` is on the ported path:
    a dense decoder-only transformer with no frontend."""
    if (cfg.family != "dense" or tuple(cfg.block_pattern) != ("attn_dense",)
            or cfg.attn_every or cfg.encoder_layers
            or cfg.frontend != "none"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family (block pattern "
            f"{cfg.block_pattern}) is {UNPORTED}; the port runs the dense "
            "decoder-only path")


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter pytree of ``cfg`` with ``(shape, dtype)`` leaves: the
    reference's names and shapes, norm scales in f32, weights in
    ``cfg.dtype``."""
    check_ported(cfg)
    dt, f32 = _dtype(cfg), torch.float32
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    nb, f, vocab = cfg.n_blocks, cfg.d_ff, cfg.vocab
    attn = {"wq": ((nb, d, h * hd), dt), "wk": ((nb, d, kv * hd), dt),
            "wv": ((nb, d, kv * hd), dt), "wo": ((nb, h * hd, d), dt)}
    if cfg.qk_norm:
        attn["q_norm"] = {"scale": ((nb, hd), f32)}
        attn["k_norm"] = {"scale": ((nb, hd), f32)}
    block = {"ln1": {"scale": ((nb, d), f32)}, "attn": attn,
             "ln2": {"scale": ((nb, d), f32)},
             "ffn": {"w_gate": ((nb, d, f), dt), "w_up": ((nb, d, f), dt),
                     "w_down": ((nb, f, d), dt)}}
    shapes = {"embed": ((vocab, d), dt), "final_norm": {"scale": ((d,), f32)},
              "blocks": {"0_attn_dense": block}}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = ((d, vocab), dt)
    return shapes


def _init_sublayer(kind: str, cfg: ModelConfig, dtype, *, generator=None,
                   device=None) -> dict:
    """One block's parameters (only ``attn_dense`` is ported)."""
    if kind != "attn_dense":
        raise NotImplementedError(f"sublayer {kind!r} is {UNPORTED}")
    kw = dict(generator=generator, device=device)
    return {"ln1": init_rms_norm(cfg.d_model, device=device),
            "attn": init_attention(cfg, dtype, **kw),
            "ln2": init_rms_norm(cfg.d_model, device=device),
            "ffn": init_ffn(cfg.d_model, cfg.d_ff, dtype, **kw)}


def _stack_init(n: int, init_one) -> dict:
    """``n`` trees from ``init_one()`` stacked on a new axis 0, each copied
    into its slot as it is drawn (one block's memory beside the stack)."""
    stacked = None
    for i in range(n):
        one = init_one()
        if stacked is None:
            stacked = tree.tree_map(
                lambda t: t.new_empty((n,) + tuple(t.shape)), one)
        for dst, src in zip(tree.leaves(stacked), tree.leaves(one)):
            dst[i].copy_(src)
    return stacked


def init_params(cfg: ModelConfig, *, generator: torch.Generator | None = None,
                device=None) -> dict:
    """Random parameters of ``cfg`` on ``device`` (the current CUDA device
    unless asked for another): norm scales 1, every weight N(0, 0.02²)
    drawn from ``generator`` (a generator on ``device``; seed 0 when none),
    block by block into the stacked tensors. The draws are not
    ``jax.random``'s: to hold the port against the reference, convert the
    reference's parameters (:func:`repro_torch.convert.lm_params_from_jax`)."""
    check_ported(cfg)
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    dtype = _dtype(cfg)
    d, vocab = cfg.d_model, cfg.vocab
    params = {"embed": _normal((vocab, d), dtype, generator, device),
              "final_norm": init_rms_norm(d, device=device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = _normal((d, vocab), dtype, generator, device)
    params["blocks"] = {"0_attn_dense": _stack_init(
        cfg.n_blocks, lambda: _init_sublayer("attn_dense", cfg, dtype,
                                             generator=generator,
                                             device=device))}
    return params


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
    room), stacked over the blocks, on ``device``."""
    check_ported(cfg)
    return {"0": _attn_cache(cfg, batch, cache_len + 8, _dtype(cfg),
                             resolve_device(device))}


# ---------------------------------------------------------------------------
# Backbone
# ---------------------------------------------------------------------------

def _apply_sublayer(p, cfg, x, *, positions, cache, cache_pos):
    """One ``attn_dense`` sublayer: pre-norm attention and SwiGLU FFN, each
    with a residual. Returns (x, cache)."""
    a, cache = attention_apply(p["attn"], cfg,
                               rms_norm(p["ln1"], x, cfg.norm_eps),
                               positions=positions, kv_cache=cache,
                               cache_pos=cache_pos)
    x = x + a
    x = x + ffn_apply(p["ffn"], rms_norm(p["ln2"], x, cfg.norm_eps))
    return x, cache


def _run_blocks(params, cfg: ModelConfig, h, *, positions, caches,
                cache_pos):
    """The blocks in order (a loop in place of the reference's scan).
    Returns (h, caches, aux)."""
    check_ported(cfg)
    blocks = params["blocks"]["0_attn_dense"]
    for i in range(cfg.n_blocks):
        def block(t, i=i):
            return t[i]

        cache = None if caches is None else tree.tree_map(block, caches["0"])
        h, _ = _apply_sublayer(tree.tree_map(block, blocks), cfg, h,
                               positions=positions, cache=cache,
                               cache_pos=cache_pos)
    return h, caches, torch.zeros((), dtype=torch.float32, device=h.device)


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

def forward(params, cfg: ModelConfig, batch: dict):
    """Full-sequence forward: batch ``{"tokens": (B, T)}`` → (logits (B, T,
    vocab), aux 0.0)."""
    h = _embed(params, cfg, batch)
    positions = _positions(h.shape[0], h.shape[1], h.device)
    h, _, aux = _run_blocks(params, cfg, h, positions=positions, caches=None,
                            cache_pos=None)
    return _logits(params, cfg, h), aux


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
    """The dense decoder-only LM as a module: parameters named as the
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
