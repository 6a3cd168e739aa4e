"""The unified LM over the architecture zoo (the reference's
``models/lm.py``): every one of the ten configs.

- decoder-only transformers of ``attn_dense`` / ``attn_moe`` sublayers
  (Llama-3, Qwen3, StableLM, Yi; the MoE Mixtral and Llama-4);
- attention-free RWKV-6 (``("rwkv",)`` blocks, :mod:`.ssm`);
- the hybrid Zamba2: groups of ``attn_every`` Mamba2 sublayers, each group
  followed by ONE weight-shared attention block (its weights shared, a KV
  cache per group), then a tail of the remaining Mamba2 sublayers;
- encoder-decoder Whisper: an encoder over the stub audio frames (a linear
  ``frame_proj`` from ``AUDIO_DIM``), then the decoder blocks, each with a
  cross-attention to the encoder's output;
- LLaVA's stub vision tiles: precomputed patch embeddings projected by
  ``patch_proj`` replace the first positions of the prompt.

Entry points, named as the reference's:

  init_params(cfg, generator=, device=)             → params
  forward(params, cfg, batch, remat=)              → (logits, aux)
  loss_fn(params, cfg, batch, remat=, aux_weight=) → (loss, metrics)
  prefill(params, cfg, batch)                      → (last_logits, enc_out)
  decode_step(params, cfg, tokens, caches, pos)    → (logits, caches)
  init_decode_state(cfg, batch, cache_len, enc_len=, device=) → caches

``batch`` holds ``tokens`` (B, T) and, for Whisper, ``frames`` (B, S,
AUDIO_DIM); for LLaVA, optionally ``patch_embeds`` (B, n, VISION_DIM).
Parameters are the reference's pytree as dicts of tensors: every block's
leaves stacked on a leading ``n_blocks`` axis, one subtree per position of
the block pattern (``params["blocks"]["0_attn_dense"]``, ``["0_rwkv"]``),
Zamba2's on (n_groups, attn_every) (``params["groups"]``), which Python
loops walk in place of ``lax.scan``. Caches are stacked the same way (one
per pattern position, ``caches["0"]``; Zamba2's ``groups_mamba``,
``groups_attn`` and ``tail_mamba``; Whisper's ``cross_kv``), and
``decode_step`` writes them in place, the recurrent states too. In
training and prefill the recurrent sublayers start from zero states, which
are not threaded out. ``prefill`` returns ``(last_logits, enc_out)``, as
the reference's does (its docstring names caches; ``enc_out`` is None
without an encoder).

``remat=True`` checkpoints each block, or each Zamba2 group
(``torch.utils.checkpoint``, non-reentrant), under
``tuning.flags().remat_policy``: ``"full"`` recomputes the block in the
backward, ``"dots"`` keeps the weight products (``aten.mm`` /
``aten.addmm``, the matmuls without batch dimensions) and recomputes the
rest, attention's batched products among it (the counterpart of
``dots_with_no_batch_dims_saveable``), ``"none"`` checkpoints nothing.
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
from repro_torch.distributed import lm_mesh
from repro_torch.distributed.sharding import cache_specs
from repro_torch.models import ssm
from repro_torch.models.layers import (
    attention_apply,
    build_tree,
    ffn_apply,
    moe_apply,
    rms_norm,
)

VISION_DIM = 1024   # stub CLIP-like patch embedding width
AUDIO_DIM = 80      # stub mel-frame width
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _ffn_shapes(lead: tuple, d: int, f: int, dt) -> dict:
    return {"w_gate": (lead + (d, f), dt), "w_up": (lead + (d, f), dt),
            "w_down": (lead + (f, d), dt)}


def _attn_shapes(cfg: ModelConfig, lead: tuple, dt) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    attn = {"wq": (lead + (d, h * hd), dt), "wk": (lead + (d, kv * hd), dt),
            "wv": (lead + (d, kv * hd), dt), "wo": (lead + (h * hd, d), dt)}
    if cfg.qk_norm:
        attn["q_norm"] = {"scale": (lead + (hd,), torch.float32)}
        attn["k_norm"] = {"scale": (lead + (hd,), torch.float32)}
    return attn


def _sublayer_shapes(kind: str, cfg: ModelConfig, lead: tuple, dt) -> dict:
    """One sublayer's ``(shape, dtype)`` tree, every shape behind
    ``lead``."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    norm = {"scale": (lead + (d,), torch.float32)}
    if kind == "mamba":
        return {"ln": norm, "mamba": ssm.mamba_shapes(cfg, dt, lead)}
    if kind == "rwkv":
        return {"rwkv": ssm.rwkv_shapes(cfg, dt, lead)}
    if kind not in ("attn_dense", "attn_moe"):
        raise ValueError(kind)
    block = {"ln1": norm, "attn": _attn_shapes(cfg, lead, dt), "ln2": norm}
    if kind == "attn_dense":
        block["ffn"] = _ffn_shapes(lead, d, f, dt)
    else:
        block["moe"] = {"router": (lead + (d, e), torch.float32),
                        **_ffn_shapes(lead + (e,), d, f, dt)}
        if cfg.shared_expert:
            block["moe"]["shared"] = _ffn_shapes(lead, d, f, dt)
    return block


def _groups(cfg: ModelConfig) -> tuple[int, int]:
    """Zamba2's (groups, tail sublayers)."""
    return cfg.n_layers // cfg.attn_every, cfg.n_layers % cfg.attn_every


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter pytree of ``cfg`` with ``(shape, dtype)`` leaves: the
    reference's names and shapes, norm scales, the MoE router and the SSM
    coefficients in f32, weights in ``cfg.dtype``."""
    dt = _dtype(cfg)
    d, vocab = cfg.d_model, cfg.vocab
    shapes = {"embed": ((vocab, d), dt),
              "final_norm": {"scale": ((d,), torch.float32)}}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = ((d, vocab), dt)
    if cfg.attn_every:
        n_groups, tail = _groups(cfg)
        shapes["groups"] = _sublayer_shapes(
            "mamba", cfg, (n_groups, cfg.attn_every), dt)
        if tail:
            shapes["tail"] = _sublayer_shapes("mamba", cfg, (tail,), dt)
        shapes["shared_attn"] = _sublayer_shapes("attn_dense", cfg, (), dt)
    else:
        shapes["blocks"] = {
            f"{i}_{kind}": _sublayer_shapes(kind, cfg, (cfg.n_blocks,), dt)
            for i, kind in enumerate(cfg.block_pattern)}
    if cfg.encoder_layers:
        shapes["encoder"] = {
            "frame_proj": ((AUDIO_DIM, d), dt),
            "blocks": _sublayer_shapes("attn_dense", cfg,
                                       (cfg.encoder_layers,), dt),
            "final_norm": {"scale": ((d,), torch.float32)}}
        lead = (cfg.n_blocks,)
        shapes["cross"] = {"ln": {"scale": (lead + (d,), torch.float32)},
                           "attn": _attn_shapes(cfg, lead, dt)}
    if cfg.frontend == "vision_tiles":
        shapes["patch_proj"] = ((VISION_DIM, d), dt)
    return shapes


def init_params(cfg: ModelConfig, *, generator: torch.Generator | None = None,
                device=None) -> dict:
    """Random parameters of ``cfg`` on ``device`` (the current CUDA device
    unless asked for another), each leaf drawn with the reference's
    initializer for its name (norm scales 1, the SSM coefficients by
    ``ssm.INIT_RULES``, every other leaf N(0, 0.02²)) from ``generator``
    (a generator on ``device``; seed 0 when none) straight into its
    stacked tensor, leaf by leaf in the tree's order, so the largest
    transient is no more than the parameters themselves. The draws are not ``jax.random``'s: to hold the port
    against the reference, convert the reference's parameters
    (:func:`repro_torch.convert.lm_params_from_jax`)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return build_tree(param_shapes(cfg), generator, device, ssm.INIT_RULES)


# ---------------------------------------------------------------------------
# Cache init
# ---------------------------------------------------------------------------

def _attn_cache(cfg, lead, batch, cache_len, dtype, device):
    length = min(cache_len, cfg.window) if cfg.window else cache_len
    length = -(-length // 128) * 128     # the reference's 128-alignment
    shape = lead + (batch, length, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_decode_state(cfg: ModelConfig, batch: int, cache_len: int,
                      enc_len: int = 0, *, device=None, mesh=None) -> dict:
    """Zero decode caches on ``device``: KV caches sized for ``cache_len``
    past tokens (+8 slots of room), recurrent states in f32. One per
    position of the block pattern (``"0"``, ``"1"`` …), stacked over the
    blocks; Zamba2's ``groups_mamba`` (n_groups, attn_every, …),
    ``groups_attn`` (n_groups, …) and ``tail_mamba``; Whisper's
    ``cross_kv`` of ``enc_len`` slots (rounded up to a multiple of 8, at
    least 8, then to 128 as every KV cache), which nothing fills (the
    reference's ``prefill`` returns the encoder's output instead). Under
    ``mesh``, this rank's shards of those caches by
    ``sharding.cache_specs`` (on the mesh's device)."""
    if mesh is not None:
        device = resolve_device(device, mesh)
        full = init_decode_state(cfg, batch, cache_len, enc_len,
                                 device="meta")

        def local(t, spec):
            return torch.zeros(lm_mesh.local_shape(t.shape, spec, mesh),
                               dtype=t.dtype, device=device)

        return lm_mesh.map_specs(local, full, cache_specs(full, mesh))
    device = resolve_device(device)
    dt = _dtype(cfg)
    cache_len = cache_len + 8
    if cfg.attn_every:
        n_groups, tail = _groups(cfg)
        state = {"groups_mamba": ssm.mamba_state_init(
                     cfg, batch, lead=(n_groups, cfg.attn_every),
                     device=device),
                 "groups_attn": _attn_cache(cfg, (n_groups,), batch,
                                            cache_len, dt, device)}
        if tail:
            state["tail_mamba"] = ssm.mamba_state_init(
                cfg, batch, lead=(tail,), device=device)
        return state
    lead = (cfg.n_blocks,)
    caches = {}
    for i, kind in enumerate(cfg.block_pattern):
        if kind in ("attn_dense", "attn_moe"):
            caches[f"{i}"] = _attn_cache(cfg, lead, batch, cache_len, dt,
                                         device)
        elif kind == "mamba":
            caches[f"{i}"] = ssm.mamba_state_init(cfg, batch, lead=lead,
                                                  device=device)
        elif kind == "rwkv":
            caches[f"{i}"] = ssm.rwkv_state_init(cfg, batch, lead=lead,
                                                 device=device)
        else:
            raise ValueError(kind)
    if cfg.encoder_layers:
        enc_len = -(-max(enc_len, 8) // 8) * 8
        caches["cross_kv"] = _attn_cache(cfg, lead, batch, enc_len, dt,
                                         device)
    return caches


# ---------------------------------------------------------------------------
# Backbone
# ---------------------------------------------------------------------------

def _zeros(x) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _apply_sublayer(kind, p, cfg, x, *, positions, cache, cache_pos):
    """One sublayer. Attention: pre-norm attention, then the SwiGLU FFN
    (``attn_dense``) or the MoE (``attn_moe``), each with a residual, the
    KV cache written in place. ``mamba``: pre-norm ``ln``, the mixer, a
    residual; ``rwkv``: the block, which carries its own norms. A
    recurrent sublayer starts from ``cache`` (zero states when None) and
    writes its new state back into ``cache`` where there is one. Returns
    (x, cache, aux), aux 0 but for a MoE sublayer."""
    if kind in ("mamba", "rwkv"):
        state = cache
        if state is None:           # training / prefill: zero initial state
            init = (ssm.mamba_state_init if kind == "mamba"
                    else ssm.rwkv_state_init)
            state = init(cfg, x.shape[0], device=x.device)
        if kind == "mamba":
            m, new = ssm.mamba_apply(p["mamba"], cfg,
                                     rms_norm(p["ln"], x, cfg.norm_eps),
                                     state)
            x = x + m
        else:
            x, new = ssm.rwkv_apply(p["rwkv"], cfg, x, state)
        if cache is not None:
            for k, t in new.items():
                cache[k].copy_(t)
        return x, cache, _zeros(x)
    a, cache = attention_apply(p["attn"], cfg,
                               rms_norm(p["ln1"], x, cfg.norm_eps),
                               positions=positions, kv_cache=cache,
                               cache_pos=cache_pos)
    x = x + a
    h = rms_norm(p["ln2"], x, cfg.norm_eps)
    if kind == "attn_dense":
        return x + ffn_apply(p["ffn"], h, lm_mesh.tp_ffn(cfg)), cache, \
            _zeros(x)
    mo, aux = moe_apply(p["moe"], cfg, h)
    return x + mo, cache, aux


def _cross_attend(p, cfg, x, enc_out=None, enc_kv=None):
    """Decoder cross-attention: from the encoder's output (training,
    prefill) or over a per-layer K/V cache (decode)."""
    h = rms_norm(p["ln"], x, cfg.norm_eps)
    positions = torch.zeros(x.shape[:2], dtype=torch.int64, device=x.device)
    if enc_kv is not None:
        a, _ = attention_apply(p["attn"], cfg, h, positions=positions,
                               causal=False, kv_cache=enc_kv,
                               cache_mode="read_all")
    else:
        a, _ = attention_apply(p["attn"], cfg, h, positions=positions,
                               causal=False, xa=enc_out)
    return x + a


def _dots_policy(ctx, op, *args, **kwargs):
    """Keep the weight products (matmuls without batch dimensions),
    recompute everything else."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_checkpoint(body, remat: bool):
    """``body`` under the per-block checkpoint of
    ``tuning.flags().remat_policy`` (the flags and mesh layout of this
    call: the backward's recompute runs under them too, wherever the
    backward is called)."""
    if not remat:
        return body
    fl = tuning.flags()
    if fl.remat_policy == "none":
        return body
    lay = lm_mesh.layout()

    def replay(*args):
        with tuning.use_flags(**dataclasses.asdict(fl)), \
                lm_mesh.use_layout(lay):
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


def _run_hybrid(params, cfg: ModelConfig, h, *, positions, caches,
                cache_pos, remat=False):
    """Zamba2: per group, ``attn_every`` Mamba2 sublayers then the shared
    attention block (each group its own KV cache); then the tail. A group
    is one checkpoint under remat, the tail is not (as the reference's scan
    body and the loop after it)."""
    n_groups, tail = _groups(cfg)
    groups = [_unstack(g, cfg.attn_every)
              for g in _unstack(params["groups"], n_groups)]
    shared = params["shared_attn"]
    decode = caches is not None
    if decode:
        g_mamba = [_unstack(g, cfg.attn_every)
                   for g in _unstack(caches["groups_mamba"], n_groups)]
        g_attn = _unstack(caches["groups_attn"], n_groups)

    def group(g, h, aux):
        for j in range(cfg.attn_every):
            h, _, _ = _apply_sublayer(
                "mamba", groups[g][j], cfg, h, positions=positions,
                cache=g_mamba[g][j] if decode else None, cache_pos=cache_pos)
        h, _, a = _apply_sublayer(
            "attn_dense", shared, cfg, h, positions=positions,
            cache=g_attn[g] if decode else None, cache_pos=cache_pos)
        return h, aux + a

    aux = _zeros(h)
    for g in range(n_groups):
        h, aux = _maybe_checkpoint(functools.partial(group, g), remat)(h, aux)
    if tail:
        t_mamba = _unstack(caches["tail_mamba"], tail) if decode else None
        for j, sub in enumerate(_unstack(params["tail"], tail)):
            h, _, _ = _apply_sublayer(
                "mamba", sub, cfg, h, positions=positions,
                cache=t_mamba[j] if decode else None, cache_pos=cache_pos)
    return h, caches, aux


def _run_blocks(params, cfg: ModelConfig, h, *, positions, caches,
                cache_pos, enc_out=None, remat=False):
    """The blocks in order (a loop in place of the reference's scan), each
    its pattern's sublayers in turn, then (Whisper) the cross-attention to
    ``enc_out``, or over the ``cross_kv`` cache in decode. Returns (h,
    caches, aux), aux the sum of every MoE sublayer's (f32, in the
    reference's order)."""
    if cfg.attn_every:
        return _run_hybrid(params, cfg, h, positions=positions,
                           caches=caches, cache_pos=cache_pos, remat=remat)
    pattern, nb = cfg.block_pattern, cfg.n_blocks
    subs = [_unstack(params["blocks"][f"{i}_{kind}"], nb)
            for i, kind in enumerate(pattern)]
    cross = _unstack(params["cross"], nb) if cfg.encoder_layers else None
    cache_blocks = cross_kv = None
    if caches is not None:
        cache_blocks = [_unstack(caches[f"{i}"], nb)
                        for i in range(len(pattern))]
        if cfg.encoder_layers:
            cross_kv = _unstack(caches["cross_kv"], nb)

    def block(b, h, aux):
        for i, kind in enumerate(pattern):
            cache = None if cache_blocks is None else cache_blocks[i][b]
            h, _, a = _apply_sublayer(kind, subs[i][b], cfg, h,
                                      positions=positions, cache=cache,
                                      cache_pos=cache_pos)
            aux = aux + a
        if enc_out is not None:
            h = _cross_attend(cross[b], cfg, h, enc_out=enc_out)
        elif cross_kv is not None:
            h = _cross_attend(cross[b], cfg, h, enc_kv=cross_kv[b])
        return h, aux

    aux = _zeros(h)
    for b in range(nb):
        h, aux = _maybe_checkpoint(functools.partial(block, b), remat)(h, aux)
    return h, caches, aux


# ---------------------------------------------------------------------------
# Embedding / heads / frontends
# ---------------------------------------------------------------------------

def _embed(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    h = params["embed"][batch["tokens"].long()]
    if cfg.frontend == "vision_tiles" and "patch_embeds" in batch:
        # stub vision tower: the precomputed patch embeddings, projected,
        # take the place of the prompt's first n positions
        pe = batch["patch_embeds"].to(h.dtype) @ params["patch_proj"]
        h = torch.cat([pe, h[:, pe.shape[1]:]], dim=1)
    return h


def _logits(params, cfg: ModelConfig, h) -> torch.Tensor:
    h = rms_norm(params["final_norm"], h, cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ head


def _positions(b: int, t: int, device) -> torch.Tensor:
    return torch.arange(t, device=device).expand(b, t)


def _run_encoder(params, cfg: ModelConfig, frames: torch.Tensor):
    """Whisper's encoder over the stub mel frames (B, S, AUDIO_DIM): the
    frame projection (the conv frontend's stub), the encoder blocks, the
    final norm. Its self-attention is causal, as the reference's (its
    blocks go through the decoder's sublayer, whose attention defaults to
    causal)."""
    enc = params["encoder"]
    h = frames.to(_dtype(cfg)) @ enc["frame_proj"]
    positions = _positions(h.shape[0], h.shape[1], h.device)
    for p in _unstack(enc["blocks"], cfg.encoder_layers):
        h, _, _ = _apply_sublayer("attn_dense", p, cfg, h,
                                  positions=positions, cache=None,
                                  cache_pos=None)
    return rms_norm(enc["final_norm"], h, cfg.norm_eps)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def forward(params, cfg: ModelConfig, batch: dict, *, remat: bool = False):
    """Full-sequence forward → (logits (B, T, vocab) in ``cfg.dtype``, aux:
    the MoE load-balance loss summed over the MoE sublayers, 0.0 without
    one)."""
    enc_out = None
    if cfg.encoder_layers:
        enc_out = _run_encoder(params, cfg, batch["frames"])
    h = _embed(params, cfg, batch)
    positions = _positions(h.shape[0], h.shape[1], h.device)
    h, _, aux = _run_blocks(params, cfg, h, positions=positions, caches=None,
                            cache_pos=None, enc_out=enc_out, remat=remat)
    return _logits(params, cfg, h), aux


def loss_fn(params, cfg: ModelConfig, batch: dict, *, remat: bool = False,
            aux_weight: float = 0.01):
    """Next-token cross-entropy over ``batch["tokens"]`` (B, T), masked by
    ``batch["loss_mask"]`` where given, else (LLaVA with patch embeddings)
    at the positions past the patches, plus ``aux_weight · aux /
    max(n_layers, 1)``. The logits are taken in ``cfg.dtype``, as the
    reference's, and cast to f32 for the log-sum-exp. Returns (total,
    {"nll", "aux", "tokens"}), all 0-d f32 tensors. On a mesh whose ranks
    split the rows (``lm_mesh.use_layout``), ``total`` is this rank's
    share: the shares sum to the global loss, and the metrics are the
    global ones."""
    logits, aux = forward(params, cfg, batch, remat=remat)
    logits = logits[:, :-1].float()
    targets = batch["tokens"][:, 1:].long()
    if "loss_mask" in batch:
        mask = batch["loss_mask"][:, 1:].float()
    elif cfg.frontend == "vision_tiles" and "patch_embeds" in batch:
        n = batch["patch_embeds"].shape[1]
        mask = (torch.arange(targets.shape[1], device=logits.device)
                >= n).float().expand(targets.shape)
    else:
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=logits.device)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets[..., None])[..., 0]
    nll = (logz - gold) * mask
    if lm_mesh.rows_size() == 1:
        denom = torch.clamp(mask.sum(), min=1.0)
        loss = nll.sum() / denom
        total = loss + aux_weight * aux / max(cfg.n_layers, 1)
        return total, {"nll": loss, "aux": aux, "tokens": denom}
    # the ranks split the rows: this rank's share of the global masked sum
    # over the GLOBAL token count (the counts differ between shards), and
    # its share of the balance loss (of the global means)
    denom = torch.clamp(lm_mesh.sum_rows(mask.sum()), min=1.0)
    loss = nll.sum() / denom
    total = loss + aux_weight * aux / max(cfg.n_layers, 1) \
        / lm_mesh.rows_size()
    return total, {"nll": lm_mesh.sum_rows(loss.detach()), "aux": aux,
                   "tokens": denom}


def prefill(params, cfg: ModelConfig, batch: dict):
    """Process a full prompt: the blocks without caches, then the logits of
    the last position. Returns (last_logits (B, 1, vocab), enc_out), as the
    reference does (the encoder's output for Whisper, else None)."""
    enc_out = None
    if cfg.encoder_layers:
        enc_out = _run_encoder(params, cfg, batch["frames"])
    h = _embed(params, cfg, batch)
    positions = _positions(h.shape[0], h.shape[1], h.device)
    h, _, _ = _run_blocks(params, cfg, h, positions=positions, caches=None,
                          cache_pos=None, enc_out=enc_out)
    return _logits(params, cfg, h[:, -1:]), enc_out


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
    """The LM as a module: parameters named as the reference's pytree
    (``embed``, ``blocks.0_attn_dense.attn.wq`` …); ``forward`` is
    :func:`forward`'s logits of ``tokens`` and the other inputs of the
    batch (``frames``, ``patch_embeds``). ``params`` gives the pytree the
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

    def forward(self, tokens: torch.Tensor, **inputs) -> torch.Tensor:
        return forward(self.params, self.cfg,
                       {"tokens": tokens, **inputs})[0]


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
