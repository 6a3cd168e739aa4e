"""Shared layers of the LM zoo (the reference's ``models/layers.py``): the
norms, RoPE, self-attention with GQA, qk-norm, a sliding window and a
decode-time KV cache, and the SwiGLU FFN.

Parameters are dicts of tensors named as the reference's pytree. Attention
runs one of three impls, chosen by ``tuning.flags().attention_impl``:
``"xla_packed"`` (triangle-packed blocked attention, the default),
``"xla_chunked"`` (plain blocked online softmax) and ``"pallas"`` (the
flash-attention kernel, :mod:`repro_torch.kernels.flash_attention`, which
takes K/V with their KV heads unrepeated; its plain version on the CPU).
The two plain impls mask with ``-inf`` and guard fully masked rows as the
reference does; on bf16 inputs they take the score and p·v products in
f32, as the reference's ``preferred_element_type=float32``. Single-token
decode attends over the whole cache by plain products and never reaches the
kernel, as in the reference.

The decode cache is written in place (the reference's
``dynamic_update_slice`` returns a new array): ``attention_apply`` returns
the same cache dict it was given. Cross-attention (whisper's decoder) takes
K and V projected from a source sequence ``xa`` without RoPE and masks
nothing (under ``"pallas"`` the kernel with ``causal=False`` and Tq ≠ Tk,
else ``chunked_attention``), or, with ``cache_mode="read_all"``, attends
over a static K/V cache by plain products, writing nothing.

MoE (``init_moe``, ``moe_apply``) routes each token to its top-k experts
with a per-expert capacity and runs the experts as one batched product
over the expert axis, the reference's einsums; it never calls the grouped
matmul kernel, as the reference never calls ``_gmm``.

On a mesh (``repro_torch.distributed.lm_mesh``'s layout) the same code
runs on this rank's rows and shards: attention takes its local head
counts from ``wq`` / ``wk``'s shards and, when they are the Megatron
pair's, sums its row product over "model"; the dense SwiGLU likewise
(``ffn_apply(tp=True)``). Decode over caches whose sequence axis "model"
splits is the reference's sequence-parallel decode (``constrain_decode``):
each rank scores its cache slots, and the per-rank (max, sum, output)
combine in rank order. The MoE balance loss takes the global means, and the
scatter dispatch's slots are token-major over the global batch.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import tuning
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import lm_mesh
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch.mesh import all_gather_cat, axis_rank


def _normal(shape, dtype, generator, device) -> torch.Tensor:
    """N(0, 0.02²) draws, the reference's ``initializers.normal(0.02)``."""
    return torch.empty(shape, dtype=dtype, device=device).normal_(
        0.0, 0.02, generator=generator)


def build_tree(shapes: dict, generator, device, rules=None) -> dict:
    """The tensors of a ``(shape, dtype)`` tree, drawn leaf by leaf in the
    tree's order straight into each tensor: a leaf named in ``rules``
    (name -> fill of an empty tensor from ``generator``) by its rule, norm
    scales 1, every other leaf N(0, 0.02²)."""
    rules = rules or {}

    def build(node, name):
        if isinstance(node, dict):
            return {k: build(v, k) for k, v in sorted(node.items())}
        t = torch.empty(node[0], dtype=node[1], device=device)
        if name in rules:
            return rules[name](t, generator)
        if name == "scale":
            return t.fill_(1.0)
        return t.normal_(0.0, 0.02, generator=generator)

    return build(shapes, "")


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_rms_norm(d, *, device=None):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rms_norm(p, x, eps=1e-5):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


def init_layer_norm(d, *, device=None):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def layer_norm(p, x, eps=1e-5):
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps) * p["scale"]
            + p["bias"]).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., T, H, hd); positions: (..., T) int. Split halves, angles in
    f32, the result cast back to x's type."""
    hd = x.shape[-1]
    freqs = theta ** (-torch.arange(0, hd, 2, dtype=torch.float32,
                                    device=x.device) / hd)
    ang = positions[..., None].float() * freqs            # (..., T, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def init_attention(cfg: ModelConfig, dtype, *, generator=None, device=None):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": _normal((d, h * hd), dtype, generator, device),
         "wk": _normal((d, kv * hd), dtype, generator, device),
         "wv": _normal((d, kv * hd), dtype, generator, device),
         "wo": _normal((h * hd, d), dtype, generator, device)}
    if cfg.qk_norm:
        p["q_norm"] = init_rms_norm(hd, device=device)
        p["k_norm"] = init_rms_norm(hd, device=device)
    return p


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, T, KV, hd) → (B, T, KV·groups, hd)."""
    return k.repeat_interleave(groups, dim=2)


def _online_update(state, s, mask, vb):
    """One online-softmax step of the plain impls over a (…, q, k) score
    block ``s`` (masked to -inf where ``mask`` is False), fully masked rows
    guarded by ``m_safe``; returns the new (acc, m, l)."""
    acc, m, l = state
    s = torch.where(mask, s, -torch.inf)
    m_new = torch.maximum(m, s.amax(dim=-1))
    m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
    p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
    corr = torch.exp(torch.where(torch.isneginf(m), m_safe, m) - m_safe)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                   vb.float())
    return acc_new, m_new, l_new


def _pad_seq(x: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad axis 1 of a (B, T, H, hd) tensor to length ``n``."""
    return F.pad(x, (0, 0, 0, 0, 0, n - x.shape[1]))


def chunked_attention(q, k, v, *, causal: bool, q_offset=0, window: int = 0,
                      q_block: int = 0, kv_block: int = 0):
    """Online-softmax blocked attention (plain flash attention): q (B, Tq,
    H, hd), k and v (B, Tk, H, hd) (already GQA-expanded); a loop over q
    blocks, and in each over every kv block."""
    b, tq, h, hd = q.shape
    tk = k.shape[1]
    scale = hd ** -0.5
    q_block = min(q_block or tuning.flags().q_block, tq)
    kv_block = min(kv_block or tuning.flags().kv_block, tk)
    nq, nk = -(-tq // q_block), -(-tk // kv_block)
    qp, kp, vp = (_pad_seq(q, nq * q_block), _pad_seq(k, nk * kv_block),
                  _pad_seq(v, nk * kv_block))
    dev = q.device
    q_pos = q_offset + torch.arange(nq * q_block, device=dev).reshape(
        nq, q_block)
    k_pos = torch.arange(nk * kv_block, device=dev).reshape(nk, kv_block)
    k_valid = k_pos < tk
    outs = []
    for iq in range(nq):
        qb = qp[:, iq * q_block:(iq + 1) * q_block].float()
        qpos = q_pos[iq]
        state = (torch.zeros((b, h, q_block, hd), device=dev),
                 torch.full((b, h, q_block), -torch.inf, device=dev),
                 torch.zeros((b, h, q_block), device=dev))
        for ik in range(nk):
            kb = kp[:, ik * kv_block:(ik + 1) * kv_block]
            vb = vp[:, ik * kv_block:(ik + 1) * kv_block]
            s = torch.einsum("bqhd,bkhd->bhqk", qb, kb.float()) * scale
            mask = k_valid[ik][None, :].expand(q_block, kv_block)
            if causal:
                mask = mask & (k_pos[ik][None, :] <= qpos[:, None])
            if window:
                mask = mask & (k_pos[ik][None, :] > qpos[:, None] - window)
            state = _online_update(state, s, mask, vb)
        acc, _, l = state
        out = acc / torch.clamp(l, min=1e-20)[..., None]
        outs.append(out.transpose(1, 2))                 # (B, qb, H, hd)
    return torch.cat(outs, dim=1)[:, :tq].to(q.dtype)


def packed_causal_attention(q, k, v, *, window: int = 0, block: int = 0):
    """Triangle-packed blocked causal attention: only the (iq, ik) block
    pairs on or below the diagonal (and, with a window, those that meet the
    window band) are visited, in the reference's order (``np.tril_indices``,
    then the band filter); each q block carries its own online-softmax
    state."""
    b, t, h, hd = q.shape
    fl = tuning.flags()
    block = min(block or max(fl.q_block, fl.kv_block), t)
    nb = -(-t // block)
    qp, kp, vp = (_pad_seq(x, nb * block) for x in (q, k, v))
    iqs, iks = np.tril_indices(nb)
    if window:
        keep = (iks + 1) * block - 1 > iqs * block - window
        iqs, iks = iqs[keep], iks[keep]
    scale = hd ** -0.5
    dev = q.device
    pos = torch.arange(block, device=dev)
    state = [(torch.zeros((b, h, block, hd), device=dev),
              torch.full((b, h, block), -torch.inf, device=dev),
              torch.zeros((b, h, block), device=dev)) for _ in range(nb)]
    for iq, ik in zip(iqs.tolist(), iks.tolist()):
        qb = qp[:, iq * block:(iq + 1) * block]
        kb = kp[:, ik * block:(ik + 1) * block]
        vb = vp[:, ik * block:(ik + 1) * block]
        s = torch.einsum("bqhd,bkhd->bhqk", qb.float(), kb.float()) * scale
        qpos = iq * block + pos[:, None]
        kpos = ik * block + pos[None, :]
        mask = (kpos <= qpos) & (kpos < t)
        if window:
            mask &= kpos > qpos - window
        state[iq] = _online_update(state[iq], s, mask, vb)
    out = torch.cat([acc / torch.clamp(l, min=1e-20)[..., None]
                     for acc, _, l in state], dim=2)     # (B, H, nb·blk, hd)
    return out.transpose(1, 2)[:, :t].to(q.dtype)


def _decode_attention(q, k, v, cfg: ModelConfig, cache_pos: int):
    """Single-token attention over the whole cache (B, S, H, hd): slots
    that hold no position yet, or one outside the window (ring buffer), are
    masked; a plain product, as in the reference."""
    s_cache = k.shape[1]
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    valid = _valid_slots(torch.arange(s_cache, device=q.device), cfg,
                         cache_pos, s_cache)
    s = torch.where(valid[None, None, None, :], s, -torch.inf)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v.float())


def _mesh_decode(q, k, v, ck, cv, cfg: ModelConfig, cache_pos: int,
                 tp: bool):
    """Decode attention over a mesh's "model" axis of more than one rank:
    q (B, 1, H, hd) and the step's k, v (B, 1, KV, hd) (this rank's heads
    under ``tp``, gathered first), the rank's cache ``ck``, ``cv``. The
    step's k/v are written into the slot's owner. With the cache's
    sequence split over "model" and ``constrain_decode``, each rank scores
    its own slots and the (max, sum, output) of every rank combine in rank
    order (the same sums on every rank); otherwise the cache is gathered
    at use. Returns (B, 1, H, hd) in f32, all heads."""
    lay = lm_mesh.layout()
    mesh = lay.mesh
    if tp:
        q, k, v = (all_gather_cat(x, mesh, "model", 2) for x in (q, k, v))
    s_loc = ck.shape[1]
    s_glob = s_loc * lay.model if lay.kv_seq else s_loc
    slot = cache_pos % s_glob if cfg.window else cache_pos
    slot = max(0, min(slot, s_glob - 1))
    base = axis_rank(mesh, "model") * s_loc if lay.kv_seq else 0
    if base <= slot < base + s_loc:
        ck[:, slot - base] = k[:, 0].to(ck.dtype)
        cv[:, slot - base] = v[:, 0].to(cv.dtype)
    groups = cfg.n_heads // cfg.n_kv_heads
    if not (lay.kv_seq and tuning.flags().constrain_decode):
        if lay.kv_seq:                          # gathered at use
            ck, cv = (all_gather_cat(c, mesh, "model", 1) for c in (ck, cv))
        return _decode_attention(q, _repeat_kv(ck, groups),
                                 _repeat_kv(cv, groups), cfg, cache_pos)
    kr, vr = _repeat_kv(ck, groups), _repeat_kv(cv, groups)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) \
        * q.shape[-1] ** -0.5
    valid = _valid_slots(base + torch.arange(s_loc, device=q.device), cfg,
                         cache_pos, s_glob)
    s = torch.where(valid[None, None, None, :], s, -torch.inf)
    mx = s.amax(dim=-1)                                   # (B, H, 1)
    m_safe = torch.where(torch.isneginf(mx), 0.0, mx)
    p = torch.where(valid[None, None, None, :],
                    torch.exp(s - m_safe[..., None]), 0.0)
    stats = all_gather_cat(torch.stack([mx, p.sum(-1)])[None], mesh,
                           "model", 0)                    # (m, 2, B, H, 1)
    outs = all_gather_cat(torch.einsum("bhqk,bkhd->bhqd", p,
                                       vr.float())[None], mesh, "model", 0)
    top = stats[:, 0].amax(dim=0)
    total = torch.zeros_like(top)
    out = torch.zeros_like(outs[0])
    for r in range(stats.shape[0]):                       # rank order
        w = torch.exp(torch.where(torch.isneginf(stats[r, 0]), -torch.inf,
                                  stats[r, 0] - top))
        total = total + stats[r, 1] * w
        out = out + outs[r] * w[..., None]
    return (out / total[..., None]).transpose(1, 2)


def _valid_slots(slots, cfg: ModelConfig, cache_pos: int, s_cache: int):
    """Which cache ``slots`` hold a position the step at ``cache_pos``
    attends: written yet and, with a window (ring buffer of ``s_cache``
    slots), inside it."""
    if cfg.window:
        # slot s holds absolute position cache_pos - ((cache_pos - s) mod S)
        age = torch.remainder(cache_pos - slots, s_cache)
        exists = (slots <= cache_pos) | (cache_pos >= s_cache)
        return exists & (age < cfg.window)
    return slots <= cache_pos


def attention_apply(p, cfg: ModelConfig, x: torch.Tensor, *,
                    positions: torch.Tensor, causal: bool = True,
                    kv_cache: dict | None = None, cache_pos: int | None = None,
                    xa=None, cache_mode: str = "write"):
    """Self- or cross-attention with GQA, optional qk-norm, RoPE (self only),
    window and an optional decode-time KV cache ``{"k", "v"}`` (B, S, KV,
    hd): written in place at ``cache_pos`` (a ring buffer when
    ``cfg.window``) for self-attention; read whole, unwritten and unmasked,
    with ``cache_mode="read_all"`` (cross-attention over a precomputed
    cache). ``xa`` (B, Ta, D) is the cross-attention source. The head
    counts are ``wq`` / ``wk``'s: fewer than the config's when they are a
    mesh rank's Megatron shards (the output is then summed over "model").
    Returns (out, the cache)."""
    b, t, _ = x.shape
    hd = cfg.head_dim
    h, kv = p["wq"].shape[-1] // hd, p["wk"].shape[-1] // hd
    tp = h != cfg.n_heads
    if tp:                      # the Megatron pair's input
        x = lm_mesh.copy_to_model(x)
        xa = None if xa is None else lm_mesh.copy_to_model(xa)
        p = {**p, **{n: {"scale": lm_mesh.copy_to_model(p[n]["scale"])}
                     for n in ("q_norm", "k_norm") if n in p}}
    q = (x @ p["wq"]).reshape(b, t, h, hd)
    if kv_cache is not None and cache_mode == "read_all":
        # a static cache: no projection of the source, no write, no mask
        ck, cv = kv_cache["k"], kv_cache["v"]
        if tp:
            ck, cv = (lm_mesh.heads_of_rank(c, kv) for c in (ck, cv))
        if cfg.qk_norm:
            q = rms_norm(p["q_norm"], q)
        groups = h // ck.shape[2]
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                         _repeat_kv(ck, groups).float()) * hd ** -0.5
        w = torch.softmax(s, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", w,
                           _repeat_kv(cv, groups).float()).to(x.dtype)
        return _out_proj(p, out.reshape(b, t, h * hd), x.dtype, tp), \
            kv_cache
    src = x if xa is None else xa
    k = (src @ p["wk"]).reshape(b, src.shape[1], kv, hd)
    v = (src @ p["wv"]).reshape(b, src.shape[1], kv, hd)
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q)
        k = rms_norm(p["k_norm"], k)
    if xa is None:                               # RoPE on self-attention only
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    causal = causal and xa is None

    lay = lm_mesh.layout()
    if kv_cache is not None and xa is None and lay is not None \
            and lay.model > 1:
        out = _mesh_decode(q, k, v, kv_cache["k"], kv_cache["v"], cfg,
                           cache_pos, tp)
        if tp:
            out = lm_mesh.heads_of_rank(out, h)
        out = out.to(x.dtype)
    elif kv_cache is not None and xa is None:
        ck, cv = kv_cache["k"], kv_cache["v"]
        s_cache = ck.shape[1]
        slot = cache_pos % s_cache if cfg.window else cache_pos
        # dynamic_update_slice clamps the start so that the update fits
        slot = max(0, min(slot, s_cache - t))
        ck[:, slot:slot + t] = k.to(ck.dtype)
        cv[:, slot:slot + t] = v.to(cv.dtype)
        groups = h // ck.shape[2]
        out = _decode_attention(q, _repeat_kv(ck, groups),
                                _repeat_kv(cv, groups), cfg,
                                cache_pos).to(x.dtype)
    else:
        impl = tuning.flags().attention_impl
        if impl == "pallas":
            # the kernel reads KV head h // groups itself: no repeat
            out = flash_attention(q, k, v, causal=causal,
                                  window=cfg.window).to(x.dtype)
        else:
            groups = h // kv
            k, v = _repeat_kv(k, groups), _repeat_kv(v, groups)
            if impl == "xla_packed" and causal and k.shape[1] == t:
                out = packed_causal_attention(q, k, v, window=cfg.window)
            else:
                out = chunked_attention(q, k, v, causal=causal,
                                        window=cfg.window)
    return _out_proj(p, out.reshape(b, t, h * hd), x.dtype, tp), kv_cache


def _out_proj(p, out, dtype, tp: bool):
    """``out @ wo`` in ``dtype``; under ``tp`` the rank's partial row
    product, summed over "model"."""
    out = (out @ p["wo"]).to(dtype)
    return lm_mesh.reduce_from_model(out) if tp else out


# ---------------------------------------------------------------------------
# FFN: SwiGLU and MoE
# ---------------------------------------------------------------------------

def init_ffn(d: int, d_ff: int, dtype, *, generator=None, device=None):
    return {"w_gate": _normal((d, d_ff), dtype, generator, device),
            "w_up": _normal((d, d_ff), dtype, generator, device),
            "w_down": _normal((d_ff, d), dtype, generator, device)}


def ffn_apply(p, x, tp: bool = False):
    """SwiGLU; under ``tp`` the weights are this rank's Megatron shards
    (``w_gate`` / ``w_up`` columns, ``w_down`` rows) and the output is
    summed over "model"."""
    if not tp:
        return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    x = lm_mesh.copy_to_model(x)
    return lm_mesh.reduce_from_model(
        (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"])


def init_moe(cfg: ModelConfig, dtype, *, generator=None, device=None):
    """The router (f32), the stacked expert weights (``cfg.dtype``) and,
    with ``cfg.shared_expert``, the always-on expert's FFN."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    p = {"router": _normal((d, e), torch.float32, generator, device),
         "w_gate": _normal((e, d, f), dtype, generator, device),
         "w_up": _normal((e, d, f), dtype, generator, device),
         "w_down": _normal((e, f, d), dtype, generator, device)}
    if cfg.shared_expert:
        p["shared"] = init_ffn(d, f, dtype, generator=generator,
                               device=device)
    return p


def _capacity(capacity_factor: float, n: int, k: int, e: int) -> int:
    """Slots per expert for ``n`` tokens of a dispatch group: the
    reference's ``max(int(cf·n·k/e), 8)`` rounded up to a multiple of 8."""
    cap = max(int(capacity_factor * n * k / e), 8)
    return -(-cap // 8) * 8


def _route(p, cfg: ModelConfig, x):
    """Router softmax over the experts (in f32), the top-k gates
    renormalised to sum to 1 and their expert ids, and the load-balance
    aux ``e · Σ mean(probs) · mean(onehot(top-1))`` over every token of
    ``x`` (..., D). The top k come from a stable descending sort, so equal
    probabilities rank the lower expert first, as ``lax.top_k`` does."""
    e, k = cfg.n_experts, cfg.top_k
    probs = torch.softmax(x.float() @ p["router"], dim=-1)
    gate_vals, eids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, eids = gate_vals[..., :k], eids[..., :k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    tokens = tuple(range(probs.dim() - 1))
    onehot = F.one_hot(eids[..., 0], e).float()
    lay = lm_mesh.layout()
    if lay is None or not lay.rows:
        me, ce = probs.mean(dim=tokens), onehot.mean(dim=tokens)
    else:
        # a product of GLOBAL means: the per-expert sums and the token count
        # summed over the ranks that split the rows
        n = lm_mesh.sum_rows(torch.tensor(float(probs[..., 0].numel()),
                                          device=probs.device))
        me = lm_mesh.sum_rows_grad(probs.sum(dim=tokens)) / n
        ce = lm_mesh.sum_rows(onehot.sum(dim=tokens)) / n
    return gate_vals, eids, e * torch.sum(me * ce)


def _dispatch_experts(p, cfg: ModelConfig, x, gate_vals, eids, cap: int,
                      global_rows: bool = False):
    """Capacity dispatch of ``x`` (G, n, D) in G independent groups, ONE
    batched expert product over every (group, expert) buffer, and the
    gated combine. A (token, k) pair takes the next slot of its expert in
    token-major order; past ``cap`` it is dropped (the reference's drop
    bucket at slot ``cap``, whose sums are discarded). With
    ``global_rows`` (one group, on a mesh whose ranks split the rows) the
    order runs over the global batch: the slots start past the pairs of
    every earlier rank. The dispatch is a gather: each slot reads its one
    source token, and an empty slot or a dropped pair reads a zero row, so
    no slot is ever summed into and the result does not depend on the
    order of a scatter. Returns (G, n, D)."""
    g, n, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    flat_e = eids.reshape(g, n * k)
    onehot = F.one_hot(flat_e, e)                        # (G, n·k, E)
    pos = (onehot.cumsum(dim=1) * onehot).sum(-1) - 1     # slot in expert
    if global_rows:
        pos = pos + lm_mesh.row_offset(onehot.sum(dim=(0, 1)))[flat_e]
    keep = pos < cap
    group = torch.arange(g, device=x.device)[:, None]
    trash = g * e * cap                                   # a zero row
    dest = torch.where(keep, (group * e + flat_e) * cap + pos, trash)
    token = group * n + torch.arange(n * k, device=x.device) // k
    src = torch.full((trash + 1,), g * n, dtype=torch.int64,
                     device=x.device).scatter_reduce(
        0, dest.reshape(-1), token.reshape(-1), "amin")
    rows = F.pad(x.reshape(g * n, d), (0, 0, 0, 1))       # row g·n is 0
    buf = rows[src[:trash]].reshape(g, e, cap, d)
    # the reference's expert-parallel layout hints have no counterpart:
    # each rank computes every expert on its rows
    hidden = F.silu(torch.einsum("gecd,edf->gecf", buf, p["w_gate"])) \
        * torch.einsum("gecd,edf->gecf", buf, p["w_up"])
    out_buf = torch.einsum("gecf,efd->gecd", hidden, p["w_down"])
    gathered = F.pad(out_buf.reshape(trash, d), (0, 0, 0, 1))[dest]
    w = gate_vals.reshape(g, n * k, 1).to(x.dtype) \
        * keep[..., None].to(x.dtype)
    return (gathered * w).reshape(g, n, k, d).sum(dim=2)


def _moe_grouped(p, cfg: ModelConfig, x, capacity_factor):
    """Grouped local dispatch: each sequence of ``x`` (B, T, D) is its own
    dispatch group with its own capacity (computed from T)."""
    b, t, _ = x.shape
    gate_vals, eids, aux = _route(p, cfg, x)
    out = _dispatch_experts(p, cfg, x, gate_vals, eids,
                            _capacity(capacity_factor, t, cfg.top_k,
                                      cfg.n_experts))
    if cfg.shared_expert:
        out = out + ffn_apply(p["shared"], x, lm_mesh.tp_ffn(cfg))
    return out, aux


def moe_apply(p, cfg: ModelConfig, x: torch.Tensor, *, capacity_factor=None):
    """Top-k MoE over ``x`` (B, T, D) with capacity dispatch and one batched
    expert product (``torch.einsum`` over the expert axis, as the
    reference's einsums). ``tuning.flags().moe_dispatch``: ``"grouped"``
    (per-sequence capacity) or ``"scatter"`` / ``"sharded_scatter"`` (one
    group of all B·T tokens, of the global batch on a mesh; the sharded
    form's constraints are layout hints only). ``capacity_factor``
    defaults to the flag's.
    Returns (out (B, T, D), aux)."""
    fl = tuning.flags()
    if capacity_factor is None:
        capacity_factor = fl.capacity_factor
    if fl.moe_dispatch == "grouped":
        return _moe_grouped(p, cfg, x, capacity_factor)
    b, t, d = x.shape
    n, k = b * t, cfg.top_k
    gate_vals, eids, aux = _route(p, cfg, x.reshape(n, d))
    lay = lm_mesh.layout()
    split = lay is not None and bool(lay.rows)
    out = _dispatch_experts(p, cfg, x.reshape(1, n, d),
                            gate_vals.reshape(1, n, k),
                            eids.reshape(1, n, k),
                            _capacity(capacity_factor,
                                      n * lm_mesh.rows_size(), k,
                                      cfg.n_experts), global_rows=split)
    out = out.reshape(n, d)
    if cfg.shared_expert:
        out = out + ffn_apply(p["shared"], x.reshape(n, d),
                              lm_mesh.tp_ffn(cfg))
    return out.reshape(b, t, d), aux
