"""Attention-free sequence mixers of the LM zoo (the reference's
``models/ssm.py``): RWKV-6 "Finch" and Mamba2 (for Zamba2).

Both take the contract of attention: ``(params, cfg, x, state) → (out,
new_state)``, ``state`` the O(1) decode state. The reference runs the
recurrences with ``lax.scan`` over time; here a Python loop over time runs
the same operations in the same order. Everything that does not depend on
the carried state (the projections, the token shift, the decays) is
computed for the whole sequence before the loop, so that an iteration
launches only the recurrence. Where autograd records nothing (serving,
under ``torch.inference_mode()``) each step's output lands in a
preallocated tensor. Under grad, Mamba2's steps are stacked once at the
end, and RWKV's recurrence is one autograd function (``_WKV``) whose
backward walks the steps in reverse by hand.
``mamba_apply`` also has the reference's chunked SSD form
(:func:`_ssd_chunked`, ``torch.einsum`` where the reference uses einsums),
taken when ``tuning.flags().mamba_chunk`` divides a sequence longer than
one token; its masked factor is taken as ``exp`` of the masked exponent,
the reference's values with a finite gradient (the reference's form
overflows above the diagonal, and its gradient is NaN). Neither form
reaches a kernel of the port: the reference reaches no ``pallas_call``
here.

Parameters are dicts of tensors named as the reference's pytree. The
shapes come from :func:`rwkv_shapes` and :func:`mamba_shapes`, which
``models.lm.param_shapes`` stacks over blocks; ``INIT_RULES`` holds the
reference's initializer of each leaf not drawn N(0, 0.02²) (``mu`` and
``cm_mu`` uniform in [0, 1), ``u`` uniform in [-0.5, 0.5), ``w0`` -6,
``a_log`` the log of 1..16 over the heads, ``dt_bias`` 0, ``d_skip`` 1),
which ``models.layers.build_tree`` applies; the draws are not
``jax.random``'s.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import tuning
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import build_tree, rms_norm

RWKV_LORA = 64       # rank of RWKV-6's data-dependent decay (wA, wB)
WKV_BLOCK = 64       # RWKV time steps whose k ⊗ v is taken in one product


def _mamba_dims(cfg: ModelConfig) -> tuple[int, int, int, int]:
    """(d_inner, heads, state, head width) of a Mamba2 sublayer."""
    d_inner = 2 * cfg.d_model
    nheads = cfg.ssm_heads or max(1, d_inner // 128)
    return d_inner, nheads, cfg.ssm_state or 64, d_inner // nheads


def rwkv_shapes(cfg: ModelConfig, dtype, lead: tuple = ()) -> dict:
    """An RWKV-6 block's ``(shape, dtype)`` leaves, each shape behind
    ``lead``: the lerp coefficients, decay, bonus and norm scales in f32,
    the weights in ``dtype``."""
    d, h, f32 = cfg.d_model, cfg.n_heads, torch.float32

    def s(shape, dt=dtype):
        return (lead + shape, dt)

    norm = {"scale": s((d,), f32)}
    return {"mu": s((5, d), f32), "wr": s((d, d)), "wk": s((d, d)),
            "wv": s((d, d)), "wg": s((d, d)), "wo": s((d, d)),
            "w0": s((d,), f32), "wA": s((d, RWKV_LORA)),
            "wB": s((RWKV_LORA, d)), "u": s((h, d // h), f32),
            "ln_x": norm, "cm_mu": s((2, d), f32),
            "cm_k": s((d, cfg.d_ff)), "cm_v": s((cfg.d_ff, d)),
            "cm_r": s((d, d)), "ln1": norm, "ln2": norm}


def mamba_shapes(cfg: ModelConfig, dtype, lead: tuple = ()) -> dict:
    """A Mamba2 mixer's ``(shape, dtype)`` leaves behind ``lead``: the
    z/x, B/C and dt projections kept apart as in the reference, the
    depthwise conv, the per-head decay, bias and skip in f32, the gated
    norm and the output projection."""
    d = cfg.d_model
    d_inner, nheads, state, _ = _mamba_dims(cfg)
    f32 = torch.float32

    def s(shape, dt=dtype):
        return (lead + shape, dt)

    return {"in_proj_zx": s((d, 2 * d_inner)),
            "in_proj_bc": s((d, 2 * state)),
            "in_proj_dt": s((d, nheads)),
            "conv_w": s((4, d_inner + 2 * state)),
            "a_log": s((nheads,), f32), "dt_bias": s((nheads,), f32),
            "d_skip": s((nheads,), f32), "norm": {"scale": s((d_inner,), f32)},
            "out_proj": s((d_inner, d))}


def _a_log(t, generator):
    """The log of 1..16, spread over the heads (the last axis)."""
    heads = torch.linspace(1.0, 16.0, t.shape[-1], dtype=torch.float32,
                           device=t.device)
    return t.copy_(torch.log(heads).expand(t.shape))


# the reference's initializer of each SSM leaf whose draw is not N(0, 0.02²)
# (name -> fill of an empty tensor from a generator); norm scales are 1
INIT_RULES = {
    "d_skip": lambda t, g: t.fill_(1.0),
    "dt_bias": lambda t, g: t.zero_(),
    "w0": lambda t, g: t.fill_(-6.0),
    "mu": lambda t, g: t.uniform_(0.0, 1.0, generator=g),
    "cm_mu": lambda t, g: t.uniform_(0.0, 1.0, generator=g),
    "u": lambda t, g: t.uniform_(-0.5, 0.5, generator=g),
    "a_log": _a_log,
}


def init_rwkv(cfg: ModelConfig, dtype, *, generator=None, device=None):
    return build_tree(rwkv_shapes(cfg, dtype), generator, device, INIT_RULES)


def init_mamba(cfg: ModelConfig, dtype, *, generator=None, device=None):
    return build_tree(mamba_shapes(cfg, dtype), generator, device,
                      INIT_RULES)


# ---------------------------------------------------------------------------
# RWKV-6 (Finch): data-dependent decay linear recurrence
# ---------------------------------------------------------------------------

def rwkv_state_init(cfg: ModelConfig, batch: int, *, lead: tuple = (),
                    device=None) -> dict:
    """Zero token shifts (time and channel mix) and wkv state, f32, each
    behind ``lead``."""
    d, h = cfg.d_model, cfg.n_heads
    hd = d // h

    def z(*shape):
        return torch.zeros(lead + shape, dtype=torch.float32, device=device)

    return {"prev_x_tm": z(batch, d), "prev_x_cm": z(batch, d),
            "wkv": z(batch, h, hd, hd)}


def _tracks_grad(*ts) -> bool:
    """Whether autograd records a function of ``ts``: grad mode on and one
    of them requiring grad (a prefill outside ``inference_mode`` does
    not)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _wkv_scan(rs, ks, vs, ws, u, s, keep: bool = False):
    """The RWKV-6 recurrence over time-major r, k, v, w (T, B, H, hd), f32,
    from the state ``s`` (B, H, hd, hd): per step, kv = k ⊗ v, out = r ·
    (s + u ∘ kv), s ← w ∘ s + kv, the reference's scan body; kv and u ∘ kv
    are taken for WKV_BLOCK steps at a time ahead of the loop. Returns (out
    (T, B, H, hd), the last state, each step's incoming state (T, B, H, hd,
    hd) when ``keep``, else None)."""
    t = rs.shape[0]
    u = u[None, None, :, :, None]
    out = torch.empty_like(rs)
    states = s.new_empty((t,) + tuple(s.shape)) if keep else None
    # each step's views, taken once (a view per step costs the host as
    # much as a launch)
    r_rows, w_cols = rs[..., None, :].unbind(0), ws[..., None].unbind(0)
    out_rows = out[..., None, :].unbind(0)
    kept = states.unbind(0) if keep else None
    for t0 in range(0, t, WKV_BLOCK):
        t1 = min(t, t0 + WKV_BLOCK)
        kv = ks[t0:t1][..., :, None] * vs[t0:t1][..., None, :]
        kvs, ukvs = kv.unbind(0), (u * kv).unbind(0)
        for j, i in enumerate(range(t0, t1)):
            torch.matmul(r_rows[i], s + ukvs[j], out=out_rows[i])
            if keep:
                kept[i].copy_(s)
            s = w_cols[i] * s + kvs[j]
    return out, s, states


class _WKV(torch.autograd.Function):
    """:func:`_wkv_scan` under autograd: the forward runs the loop once,
    keeping each step's incoming state. The backward carries the state's
    gradient back through s ← w ∘ s + kv in a reverse loop of four ops a
    step, keeping it for every step, then takes the gradients of r, k, v,
    w and u for all steps at once (batched products over time): no graph
    of per-step nodes to build or walk."""

    @staticmethod
    def forward(ctx, rs, ks, vs, ws, u, s0):
        out, s, states = _wkv_scan(rs, ks, vs, ws, u, s0, keep=True)
        ctx.save_for_backward(rs, ks, vs, ws, u, states)
        return out, s

    @staticmethod
    def backward(ctx, d_out, d_s):
        rs, ks, vs, ws, u, states = ctx.saved_tensors
        if d_out is None:
            d_out = torch.zeros_like(rs)
        ds = torch.zeros_like(states[0]) if d_s is None else d_s
        # ds_after[i]: the gradient of the state step i leaves behind
        ds_after = torch.empty_like(states)
        steps = zip(ds_after.unbind(0), rs[..., :, None].unbind(0),
                    d_out[..., None, :].unbind(0), ws[..., None].unbind(0))
        for kept, r_col, d_row, w_col in reversed(list(steps)):
            kept.copy_(ds)
            ds = r_col * d_row + w_col * ds
        u5 = u[None, None, :, :, None]
        kv = ks[..., :, None] * vs[..., None, :]            # (T, B, H, k, v)
        dm = rs[..., :, None] * d_out[..., None, :]         # d(s + u∘kv)
        d_r = torch.matmul(states + u5 * kv, d_out[..., :, None])[..., 0]
        d_w = (ds_after * states).sum(-1)
        d_u = (dm * kv).sum(dim=(0, 1, 4))
        dkv = u5 * dm + ds_after
        d_k = torch.matmul(dkv, vs[..., :, None])[..., 0]
        d_v = torch.matmul(ks[..., None, :], dkv)[..., 0, :]
        return d_r, d_k, d_v, d_w, d_u, ds


def rwkv_apply(p, cfg: ModelConfig, x: torch.Tensor, state: dict):
    """x (B, T, D) → (out, new_state): one full RWKV block, the time mix
    and the channel mix, each with its pre-norm and residual."""
    b, t, d = x.shape
    h = cfg.n_heads
    hd = d // h

    # ---- time mix ----
    x_res = x
    x = rms_norm(p["ln1"], x)
    x_prev = torch.cat([state["prev_x_tm"][:, None].to(x.dtype),
                        x[:, :-1]], dim=1)
    xx = x_prev - x
    mu = p["mu"].to(x.dtype)
    xr, xk, xv, xg, xw = (x + xx * mu[i] for i in range(5))
    r = (xr @ p["wr"]).reshape(b, t, h, hd)
    k = (xk @ p["wk"]).reshape(b, t, h, hd)
    v = (xv @ p["wv"]).reshape(b, t, h, hd)
    g = xg @ p["wg"]
    logw = -torch.exp(
        p["w0"] + (torch.tanh(xw @ p["wA"]) @ p["wB"]).float())
    w = torch.exp(logw).reshape(b, t, h, hd)             # decay in (0, 1)

    rs, ks, vs, ws = (a.transpose(0, 1).float() for a in (r, k, v, w))
    if _tracks_grad(rs, ks, vs, ws, p["u"], state["wkv"]):
        out, s = _WKV.apply(rs, ks, vs, ws, p["u"], state["wkv"])
    else:
        out, s, _ = _wkv_scan(rs, ks, vs, ws, p["u"], state["wkv"])
    out = out.transpose(0, 1).reshape(b, t, d)
    out = rms_norm(p["ln_x"], out.to(x.dtype))
    out = out * F.silu(g)
    y_res = x_res + (out @ p["wo"]).to(x.dtype)

    # ---- channel mix ----
    y = rms_norm(p["ln2"], y_res)
    y_prev = torch.cat([state["prev_x_cm"][:, None].to(y.dtype),
                        y[:, :-1]], dim=1)
    yy = y_prev - y
    cmu = p["cm_mu"].to(y.dtype)
    yk = y + yy * cmu[0]
    yr = y + yy * cmu[1]
    kk = torch.square(torch.relu(yk @ p["cm_k"]))
    out_cm = torch.sigmoid(yr @ p["cm_r"]) * (kk @ p["cm_v"])
    z = y_res + out_cm.to(y.dtype)

    new_state = {"prev_x_tm": x[:, -1].float(),
                 "prev_x_cm": y[:, -1].float(), "wkv": s}
    return z, new_state


# ---------------------------------------------------------------------------
# Mamba2 (SSD): scalar-per-head decay selective state space
# ---------------------------------------------------------------------------

def mamba_state_init(cfg: ModelConfig, batch: int, *, lead: tuple = (),
                     device=None) -> dict:
    """Zero conv history (the last 3 rows of x, B, C) and SSM state, f32,
    each behind ``lead``."""
    d_inner, nheads, state, hd = _mamba_dims(cfg)

    def z(*shape):
        return torch.zeros(lead + shape, dtype=torch.float32, device=device)

    return {"conv": z(batch, 3, d_inner + 2 * state),
            "ssm": z(batch, nheads, hd, state)}


def mamba_apply(p, cfg: ModelConfig, x: torch.Tensor, state: dict, *,
                chunk: int = 0):
    """x (B, T, D) → (out, new_state). ``chunk`` > 0 takes the SSD blocked
    path; 0 takes ``tuning.flags().mamba_chunk`` where it divides T > 1,
    else the scan."""
    b, t, d = x.shape
    if chunk == 0:
        c = tuning.flags().mamba_chunk
        if c and t > 1 and t % c == 0:
            chunk = c
    d_inner, nheads, nstate, hd = _mamba_dims(cfg)

    zx = x @ p["in_proj_zx"]
    z, xs_raw = zx[..., :d_inner], zx[..., d_inner:]
    bc = x @ p["in_proj_bc"]
    dt = x @ p["in_proj_dt"]
    xbc = torch.cat([xs_raw, bc], dim=-1)
    # depthwise causal conv over (x, B, C), kernel 4, carrying conv state
    xbc_hist = torch.cat([state["conv"].to(xbc.dtype), xbc], dim=1)
    conv_w = p["conv_w"]
    xbc_conv = sum(xbc_hist[:, i:i + t] * conv_w[i] for i in range(4))
    xbc_conv = F.silu(xbc_conv)
    xs = xbc_conv[..., :d_inner].reshape(b, t, nheads, hd)
    bmat = xbc_conv[..., d_inner:d_inner + nstate]
    cmat = xbc_conv[..., d_inner + nstate:]
    dt = F.softplus(dt.float() + p["dt_bias"])           # (B, T, H)
    a = -torch.exp(p["a_log"])                           # (H,) negative
    decay = torch.exp(dt * a)                            # (B, T, H) in (0, 1)
    bx = dt[..., None] * xs.float()                      # (B, T, H, hd)

    if chunk:
        yout, new_ssm = _ssd_chunked(xs, bmat, cmat, decay, bx,
                                     state["ssm"], chunk)
    else:
        bxs = bx.transpose(0, 1)                         # time-major
        grad = _tracks_grad(decay, bx, bmat, cmat, state["ssm"])
        ys = [] if grad else torch.empty_like(bxs)
        steps = zip(decay.transpose(0, 1)[..., None, None].unbind(0),
                    bxs[..., None].unbind(0),
                    bmat.transpose(0, 1).float()[:, :, None, None]
                    .unbind(0),
                    cmat.transpose(0, 1).float()[:, :, None, :, None]
                    .unbind(0),
                    [None] * t if grad else ys[..., None].unbind(0))
        s = state["ssm"]
        for dec, bx_col, b_row, c_col, y_col in steps:
            s = dec * s + bx_col * b_row                 # (B, H, hd, S)
            if grad:
                ys.append(torch.matmul(s, c_col)[..., 0])
            else:
                torch.matmul(s, c_col, out=y_col)
        new_ssm = s
        yout = (torch.stack(ys) if grad else ys).transpose(0, 1)

    yout = yout + p["d_skip"][None, None, :, None] * xs.float()
    yout = yout.reshape(b, t, d_inner).to(x.dtype)
    yout = rms_norm(p["norm"], yout) * F.silu(z)
    out = yout @ p["out_proj"]
    new_state = {"conv": xbc_hist[:, -3:].float(), "ssm": new_ssm}
    return out.to(x.dtype), new_state


def _ssd_chunked(xs, bmat, cmat, decay, bx, s0, chunk: int):
    """SSD blocked evaluation: an intra-chunk "attention" product plus the
    state carried across chunks (a loop over the chunks). The decay is
    scalar per (B, T, H), so the pairwise factor exp(L_i − L_j) ≤ 1 for
    i ≥ j and the blocked form is stable."""
    b, t, h, hd = xs.shape
    n = t // chunk
    if t % chunk:
        raise ValueError(f"chunk {chunk} does not divide T={t}")
    ns = bmat.shape[-1]
    logd = torch.log(torch.clamp(decay, min=1e-38))      # (B, T, H)
    bx_c = bx.reshape(b, n, chunk, h, hd)
    bm_c = bmat.reshape(b, n, chunk, ns).float()
    cm_c = cmat.reshape(b, n, chunk, ns).float()
    ld_c = logd.reshape(b, n, chunk, h)
    lcum = torch.cumsum(ld_c, dim=2)                     # inclusive
    ltot = lcum[:, :, -1]                                # (B, N, H)

    # intra-chunk: y_i += Σ_{j≤i} exp(lcum_i - lcum_j) (c_i·b_j) bx_j
    scores = torch.einsum("bncs,bnks->bnck", cm_c, bm_c)  # (B, N, C, C)
    rel = lcum[:, :, :, None, :] - lcum[:, :, None, :, :]  # (B, N, C, C, H)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=xs.device))
    # exp of the masked exponent: the reference's where(causal, exp(rel), 0)
    # has these values, but above the diagonal exp(rel) overflows to inf
    # and its gradient is 0 * inf = NaN (a_log, dt_bias and in_proj_dt
    # train to NaN); exp(-inf) is 0 and so is its gradient
    att = torch.exp(torch.where(causal[None, None, :, :, None], rel,
                                -torch.inf)) * scores[..., None]
    y_intra = torch.einsum("bnckh,bnkhd->bnchd", att, bx_c)

    # inter-chunk: carry the state across chunks
    chunk_kv = torch.einsum("bnkh,bnks,bnkhd->bnhds",
                            torch.exp(ltot[:, :, None, :] - lcum), bm_c,
                            bx_c)
    s = s0
    y_cross = []
    for i in range(n):
        # y_cross_i = c_i · (exp(lcum_i) * s)
        y_cross.append(torch.einsum("bch,bcs,bhds->bchd",
                                    torch.exp(lcum[:, i]), cm_c[:, i], s))
        s = torch.exp(ltot[:, i])[:, :, None, None] * s + chunk_kv[:, i]
    y = y_intra + torch.stack(y_cross, dim=1)
    return y.reshape(b, t, h, hd), s
