"""Flash attention — causal, sliding-window and GQA online-softmax
attention, the ``attention_impl="pallas"`` branch of
``models/layers.attention_apply`` — as a hand-written kernel.

The kernel is ``csrc/flash_attention.cu`` (one block per (64-row q tile,
head, batch), K/V tiles of 64 keys through shared memory widened to f32,
f32 FMAs, the online-softmax state in registers, tiles that no row may
attend skipped); the plain version is
:func:`repro_torch.kernels.ref.flash_attention_plain`, the same blocked
recurrence over the same 64-key tiles. Both keep the reference kernel's
numeric contract (``NEG_INF = -1e30``, p kept in f32, ``acc / max(l,
1e-20)``). The reference takes ``q_block``/``kv_block`` for its TPU grid;
here the tiles are the kernel's (``KV_TILE``), which changes rounding
only. There is no backward: the reference gives ``flash_attention`` no VJP.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, check_operand, on_cpu, ref, \
    stream_handle

KV_TILE = 64                          # keys per tile (csrc kBK)
HEAD_DIMS = (16, 32, 64, 128, 160)    # head widths the kernel is built for
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _I,
             _P)
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, Tq, H, hd), k and v (B, Tk, KV, hd) with KV dividing H, all f32
    or all bf16 and contiguous → (B, Tq, H, hd) in q's type. Query head h
    reads KV head ``h // (H // KV)``; ``causal`` masks keys past the query's
    position, ``window`` > 0 keys at or before ``position - window``
    (positions count from 0 for q and k alike)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes 4-D q, k and v")
    if q.dtype not in _ENTRY:
        raise TypeError(f"q: dtype {q.dtype}, expected float32 or bfloat16")
    b, tq, h, hd = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    check_operand("q", q, (b, tq, h, hd), q.dtype)
    check_operand("k", k, (b, tk, kvh, hd), q.dtype)
    check_operand("v", v, (b, tk, kvh, hd), q.dtype)
    if kvh < 1 or h % kvh:
        raise ValueError(f"{kvh} KV heads do not divide {h} query heads")
    if window < 0:
        raise ValueError(f"window={window} < 0")
    if on_cpu(q, k, v):
        return ref.flash_attention_plain(q, k, v, causal=causal,
                                         window=window, kv_block=KV_TILE)
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd}: the kernel is built for "
                         f"{HEAD_DIMS}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _build.entry("flash_attention", _ENTRY[q.dtype], _ARGTYPES)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
              tq, tk, h, kvh, hd, hd ** -0.5, int(causal), int(window),
              stream_handle())
    _build.check("flash_attention", code)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
