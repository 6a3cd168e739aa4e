"""Flash attention — causal, sliding-window and GQA online-softmax
attention, the ``attention_impl="pallas"`` branch of
``models/layers.attention_apply`` — as a hand-written kernel.

The kernel is ``csrc/flash_attention.cu``. Its bf16 entry is built for
Hopper: one block per (128-row q tile, head, batch), TMA loads of 64-key
K/V tiles into a two-stage ring, ``wgmma`` for Q·Kᵀ and P·V with the online
softmax on the accumulator fragment, P split into two bf16 halves so that
it keeps ~16 bits. Its f32 entry runs f32 FMAs (tensor cores would take f32
as tf32). The plain version is
:func:`repro_torch.kernels.ref.flash_attention_plain`, the same blocked
recurrence over the same 64-key tiles. Both keep the reference kernel's
numeric contract (``NEG_INF = -1e30``, p in f32, ``acc / max(l, 1e-20)``).
The reference takes ``q_block``/``kv_block`` for its TPU grid; here the
tiles are the kernel's (``KV_TILE``), which changes rounding only. There is
no backward: the reference gives ``flash_attention`` no VJP, so a call with
grad mode on and a q, k or v that requires grad raises on either device
(the kernel's output would carry no autograd history, and the plain
version's gradient would exist only on the CPU).

Head widths: the bf16 entry takes every multiple of 16 up to
``MAX_HEAD_DIM``, the f32 entry the widths of ``F32_WIDTHS``. Any other
width up to ``MAX_HEAD_DIM`` runs at :func:`kernel_width`: the wrapper
copies q, k and v with zero columns appended (zero columns change neither
q·kᵀ nor p·v; the scale stays ``hd ** -0.5``) and slices the output back,
at the cost of one extra read and write of q, k, v and the output.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, check_operand, on_cpu, ref, \
    stream_handle

KV_TILE = 64                          # keys per tile (csrc kBK)
MAX_HEAD_DIM = 256                    # widest head either entry is built for
F32_WIDTHS = (16, 32, 64, 96, 128, 160, 192, 256)   # the f32 entry's widths
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _I,
             _P)
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}


def kernel_width(hd: int, dtype: torch.dtype) -> int:
    """The head width the kernel runs ``hd`` at: the next multiple of 16
    for bf16, the next of :data:`F32_WIDTHS` for f32."""
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd}: the kernel is built for widths up "
                         f"to {MAX_HEAD_DIM}")
    if dtype == torch.bfloat16:
        return -(-hd // 16) * 16
    return min(w for w in F32_WIDTHS if w >= hd)


def pad_head_dim(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` (..., hd) with zero columns appended up to ``width``."""
    return F.pad(t, (0, width - t.shape[-1])).contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, Tq, H, hd), k and v (B, Tk, KV, hd) with KV dividing H, all f32
    or all bf16 and contiguous → (B, Tq, H, hd) in q's type. Query head h
    reads KV head ``h // (H // KV)``; ``causal`` masks keys past the query's
    position, ``window`` > 0 keys at or before ``position - window``
    (positions count from 0 for q and k alike). Raises ``RuntimeError``
    under grad mode when q, k or v requires grad: there is no backward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention has no gradient: the reference kernel defines "
            "no VJP, so nothing trains through it; train with "
            "attention_impl='xla_packed' or 'xla_chunked', or call it under "
            "torch.no_grad() or torch.inference_mode()")
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
    width = kernel_width(hd, q.dtype)
    if q.numel() == 0:
        return torch.empty_like(q)
    if tk == 0:
        return torch.zeros_like(q)     # no key: acc 0 / max(l, 1e-20)
    if width != hd:
        q, k, v = (pad_head_dim(t, width) for t in (q, k, v))
    # TMA reads from 16-byte aligned addresses
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    out = torch.empty_like(q)
    fn = _build.entry("flash_attention", _ENTRY[q.dtype], _ARGTYPES)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
              tq, tk, h, kvh, width, hd ** -0.5, int(causal), int(window),
              stream_handle())
    _build.check("flash_attention", code)
    flash_attention.launches += 1
    return out if width == hd else out[..., :hd].contiguous()


flash_attention.launches = 0
