"""Input construction for every (architecture × shape cell), the
reference's ``launch/specs.py``.

``make_inputs(cfg, cell, concrete=False)`` returns the inputs the train,
prefill or decode step consumes: zero tensors on a device when
``concrete`` (the current CUDA device unless ``device=`` names another),
else tensors on the ``meta`` device, which carry shape and dtype and
allocate nothing (the reference's ``jax.ShapeDtypeStruct``).
``cell_supported`` says which cells apply to a config.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.models import lm

WHISPER_DEC_RATIO = 8        # decoder tokens per encoder frame (train cells)
WHISPER_DEC_ENC_LEN = 4096   # encoder context used by decode cells


def cell_supported(cfg: ModelConfig, cell: ShapeCell) -> tuple[bool, str]:
    """Applicability per DESIGN.md §4."""
    if cell.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full quadratic attention: 512k dense-KV decode is "
                       "out of scope for this config (no sub-quadratic "
                       "mechanism) — see DESIGN.md §4")
    if cell.name == "long_500k" and cfg.is_encoder_decoder:
        return False, "enc-dec audio model: 500k-token decode is meaningless"
    return True, ""


def _device(concrete: bool, device) -> torch.device:
    return resolve_device(device) if concrete else torch.device("meta")


def make_train_batch(cfg: ModelConfig, batch: int, seq: int, concrete=False,
                     *, device=None) -> dict:
    """``{"tokens": (batch, seq) int32}``; LLaVA adds ``patch_embeds``
    (batch, min(frontend_len, max(seq // 4, 8)), VISION_DIM) f32; Whisper
    takes ``frames`` (batch, seq, AUDIO_DIM) f32 and ``max(seq //
    WHISPER_DEC_RATIO, 8)`` decoder tokens."""
    dev = _device(concrete, device)
    out = {"tokens": torch.zeros((batch, seq), dtype=torch.int32,
                                 device=dev)}
    if cfg.frontend == "vision_tiles":
        n_tiles = min(cfg.frontend_len, max(seq // 4, 8))
        out["patch_embeds"] = torch.zeros((batch, n_tiles, lm.VISION_DIM),
                                          dtype=torch.float32, device=dev)
    if cfg.is_encoder_decoder:
        out["frames"] = torch.zeros((batch, seq, lm.AUDIO_DIM),
                                    dtype=torch.float32, device=dev)
        out["tokens"] = torch.zeros(
            (batch, max(seq // WHISPER_DEC_RATIO, 8)), dtype=torch.int32,
            device=dev)
    return out


def make_decode_inputs(cfg: ModelConfig, batch: int, cache_len: int,
                       concrete=False, *, device=None):
    """(tokens, caches, pos) for one decode step; Whisper's cross-attention
    cache holds WHISPER_DEC_ENC_LEN encoder positions."""
    dev = _device(concrete, device)
    tokens = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
    enc_len = WHISPER_DEC_ENC_LEN if cfg.is_encoder_decoder else 0
    caches = lm.init_decode_state(cfg, batch, cache_len, enc_len,
                                  device=dev)
    pos = torch.tensor(cache_len, dtype=torch.int32, device=dev)
    return tokens, caches, pos


def make_inputs(cfg: ModelConfig, cell: ShapeCell, concrete=False,
                dp_size: int = 1, *, device=None):
    """Returns (kind, inputs) for the cell. ``dp_size`` caps the
    gradient-accumulation depth so each microbatch still spans every
    data-parallel shard (per-microbatch batch ≥ dp_size)."""
    ok, why = cell_supported(cfg, cell)
    if not ok:
        raise ValueError(f"{cfg.name} × {cell.name}: {why}")
    if cell.kind == "train":
        microbatches = min(cell.microbatches,
                           max(1, cell.global_batch // max(dp_size, 1)))
        return "train", {
            "microbatches": microbatches,
            "batch": make_train_batch(cfg, cell.global_batch, cell.seq_len,
                                      concrete, device=device),
        }
    if cell.kind == "prefill":
        return "prefill", make_train_batch(cfg, cell.global_batch,
                                           cell.seq_len, concrete,
                                           device=device)
    tokens, caches, pos = make_decode_inputs(
        cfg, cell.global_batch, cell.seq_len, concrete, device=device)
    return "decode", {"tokens": tokens, "caches": caches, "pos": pos}
