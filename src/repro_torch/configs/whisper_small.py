"""Whisper small [arXiv:2212.04356; unverified] — encoder-decoder; the conv
audio frontend is a STUB (input pipeline provides precomputed frame
embeddings). Decoder cells (decode_32k) run; long_500k skipped (full attn)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,           # decoder layers
    encoder_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    head_dim=64,
    frontend="audio_frames",
    tie_embeddings=True,
)
