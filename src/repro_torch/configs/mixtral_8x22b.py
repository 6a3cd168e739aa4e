"""Mixtral 8x22B [arXiv:2401.04088; hf] — 8-expert top-2 MoE, GQA,
sliding-window attention (window-bounded KV => long_500k runnable)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=32768,
    head_dim=128,
    block_pattern=("attn_moe",),
    n_experts=8,
    top_k=2,
    window=4096,
    rope_theta=1e6,
)
