"""Llama-4 Maverick 400B-A17B [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
128-expert top-1 MoE interleaved with dense layers (every other layer MoE),
GQA kv=8, 202k vocab. Early-fusion multimodality is out of scope for the LM
backbone cells (text path only)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    head_dim=128,
    block_pattern=("attn_dense", "attn_moe"),   # interleaved MoE
    n_experts=128,
    top_k=1,
    shared_expert=True,
    rope_theta=5e5,
)
