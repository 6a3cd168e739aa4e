"""Zamba2-7B [arXiv:2411.15242; unverified] — Mamba2 backbone with ONE shared
attention block applied every `attn_every` layers (weight-shared). SSM state
=> long_500k runs."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    head_dim=112,
    block_pattern=("mamba",),
    ssm_state=64,
    ssm_heads=56,         # mamba2 heads: 2*d_model / head_dim(128)
    attn_every=6,
)
