"""LLaVA-NeXT 34B [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified] —
Yi-34B backbone + anyres vision tiling. The vision tower is a STUB: the input
pipeline provides precomputed per-tile patch embeddings which are scattered
into the prompt prefix (frontend_len positions); the ragged tile batch routes
through the paper's batching planner (DESIGN.md §4)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    head_dim=128,
    rope_theta=5e6,
    frontend="vision_tiles",
    frontend_len=576,     # one 24x24 tile of patch embeddings in the prefix
)
