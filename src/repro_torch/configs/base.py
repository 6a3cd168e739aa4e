"""Architecture & shape-cell config system of the LM zoo (the reference's
``configs/base.py``, data only, copied so that the port imports nothing of
the JAX package).

Every architecture is a ``ModelConfig`` in ``configs/<id>.py``;
``repro_torch.configs.get(arch_id)`` loads it, ``reduced()`` derives the
CPU smoke config of the same family. Shape cells (train_4k / prefill_32k /
decode_32k / long_500k) are ``ShapeCell`` entries.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 → d_model // n_heads
    # --- block pattern ------------------------------------------------
    # sequence of sublayer kinds scanned as one homogeneous block, e.g.
    # ("attn_dense",), ("attn_moe",), ("attn_dense","attn_moe"), ("mamba",)
    block_pattern: tuple[str, ...] = ("attn_dense",)
    # --- MoE ------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    shared_expert: bool = False     # llama4-style always-on expert
    # --- attention flavor ------------------------------------------------
    window: int = 0                 # sliding-window size; 0 = full attention
    qk_norm: bool = False
    rope_theta: float = 1e4
    # --- SSM / hybrid -----------------------------------------------------
    ssm_state: int = 0
    ssm_heads: int = 0
    attn_every: int = 0             # zamba2: shared attn block period
    # --- enc-dec / frontend ------------------------------------------------
    encoder_layers: int = 0         # whisper
    frontend: str = "none"          # none | audio_frames | vision_tiles
    frontend_len: int = 0           # positions carrying stub embeddings
    # --- numerics ---------------------------------------------------------
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    norm_eps: float = 1e-5

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if not (self.n_layers % len(self.block_pattern) == 0
                or self.attn_every):
            raise ValueError(f"{self.name}: n_layers={self.n_layers} is not "
                             f"a multiple of the block pattern "
                             f"{self.block_pattern}")

    @property
    def n_blocks(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context? (SSM state, hybrid, or
        sliding-window KV — see DESIGN.md §4.)"""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.window > 0

    def param_count(self) -> int:
        """Total parameters (used for MODEL_FLOPS = 6·N·D roofline term)."""
        d, v = self.d_model, self.vocab
        n = v * d  # embed
        if not self.tie_embeddings:
            n += v * d
        per_kind = {}
        hd = self.head_dim
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
            + self.n_heads * hd * d
        dense_ffn = 3 * d * self.d_ff
        moe_ffn = self.n_experts * 3 * d * self.d_ff + d * self.n_experts
        if self.shared_expert:
            moe_ffn += 3 * d * self.d_ff
        mamba = 6 * d * d + 4 * d * (self.ssm_state or 64)
        rwkv = 6 * d * d + 2 * d * self.d_ff
        per_kind["attn_dense"] = attn + dense_ffn
        per_kind["attn_moe"] = attn + moe_ffn
        per_kind["moe"] = moe_ffn
        per_kind["mamba"] = mamba
        per_kind["rwkv"] = rwkv
        if self.attn_every:  # zamba2: n_layers mamba + ONE shared attn block
            n += self.n_layers * mamba + (attn + dense_ffn)
        else:
            for i in range(self.n_layers):
                kind = self.block_pattern[i % len(self.block_pattern)]
                n += per_kind[kind]
        if self.encoder_layers:
            n += self.encoder_layers * (attn + dense_ffn) \
                + self.n_layers * (attn // 2)  # cross-attn
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k experts only)."""
        if self.n_experts == 0:
            return self.param_count()
        full_moe = self.n_experts * 3 * self.d_model * self.d_ff
        active_moe = (self.top_k + int(self.shared_expert)) \
            * 3 * self.d_model * self.d_ff
        n_moe_layers = sum(
            1 for i in range(self.n_layers)
            if self.block_pattern[i % len(self.block_pattern)] == "attn_moe")
        return self.param_count() - n_moe_layers * (full_moe - active_moe)

    def reduced(self) -> "ModelConfig":
        """Same-family smoke config: tiny widths, few layers/experts."""
        return dataclasses.replace(
            self,
            n_layers=max(len(self.block_pattern),
                         2 * len(self.block_pattern)) if not self.attn_every
                     else 4,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads
                       else 4,
            d_ff=128,
            vocab=256,
            head_dim=16,
            n_experts=min(self.n_experts, 4),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_heads=min(self.ssm_heads, 2) if self.ssm_heads else 0,
            attn_every=2 if self.attn_every else 0,
            window=min(self.window, 16) if self.window else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            frontend_len=min(self.frontend_len, 8) if self.frontend_len else 0,
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode
    microbatches: int = 1           # train: gradient-accumulation steps


SHAPE_CELLS = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train", microbatches=16),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}
