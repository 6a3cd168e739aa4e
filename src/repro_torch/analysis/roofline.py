"""Roofline constants of the card the port runs on: the reference's ``HW``
record with NVIDIA H100 numbers in place of its TPU v5e-class ones.

The card is an NVIDIA H100 80GB HBM3 (SXM, 132 SMs) at a power limit of
700.00 W, as ``nvidia-smi --query-gpu=name,power.limit --format=csv,
noheader`` prints it: HBM3 at 3.35 TB/s, 67 TFLOP/s of f32 FMA on the CUDA
cores and 989 TFLOP/s of dense bf16 on the tensor cores (the data-sheet
peaks that PERF.md's bounds are computed from). ``ici_bw`` keeps the
reference's field for the NVLink links of a four-card host (450 GB/s a
direction per card, NVLink 4); nothing on one card reads it.

The reference's other half, the HLO-text parser behind its three-term
roofline of a compiled program, has no counterpart yet (``ROADMAP.md``).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HW:
    peak_flops: float = 989e12     # dense bf16 on the tensor cores
    hbm_bw: float = 3.35e12        # B/s
    ici_bw: float = 450e9          # B/s per card and direction (NVLink 4)
    fma_flops: float = 67e12       # f32 on the CUDA cores (FFMA)
