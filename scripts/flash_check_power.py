#!/usr/bin/env python3
"""How far a flash-attention kernel that drops one 64-key tile for the late
rows moves its output at the Llama-3-8B prefill length (T 4096, hd 128,
causal, randn inputs), and how many output elements each of
``chip_smoke.py``'s flash tolerances would flag.

    python3 scripts/flash_check_power.py [--heads N] [--seed S]

It runs on the CPU in f32 by a dense softmax (no kernel, no card): the
correct output against the same attention with keys of one tile masked out
for rows 2048 and later. A tolerance that flags 0 elements cannot catch
such a kernel.
"""
import argparse

import torch

TOLS = {"f32, main and corners (2e-5, 2e-5)": (2e-5, 2e-5),
        "bf16, main shape (1e-4, 8e-3)": (1e-4, 8e-3),
        "bf16, corners (3e-2, 3e-2)": (3e-2, 3e-2)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--heads", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t, hd, tile = 4096, 128, 64
    gen = torch.Generator().manual_seed(args.seed)
    q, k, v = (torch.randn((args.heads, t, hd), generator=gen)
               for _ in range(3))
    s = q @ k.transpose(-1, -2) * hd ** -0.5
    pos = torch.arange(t)
    causal = pos[None, :] <= pos[:, None]

    def attention(mask):
        return torch.softmax(s.masked_fill(~mask, float("-inf")), -1) @ v

    good = attention(causal)
    print(f"output |x|: mean {good.abs().mean():.4f}, max "
          f"{good.abs().max():.4f}")
    for j in (0, t // tile // 2 - 1, t // tile - 2):
        mask = causal.clone()
        mask[t // 2:, j * tile:(j + 1) * tile] = False
        err = (attention(mask) - good).abs()
        flagged = ", ".join(
            f"{name}: {int((err > atol + rtol * good.abs()).sum())}"
            for name, (atol, rtol) in TOLS.items())
        print(f"key tile {j} dropped for rows >= {t // 2}: max abs err "
              f"{err.max():.3e}; elements flagged by {flagged}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
