#!/usr/bin/env python3
"""Host time of one small dense LM training step on the CPU, to compare
the Python overhead of two checkouts' ``build_train_step``.

    python3 scripts/lm_step_host.py [--root CHECKOUT] [--rounds N]

``--root`` is the checkout whose ``src/`` is imported (this one by
default). The model is ``llama3-8b`` cut to 12 layers of width 64 (f32,
vocab 256) on a 2 x 8 batch, so the step's time is nearly all host: the
per-op Python and dispatch that a step on the card also pays. One torch
thread. Prints the best and every round's mean ms a step (20 steps a
round, after 3 untimed).
"""
import argparse
import dataclasses
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parent.parent)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, str(args.root.resolve() / "src"))
    import torch

    from repro_torch import configs
    from repro_torch.data.tokens import TokenStreamSpec, make_batch
    from repro_torch.distributed.steps import build_train_step
    from repro_torch.models import lm
    from repro_torch.optim.adam import AdamConfig, adam_init

    torch.set_num_threads(1)
    cfg = dataclasses.replace(
        configs.get("llama3-8b"), n_layers=12, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab=256, dtype="float32")
    params = lm.init_params(cfg, device="cpu")
    state = adam_init(params)
    step = build_train_step(cfg, AdamConfig(lr=1e-3), remat=False,
                            device="cpu")
    batch = {"tokens": torch.from_numpy(make_batch(
        TokenStreamSpec(vocab=cfg.vocab, batch=2, seq_len=8), 0))}
    for _ in range(3):
        params, state, _ = step(params, state, batch)
    rounds = []
    for _ in range(args.rounds):
        t0 = time.perf_counter()
        for _ in range(20):
            params, state, _ = step(params, state, batch)
        rounds.append((time.perf_counter() - t0) / 20 * 1e3)
    print(f"{args.root}: ms a step, best {min(rounds):.2f}; rounds "
          + ", ".join(f"{r:.2f}" for r in rounds))
    return 0


if __name__ == "__main__":
    sys.exit(main())
