"""Training launcher (the reference's ``launch/train.py``, on one device).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
        --reduced --steps 200 --batch 8 --seq 128 --checkpoint-dir ck \
        --device cpu

``--reduced`` trains the same-family small config; without it the full
config trains, at full width, on one GPU (it must fit there). The
reference's ``--mesh`` takes only ``1x1`` here: the production mesh waits
for ROADMAP.md queue 1: sharding and the distributed stack.
"""
from __future__ import annotations

import argparse

from repro_torch import configs
from repro_torch.data.tokens import TokenStreamSpec, token_stream
from repro_torch.launch import specs
from repro_torch.optim.adam import AdamConfig
from repro_torch.training.trainer import Trainer, TrainerConfig


def synthetic_data(cfg, batch, seq, seed=0, start_step=0, *, device=None):
    """Resumable synthetic next-token stream (``data.tokens``) on
    ``device``: batch ``i`` is a pure function of (seed, i), so a restart
    at ``start_step`` is an exact resume. Each batch carries the family's
    other inputs of ``specs.make_train_batch`` (zeros: LLaVA's
    ``patch_embeds``, Whisper's ``frames``) beside the stream's tokens, as
    the reference's does."""
    spec = TokenStreamSpec(vocab=cfg.vocab, batch=batch, seq_len=seq,
                           seed=seed)
    extras = {k: v for k, v in specs.make_train_batch(
        cfg, batch, seq, concrete=True, device=device).items()
        if k != "tokens"}
    stream = token_stream(spec, start_step=start_step, device=device)
    try:
        for b in stream:
            yield {**extras, **b}
    finally:
        stream.close()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCHS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--checkpoint-dir", required=True)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--mesh", default="1x1",
                    help='"1x1" only: one device')
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    if args.mesh != "1x1":
        raise NotImplementedError(
            f"--mesh {args.mesh}: the port trains on one device; meshes "
            "are not ported yet (ROADMAP.md queue 1: sharding and the "
            "distributed stack)")
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tcfg = TrainerConfig(
        total_steps=args.steps, checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir,
        microbatches=args.microbatches, remat=args.remat,
        compress_grads=args.compress_grads)
    trainer = Trainer(cfg, AdamConfig(lr=args.lr, grad_clip=1.0), tcfg,
                      device=args.device)
    data = synthetic_data(cfg, args.batch, args.seq, device=trainer.device)
    trainer.fit(data, on_metrics=lambda s, rec: print(
        f"step {s}: loss {rec['loss']:.4f}", flush=True))


if __name__ == "__main__":
    main()
