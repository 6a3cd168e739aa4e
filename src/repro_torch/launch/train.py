"""Training launcher (the reference's ``launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
        --reduced --steps 200 --batch 8 --seq 128 --checkpoint-dir ck \
        --device cpu [--mesh 1x2]

``--reduced`` trains the same-family small config; without it the full
config trains, at full width (it must fit). ``--mesh DxM`` trains on a
("data", "model") mesh of D·M ranks: the launcher spawns one process a
rank, joined through a ``FileStore`` under the checkpoint directory with
``launch.mesh.pick_backend``'s backend (gloo when ranks share a card or run
on the CPU, NCCL when each has a card); under ``torchrun`` (``RANK`` and
``WORLD_SIZE`` set) each process joins as its rank instead. Rank 0 prints
the losses and writes the checkpoints. ``production`` / ``multipod`` ask
for the reference's 16×16 / 2×16×16 meshes, which raise below their 256 /
512 ranks, as ``make_production_mesh`` does.
"""
from __future__ import annotations

import argparse

import os

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


def _mesh_shape(text: str) -> tuple[int, int]:
    try:
        d, m = (int(x) for x in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh {text!r}: expected DxM (e.g. 1x2), "
                         "production or multipod") from None
    if d < 1 or m < 1:
        raise ValueError(f"--mesh {text!r}: axes of at least one rank")
    return d, m


def _train(args, mesh=None) -> None:
    """The training run of one process (a rank of ``mesh``, or alone)."""
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tcfg = TrainerConfig(
        total_steps=args.steps, checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir,
        microbatches=args.microbatches, remat=args.remat,
        compress_grads=args.compress_grads)
    trainer = Trainer(cfg, AdamConfig(lr=args.lr, grad_clip=1.0), tcfg,
                      mesh=mesh,
                      device=None if mesh is not None else args.device)
    data = synthetic_data(cfg, args.batch, args.seq, device=trainer.device)
    trainer.fit(data, on_metrics=lambda s, rec: print(
        f"step {s}: loss {rec['loss']:.4f}", flush=True))


def _rank(rank: int, world: int, shape, store: str, args) -> None:
    """One spawned rank: join the group, build the mesh, train."""
    from repro_torch.launch.mesh import close_ranks, init_ranks

    init_ranks(rank, world, store, device_type=args.device)
    try:
        _train(args, _make_mesh(args, shape))
    finally:
        close_ranks()


def _make_mesh(args, shape):
    from repro_torch.launch.mesh import make_mesh, make_production_mesh

    if shape in ("production", "multipod"):
        return make_production_mesh(multi_pod=shape == "multipod",
                                    device_type=args.device)
    return make_mesh(shape, ("data", "model"), device_type=args.device)


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
                    help='"DxM" ("data" x "model" ranks), "production" '
                         '(16x16) or "multipod" (2x16x16)')
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        # under torchrun: this process is one rank of the launcher's world
        from repro_torch.launch.mesh import close_ranks, init_ranks

        shape = (args.mesh if args.mesh in ("production", "multipod")
                 else _mesh_shape(args.mesh))
        init_ranks(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                   "env://", device_type=args.device)
        try:
            _train(args, _make_mesh(args, shape))
        finally:
            close_ranks()
        return
    if args.mesh in ("production", "multipod"):
        _make_mesh(args, args.mesh)          # raises below 256 / 512 ranks
    shape = _mesh_shape(args.mesh)
    if shape == (1, 1):
        _train(args)
        return
    import torch.multiprocessing as mp

    world = shape[0] * shape[1]
    os.makedirs(args.checkpoint_dir, exist_ok=True)
    store = os.path.join(os.path.abspath(args.checkpoint_dir),
                         f".store-{os.getpid()}")
    try:
        mp.start_processes(_rank, args=(world, shape, f"file://{store}",
                                        args), nprocs=world, join=True,
                           start_method="spawn")
    finally:
        if os.path.exists(store):
            os.remove(store)


if __name__ == "__main__":
    main()
