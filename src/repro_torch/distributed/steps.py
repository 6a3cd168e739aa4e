"""The LM train step on one device (the reference's
``distributed/steps.build_train_step`` without its mesh).

A step is the reference's: value and grad of :func:`repro_torch.models.lm.
loss_fn`, over ``microbatches`` contiguous slices of the batch
(``x.reshape(m, B / m, ...)``) when there are more than one, their
gradients accumulated in f32 and divided by ``m`` and the loss the mean of
theirs; with one microbatch the gradients keep the parameters' dtype, as
``jax.value_and_grad`` gives them. Then the optional int8 error-feedback
compression, then :func:`repro_torch.optim.adam.adam_update` (which clips
by the global norm), in place. ``device=`` takes the place of the
reference's ``mesh``: the batch is moved there, and the reference's
``zero1`` (shard the Adam moments over the data axis) has nothing to shard.
The prefill and decode step builders and the shardings are not ported yet
(ROADMAP.md queue 1: sharding and the distributed stack).
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device, tree
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.compression import ef_int8_compress_decompress
from repro_torch.models import lm
from repro_torch.optim.adam import AdamConfig, adam_update


def loss_and_grads(cfg: ModelConfig, params, batch: dict, *,
                   microbatches: int = 1, remat: bool = True):
    """(loss, grads) of ``lm.loss_fn`` over ``batch``, as one step takes
    them: the mean over ``microbatches`` contiguous slices, f32 grads when
    there is more than one slice, else grads in the parameters' dtype."""
    leaves = tree.leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]
    live_params = tree.unflatten(params, live)

    def value_and_grad(mb):
        loss, _ = lm.loss_fn(live_params, cfg, mb, remat=remat)
        return loss.detach(), torch.autograd.grad(loss, live)

    if microbatches == 1:
        loss, grads = value_and_grad(batch)
        return loss, tree.unflatten(params, list(grads))
    rows = tree.leaves(batch)[0].shape[0]
    if rows % microbatches:
        raise ValueError(f"a batch of {rows} does not split into "
                         f"{microbatches} microbatches")
    mbs = tree.tree_map(lambda x: x.reshape(
        (microbatches, rows // microbatches) + tuple(x.shape[1:])), batch)
    acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
    loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for i in range(microbatches):
        loss, grads = value_and_grad(tree.tree_map(lambda x: x[i], mbs))
        for a, g in zip(acc, grads):
            a.add_(g)
        del grads
        loss_sum = loss_sum + loss
    return loss_sum / microbatches, tree.unflatten(
        params, [a.div_(microbatches) for a in acc])


def build_train_step(cfg: ModelConfig, opt: AdamConfig, *,
                     microbatches: int = 1, remat: bool = True,
                     compress_grads: bool = False, device=None):
    """The full optimizer step ``step(params, opt_state, batch) → (params,
    opt_state, {"loss"})`` on ``device`` (the current CUDA device unless
    asked for another). ``params`` and ``opt_state`` are updated in place;
    with ``compress_grads`` the state holds ``ef_err``
    (:func:`~repro_torch.distributed.compression.ef_init`). The loss stays
    a 0-d tensor on the device."""
    if microbatches < 1:
        raise ValueError(f"microbatches={microbatches} < 1")
    device = resolve_device(device)

    def train_step(params, opt_state, batch):
        batch = tree.tree_map(lambda x: x.to(device), batch)
        loss, grads = loss_and_grads(cfg, params, batch,
                                     microbatches=microbatches, remat=remat)
        if compress_grads:
            grads, new_err = ef_int8_compress_decompress(
                grads, opt_state["ef_err"])
            opt_state = {**opt_state, "ef_err": new_err}
        params, opt_state = adam_update(opt, params, grads, opt_state)
        return params, opt_state, {"loss": loss}

    return train_step
