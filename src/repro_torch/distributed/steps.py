"""The LM's step builders (the reference's ``distributed/steps.py``): the
train step, prefill and one decode step, on one device or a
(data × model) ``DeviceMesh``.

A train step is the reference's: value and grad of
:func:`repro_torch.models.lm.loss_fn`, over ``microbatches`` contiguous
slices of the batch (``x.reshape(m, B / m, ...)``) when there are more
than one, their gradients accumulated in f32 and divided by ``m`` and the
loss the mean of theirs; with one microbatch the gradients keep the
parameters' dtype, as ``jax.value_and_grad`` gives them. Then the optional
int8 error-feedback compression, then
:func:`repro_torch.optim.adam.adam_update` (which clips by the global
norm), in place.

On a mesh (multi-controller: every rank runs the same step on the same
global inputs and holds only its shards of the parameters, Adam moments,
error-feedback residuals and decode caches, as ``sharding``'s rules place
them; ``lm_mesh`` does the work GSPMD does for the reference):

- **"data" (and "pod") split the rows.** Each rank computes on its slice
  of the global batch by ``batch_specs``' rule; microbatch *i* is the
  *i*-th contiguous slice of the GLOBAL batch, then split (the reference's
  ``constrain(mb)``), so each microbatch's token count and MoE dispatch are
  the single-device ones. The loss is the global masked sum over the
  global token count. Gradients of leaves replicated over "data" are
  all-reduced over "data" (bucketed).
- **"model" splits compute only where a shard holds whole units.** Tensor
  parallelism in the Megatron pair: attention when ``n_heads`` and
  ``n_kv_heads`` divide the axis (``wq``/``wk``/``wv`` column shards,
  ``wo`` row shard), and the dense SwiGLU (``w_gate``/``w_up`` column,
  ``w_down`` row). The pair: identity forward and all-reduce backward at
  the block input; all-reduce forward (in f32) and identity backward after
  the row product.
- **Every other split leaf is gathered at use** (``embed``, ``lm_head``,
  the router, the MoE banks, the SSM projections, heads that do not
  divide, FSDP's data shards): an all-gather forward; backward, over an
  axis whose ranks computed on the same rows ("model") the rank takes its
  slice of the gradient, over one whose ranks computed on different rows
  ("data", FSDP) the gradient is summed, then sliced.

``zero1`` splits the moments over "data" too (each data rank updates its
slice, then the parameters are all-gathered); ``tuning.flags().fsdp``
splits the parameters over "data" as well (they stay so). Prefill and
decode return the global logits on every rank; the caches stay this
rank's shards. Without a mesh, ``device=`` says where the step runs (the
current CUDA device unless asked for another); with one, the mesh's.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device, tree, tuning
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import lm_mesh, sharding
from repro_torch.distributed.compression import ef_int8_compress_decompress
from repro_torch.launch.mesh import all_reduce_sum
from repro_torch.models import lm
from repro_torch.optim.adam import AdamConfig, adam_update


def shaped_params(cfg: ModelConfig) -> dict:
    """The parameter tree of ``cfg`` as meta tensors (shapes and dtypes,
    no storage)."""
    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        return torch.empty(node[0], dtype=node[1], device="meta")

    return build(lm.param_shapes(cfg))


def param_placements(cfg: ModelConfig, mesh, *, fsdp: bool = False):
    """The parameters' placements on ``mesh``: ``param_specs``, and with
    ``fsdp`` ``zero1_specs`` over them (parameters split over "data")."""
    shapes = shaped_params(cfg)
    specs = sharding.param_specs(shapes, mesh)
    return sharding.zero1_specs(specs, shapes, mesh) if fsdp else specs


def train_shards(cfg: ModelConfig, mesh, *, zero1: bool = True
                 ) -> lm_mesh.Shards:
    """How the train step splits its state on ``mesh`` (the parameters
    with FSDP when ``tuning.flags().fsdp``; the moments over "data" too
    with ``zero1``)."""
    shapes = shaped_params(cfg)
    p_specs = param_placements(cfg, mesh, fsdp=tuning.flags().fsdp)
    m_specs = (sharding.zero1_specs(p_specs, shapes, mesh) if zero1
               else p_specs)
    return lm_mesh.Shards(mesh, p_specs, m_specs)


def loss_and_grads(cfg: ModelConfig, params, batch: dict, *,
                   microbatches: int = 1, remat: bool = True,
                   shards: lm_mesh.Shards | None = None):
    """(loss, grads) of ``lm.loss_fn`` over ``batch``, as one step takes
    them: the mean over ``microbatches`` contiguous slices, f32 grads when
    there is more than one slice, else grads in the parameters' dtype.
    Under ``shards`` ``params`` are this rank's shards and ``batch`` the
    global batch: the loss is the global one and the grads are this
    rank's moment shards, summed over the ranks that split the rows."""
    leaves = tree.leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]
    live_params = tree.unflatten(params, live)
    rows = tree.leaves(batch)[0].shape[0]
    if rows % microbatches:
        raise ValueError(f"a batch of {rows} does not split into "
                         f"{microbatches} microbatches")
    mesh = None if shards is None else shards.mesh
    axes = () if mesh is None else lm_mesh.rows_axes(rows // microbatches,
                                                     mesh)
    lay = None if mesh is None else lm_mesh.Layout(mesh, rows=axes)

    def value_and_grad(mb):
        with lm_mesh.use_layout(lay):
            use = live_params
            if mesh is not None:
                mb = tree.tree_map(
                    lambda x: lm_mesh.local_rows(x, axes, mesh), mb)
                use = lm_mesh.use_tree(live_params, shards.params, cfg, mesh)
            loss, _ = lm.loss_fn(use, cfg, mb, remat=remat)
            return loss.detach(), torch.autograd.grad(loss, live)

    if microbatches == 1:
        loss, grads = value_and_grad(batch)
        grads = list(grads)
    else:
        mbs = tree.tree_map(lambda x: x.reshape(
            (microbatches, rows // microbatches) + tuple(x.shape[1:])),
            batch)
        grads = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for i in range(microbatches):
            mb_loss, mb_grads = value_and_grad(
                tree.tree_map(lambda x: x[i], mbs))
            for a, g in zip(grads, mb_grads):
                a.add_(g)
            del mb_grads
            loss = loss + mb_loss
        loss = loss / microbatches
        grads = [a.div_(microbatches) for a in grads]
    if mesh is not None:
        for a in axes:                # the shares of every row's rank
            loss = all_reduce_sum(loss, mesh, a)
        grads = lm_mesh.sync_grads(grads, lm_mesh.spec_leaves(shards.params),
                                   mesh, axes)
        grads = [lm_mesh.narrow(g, lm_mesh.extra_axes(*pair, mesh), mesh)
                 for g, pair in zip(grads, shards.pairs(), strict=True)]
    return loss, tree.unflatten(params, grads)


def build_train_step(cfg: ModelConfig, opt: AdamConfig, *, mesh=None,
                     microbatches: int = 1, remat: bool = True,
                     compress_grads: bool = False, zero1: bool = True,
                     device=None):
    """The full optimizer step ``step(params, opt_state, batch) → (params,
    opt_state, {"loss"})``; ``params`` and ``opt_state`` are updated in
    place, the loss stays a 0-d tensor on the device. With
    ``compress_grads`` the state holds ``ef_err``
    (:func:`~repro_torch.distributed.compression.ef_init`). On ``mesh``
    the state is this rank's shards by ``step.shards``
    (:func:`train_shards`: build them with ``lm_mesh.shard_tree(params,
    step.shards.params, mesh)`` and ``adam_init(params, step.shards)``)
    and ``batch`` is the global batch,
    the same on every rank; ``zero1`` is read only there."""
    if microbatches < 1:
        raise ValueError(f"microbatches={microbatches} < 1")
    device = resolve_device(device, mesh)
    shards = None if mesh is None else train_shards(cfg, mesh, zero1=zero1)

    def train_step(params, opt_state, batch):
        batch = tree.tree_map(lambda x: x.to(device), batch)
        loss, grads = loss_and_grads(cfg, params, batch,
                                     microbatches=microbatches, remat=remat,
                                     shards=shards)
        if compress_grads:
            grads, new_err = ef_int8_compress_decompress(
                grads, opt_state["ef_err"], shards)
            opt_state = {**opt_state, "ef_err": new_err}
        params, opt_state = adam_update(opt, params, grads, opt_state,
                                        shards=shards)
        return params, opt_state, {"loss": loss}

    train_step.shards = shards
    return train_step


def _use(cfg: ModelConfig, mesh, specs, params):
    """The tree the model computes with under the current layout: each
    leaf gathered but the Megatron shards (no autograd). Gathered anew
    each call, so a rank holds the full leaves only while a call runs."""
    return tree.unflatten(params, [
        lm_mesh.gather(t, p, mesh, ("model",) if lm_mesh.tp_local(path, cfg)
                       else ())
        for (path, t), p in zip(lm_mesh.leaves_with_paths(params),
                                lm_mesh.spec_leaves(specs), strict=True)])


def build_prefill(cfg: ModelConfig, mesh=None, *, device=None):
    """``prefill(params, batch) → last logits (B, 1, vocab)`` (no
    gradient). On ``mesh`` ``params`` are this rank's shards by
    :func:`param_placements` (no FSDP) and ``batch`` the global batch;
    every rank returns the global logits."""
    device = resolve_device(device, mesh)
    if mesh is not None:
        specs = param_placements(cfg, mesh)

    @torch.no_grad()
    def prefill(params, batch):
        batch = tree.tree_map(lambda x: x.to(device), batch)
        if mesh is None:
            return lm.prefill(params, cfg, batch)[0]
        axes = lm_mesh.rows_axes(batch["tokens"].shape[0], mesh)
        local = tree.tree_map(lambda x: lm_mesh.local_rows(x, axes, mesh),
                              batch)
        with lm_mesh.use_layout(lm_mesh.Layout(mesh, rows=axes)):
            logits, _ = lm.prefill(_use(cfg, mesh, specs, params), cfg,
                                   local)
            return lm_mesh.gather_rows(logits)

    return prefill


def build_decode_step(cfg: ModelConfig, mesh=None, *, batch: int | None = None,
                      cache_len: int | None = None, enc_len: int = 0,
                      device=None):
    """``decode(params, tokens, caches, pos) → (logits (B, 1, vocab),
    caches)``, one step, the caches written in place (no gradient). On
    ``mesh`` ``params`` are this rank's shards by :func:`param_placements`
    (no FSDP), ``tokens`` the global (B, 1) tokens and ``caches`` this
    rank's shards (``lm.init_decode_state(cfg, batch, cache_len, enc_len,
    mesh=mesh)``: the builder takes the same global geometry); every rank
    returns the global logits. The KV caches are read where they lie
    (sequence-parallel over "model" under ``constrain_decode``); the
    recurrent states and the cross-attention cache are gathered at use
    (the rules may split a state on any axis) and cut to this rank's
    rows, and the states' new rows re-split into the rank's shards."""
    device = resolve_device(device, mesh)
    if mesh is None:
        @torch.no_grad()
        def decode(params, tokens, caches, pos):
            return lm.decode_step(params, cfg, tokens.to(device), caches, pos)

        return decode
    if batch is None or cache_len is None:
        raise ValueError("build_decode_step on a mesh takes the caches' "
                         "global batch= and cache_len=")
    specs = param_placements(cfg, mesh)
    full, wider = (lm_mesh.leaves_with_paths(lm.init_decode_state(
        cfg, b, cache_len, enc_len, device="meta")) for b in (batch,
                                                              batch + 1))
    c_specs = lm_mesh.spec_leaves(sharding.cache_specs(
        lm.init_decode_state(cfg, batch, cache_len, enc_len, device="meta"),
        mesh))
    # each leaf's batch axis (where the caches of batch + 1 differ)
    b_dims = [next(d for d, (m, n) in enumerate(zip(t.shape, u.shape))
                   if m != n) for (_, t), (_, u) in zip(full, wider)]
    kv = [p.endswith(("/k", "/v")) and not p.startswith("cross_kv")
          for p, _ in full]
    # sequence-parallel where the reference's decode constrains the KV
    # cache's sequence to "model" (it divides it, as cache_specs splits it)
    with tuning.use_mesh_hint(mesh):
        kv_seq = any(tuning.constrained_spec(
            t, *(None,) * (t.dim() - 4), sharding.DP_AXES, "model", None,
            None)[-3] == "model" for (_, t), is_kv in zip(full, kv) if is_kv)
    axes = lm_mesh.rows_axes(batch, mesh)
    lay = lm_mesh.Layout(mesh, rows=axes, kv_seq=kv_seq)

    def rows_of(x, dim):
        return lm_mesh.local_rows(x.movedim(dim, 0), axes, mesh).movedim(
            0, dim)

    @torch.no_grad()
    def decode(params, tokens, caches, pos):
        local = [t for _, t in lm_mesh.leaves_with_paths(caches)]
        # the self-attention KV caches as they lie (their batch over the
        # row axes, their sequence over "model"); every other cache
        # gathered whole and cut to this rank's rows
        work = [t if is_kv else rows_of(lm_mesh.gather(t, s, mesh), d)
                for t, s, d, is_kv in zip(local, c_specs, b_dims, kv,
                                          strict=True)]
        tok = lm_mesh.local_rows(tokens.to(device), axes, mesh)
        with lm_mesh.use_layout(lay):
            logits, _ = lm.decode_step(_use(cfg, mesh, specs, params), cfg,
                                       tok, tree.unflatten(caches, work), pos)
            logits = lm_mesh.gather_rows(logits)
            for t, w, s, d, is_kv, (path, _) in zip(local, work, c_specs,
                                                    b_dims, kv, full):
                if not is_kv and not path.startswith("cross_kv"):
                    # the recurrent states: every rank's rows, re-split
                    t.copy_(lm_mesh.shard(lm_mesh.gather_rows(
                        w.movedim(d, 0)).movedim(0, d), s, mesh))
        return logits, caches

    return decode
