"""Mesh-sharded batched SpMM, g-SpMM and fused graph-conv layer: the batch
axis split over the ``"data"`` axis of a ``DeviceMesh`` (the reference's
``distributed/spmm.py``, DESIGN.md §6).

The reference is single-controller: ``shard_map`` over one process's mesh,
with the custom VJP outside it. The port is multi-controller (one process
per rank, ``repro_torch.launch.mesh``), and keeps the reference's structure
one for one:

- **Global operands in, global result out.** Every rank holds the whole
  batch, as the reference's callers pass it. A sharded op pads the batch
  to a multiple of the shard count with zero-nnz samples
  (:func:`pad_batch`), runs the SAME per-shard kernel as the local path
  (``kernels.ops._forward``, ``_gspmm_forward``, the fused forwards) on this
  rank's contiguous slice, then ``all_gather``s the slices, so every rank
  holds the global output, sliced back to the caller's batch.
- **Backward outside the collective.** One ``torch.autograd.Function`` per
  op, the reference's ``custom_vjp``: each rank takes its slice of the
  (replicated) cotangent, computes its shard's dValues and dB (or dX) with
  the local path's own helpers (``backward_db``, ``dvalues``,
  ``gspmm_backward``, ``fused_bwd``) and all-gathers them. The fused
  layer's replicated ``w`` and ``bias`` get their gradients all-reduced
  (summed) inside the backward: the reference's ``psum``.
- **What this buys.** Everything outside the sharded ops (the feature
  einsum, the masked batch-norm over the whole batch, the readout and head,
  the loss mean over the global batch) runs on global tensors on every
  rank, so parameters and their gradients come out the same on every rank
  with no trainer-level all-reduce. A DDP-style gradient all-reduce on top
  would count the fused layer's dW twice. DTensor with ``local_map`` would
  give the same sums; plain autograd Functions over the ported kernels keep
  the local path's wrappers, launch counts and bits.

Per-shard autotuning: ``impl="auto"`` resolves against the per-shard
workload (``Workload.shard``), the shapes each rank's kernel runs. A
sample's output depends on its own operands only, so a forced row-owned
impl gives the local call's bits; the fused kernel's small branch adds in
integer-atomic order on the card and matches to the f32 tolerance.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.formats import BatchedCOO
from repro_torch.launch.mesh import all_gather_cat, all_reduce_sum
from repro_torch.observability import trace as obs_trace

__all__ = [
    "pad_batch",
    "resolve_sharded_gspmm_impl",
    "resolve_sharded_impl",
    "shard_count",
    "sharded_batched_gspmm",
    "sharded_batched_spmm",
    "sharded_fused_graph_conv",
]


def shard_count(mesh, axis: str = "data") -> int:
    """Number of shards the batch axis is split into on ``mesh`` (anything
    with ``mesh_dim_names`` and ``shape``)."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(
            f"mesh has axes {names}, no {axis!r} axis to shard the batch "
            "over")
    return mesh.shape[names.index(axis)]


def _pad_rows(t: torch.Tensor, pad: int) -> torch.Tensor:
    """``t`` with ``pad`` rows of zeros appended on dim 0."""
    return torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])


def pad_batch(a: BatchedCOO, b: torch.Tensor, n_shards: int
              ) -> tuple[BatchedCOO, torch.Tensor, int]:
    """Pad the batch axis to a multiple of ``n_shards`` with zero-nnz
    samples (indices 0, values 0.0, nnz 0: they add nothing). Padded
    samples keep ``n_rows = m_pad`` so every shard has one geometry.
    Returns (a, b, pad), ``pad`` the rows to slice off outputs."""
    batch = b.shape[0]
    pad = (-batch) % n_shards
    if pad == 0:
        return a, b, 0
    a = BatchedCOO(
        row_ids=_pad_rows(a.row_ids, pad), col_ids=_pad_rows(a.col_ids, pad),
        values=_pad_rows(a.values, pad), nnz=_pad_rows(a.nnz, pad),
        n_rows=torch.cat([a.n_rows, a.n_rows.new_full((pad,), b.shape[1])]))
    return a, _pad_rows(b, pad), pad


@dataclasses.dataclass(frozen=True)
class _Shard:
    """This rank's slice ``[lo, hi)`` of a padded batch on ``mesh[axis]``."""

    mesh: object
    axis: str
    lo: int
    hi: int

    @staticmethod
    def of(mesh, axis: str, padded_batch: int) -> "_Shard":
        n = shard_count(mesh, axis)
        per = padded_batch // n
        i = mesh.get_local_rank(axis)
        return _Shard(mesh, axis, i * per, (i + 1) * per)

    def take(self, *ts):
        return tuple(t[self.lo:self.hi] for t in ts)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        return all_gather_cat(t, self.mesh, self.axis)


def resolve_sharded_impl(a: BatchedCOO, b: torch.Tensor, mesh, *,
                         axis: str = "data", impl: str = "auto",
                         k_pad: int | None = None, precision: str = "f32"):
    """Resolve ``impl`` against the PER-SHARD workload: a
    ``repro_torch.autotune.Decision`` whose plan and scores describe one
    shard's call (batch ``ceil(batch / n_shards)``). ``precision`` admits
    the reduced-precision variants under ``auto``, as the local path."""
    from repro_torch import autotune

    n = shard_count(mesh, axis)
    batch, m_pad, n_b = b.shape
    dtype = autotune.precision_of(impl)[1] if impl != "auto" else precision
    w = autotune.Workload(batch=batch, m_pad=m_pad,
                          nnz_pad=a.row_ids.shape[1], k_pad=k_pad, n_b=n_b,
                          itemsize=b.element_size(), dtype=dtype).shard(n)
    if impl != "auto":
        return autotune.forced_decision(w, impl, note=f" ({n}-way sharded)")
    return autotune.select_impl(w, allow_pallas=b.device.type == "cuda",
                                cache=autotune.default_cache())


class _ShardedSpMM(torch.autograd.Function):
    """The local ``_SpMM`` on this rank's slice, all-gathered; its VJP runs
    ``backward_db`` and ``dvalues`` on the slice and all-gathers both."""

    @staticmethod
    def forward(ctx, values, b, row_ids, col_ids, nnz, impl, k_pad, shard):
        from repro_torch.kernels.ops import _forward

        ctx.save_for_backward(values, b, row_ids, col_ids, nnz)
        ctx.impl, ctx.shard = impl, shard
        return shard.gather(_forward(*shard.take(row_ids, col_ids, nnz,
                                                 values, b),
                                     impl=impl, k_pad=k_pad))

    @staticmethod
    def backward(ctx, dc):
        from repro_torch.kernels.ops import backward_db, dvalues

        shard = ctx.shard
        values, b, row_ids, col_ids, nnz = shard.take(*ctx.saved_tensors)
        dc = dc[shard.lo:shard.hi].contiguous()
        dval = db = None
        if ctx.needs_input_grad[0]:
            dval = shard.gather(dvalues(row_ids, col_ids, dc, b).to(
                values.dtype))
        if ctx.needs_input_grad[1]:
            db = shard.gather(backward_db(row_ids, col_ids, nnz, values, dc,
                                          impl=ctx.impl).to(b.dtype))
        return dval, db, None, None, None, None, None, None


def sharded_batched_spmm(a: BatchedCOO, b: torch.Tensor, *, mesh,
                         axis: str = "data", impl: str = "auto",
                         k_pad: int | None = None,
                         precision: str = "f32") -> torch.Tensor:
    """C[s] = A[s] @ B[s] with the batch axis sharded over ``mesh[axis]``:
    the same sums as ``kernels.ops.batched_spmm`` (each rank runs the same
    per-shard kernel on its slice), differentiable in ``a.values`` and
    ``b``, the global result on every rank. ``impl="auto"`` resolves
    against the per-shard workload. One shard is the local call."""
    from repro_torch.kernels.ops import batched_spmm

    n = shard_count(mesh, axis)
    if n == 1:
        return batched_spmm(a, b, impl=impl, k_pad=k_pad,
                            precision=precision)
    batch = b.shape[0]
    a, b, pad = pad_batch(a, b, n)
    decision = resolve_sharded_impl(a, b, mesh, axis=axis, impl=impl,
                                    k_pad=k_pad, precision=precision)
    concrete = decision.impl
    shard = _Shard.of(mesh, axis, b.shape[0])

    def run():
        return _ShardedSpMM.apply(a.values, b, a.row_ids, a.col_ids, a.nnz,
                                  concrete, k_pad, shard)

    if obs_trace.enabled():
        # the distributed layer's span: the per-SHARD workload key is the
        # decision's provenance, as the tuning cache and auditor key it
        w = decision.workload
        with obs_trace.TRACER.span(
                f"sharded_spmm/{concrete}", cat="kernel",
                args={"impl": concrete, "source": decision.source,
                      "n_shards": n, "padded": bool(pad),
                      "key": None if w is None else w.key()}):
            out = run()
    else:
        out = run()
    return out[:batch] if pad else out


def resolve_sharded_gspmm_impl(a: BatchedCOO, b: torch.Tensor, mesh, *,
                               op: str = "mul", reduce: str = "sum",
                               axis: str = "data", impl: str = "auto",
                               k_pad: int | None = None):
    """:func:`resolve_sharded_impl` for a g-SpMM call: the per-shard
    workload with its ``(op, reduce, d_e)`` axes, ranked over the
    g-SpMM-capable subset."""
    from repro_torch import autotune

    n = shard_count(mesh, axis)
    batch, m_pad, n_b = b.shape
    d_e = a.values.shape[2] if a.values.dim() == 3 else None
    w = autotune.Workload(batch=batch, m_pad=m_pad,
                          nnz_pad=a.row_ids.shape[1], k_pad=k_pad, n_b=n_b,
                          itemsize=b.element_size(), d_e=d_e, reduce=reduce,
                          op=op).shard(n)
    if impl != "auto":
        return autotune.forced_decision(w, impl, note=f" ({n}-way sharded)")
    return autotune.select_impl(w, allow_pallas=b.device.type == "cuda",
                                cache=autotune.default_cache())


class _ShardedGSpMM(torch.autograd.Function):
    """The local ``_GSpMM`` on this rank's slice, all-gathered; its VJP is
    ``gspmm_backward`` on the slice (the max routing reads the slice's own
    forward output)."""

    @staticmethod
    def forward(ctx, values, b, row_ids, col_ids, nnz, impl, k_pad, op,
                reduce, shard):
        from repro_torch.kernels.ops import _gspmm_forward

        rids, cids, nz, vals, bb = shard.take(row_ids, col_ids, nnz, values,
                                              b)
        c = _gspmm_forward(rids, cids, nz, vals, bb, impl=impl, k_pad=k_pad,
                           op=op, reduce=reduce)
        ctx.save_for_backward(values, b, row_ids, col_ids, nnz,
                              c if reduce == "max" else None)
        ctx.impl, ctx.op, ctx.reduce, ctx.shard = impl, op, reduce, shard
        return shard.gather(c)

    @staticmethod
    def backward(ctx, dc):
        from repro_torch.kernels.ops import gspmm_backward

        shard = ctx.shard
        values, b, row_ids, col_ids, nnz, c = ctx.saved_tensors
        values, b, row_ids, col_ids, nnz = shard.take(values, b, row_ids,
                                                      col_ids, nnz)
        need_values, need_b = ctx.needs_input_grad[:2]
        dval, db = gspmm_backward(
            row_ids, col_ids, nnz, values, b, c, dc[shard.lo:shard.hi],
            op=ctx.op, reduce=ctx.reduce, impl=ctx.impl,
            need_values=need_values, need_b=need_b)
        return (shard.gather(dval) if need_values else None,
                shard.gather(db) if need_b else None,
                None, None, None, None, None, None, None, None)


def sharded_batched_gspmm(a: BatchedCOO, b: torch.Tensor, *,
                          op: str = "mul", reduce: str = "sum", mesh,
                          axis: str = "data", impl: str = "auto",
                          k_pad: int | None = None) -> torch.Tensor:
    """g-SpMM (``C[r] = reduce op(B[c], e)``) with the batch axis sharded
    over ``mesh[axis]``, as :func:`sharded_batched_spmm`: zero-nnz padding
    (a padded sample's rows take the 0.0 identity under every reduce),
    per-shard resolution, the VJP outside the collective. The (mul, sum)
    scalar-edge corner is :func:`sharded_batched_spmm`, as locally."""
    from repro_torch.autotune.cost_model import GSPMM_IMPLS, supports_gspmm
    from repro_torch.kernels.ops import batched_gspmm

    if (op, reduce) == ("mul", "sum") and a.values.dim() == 2:
        return sharded_batched_spmm(a, b, mesh=mesh, axis=axis, impl=impl,
                                    k_pad=k_pad)
    n = shard_count(mesh, axis)
    if n == 1:
        return batched_gspmm(a, b, op=op, reduce=reduce, impl=impl,
                             k_pad=k_pad)
    batch = b.shape[0]
    a, b, pad = pad_batch(a, b, n)
    concrete = resolve_sharded_gspmm_impl(
        a, b, mesh, op=op, reduce=reduce, axis=axis, impl=impl,
        k_pad=k_pad).impl
    if not supports_gspmm(concrete):
        raise ValueError(
            f"impl {concrete!r} cannot run g-SpMM (op={op!r}, "
            f"reduce={reduce!r}); the capable set is {GSPMM_IMPLS} at f32")
    out = _ShardedGSpMM.apply(a.values, b, a.row_ids, a.col_ids, a.nnz,
                              concrete, k_pad, op, reduce,
                              _Shard.of(mesh, axis, b.shape[0]))
    return out[:batch] if pad else out


class _ShardedFusedGraphConv(torch.autograd.Function):
    """The fused layer on this rank's slice, all-gathered. Its VJP is
    ``fused_bwd`` on the slice: dValues and dX all-gathered, the replicated
    ``w`` and ``bias`` gradients all-reduced."""

    @staticmethod
    def forward(ctx, values, x, w, bias, rids, cids, nnz, plan, hplan,
                epilogue, impl, shard):
        from repro_torch.kernels.fused_graph_conv import fused_layer_forward

        r, c, v, nz, xx = shard.take(rids, cids, values, nnz, x)
        y = fused_layer_forward(r, c, v, nz, xx, w, bias, plan=plan,
                                hplan=hplan, epilogue=epilogue, impl=impl)
        ctx.save_for_backward(values, x, w, bias, rids, cids, y)
        ctx.epilogue, ctx.impl, ctx.shard = epilogue, impl, shard
        return shard.gather(y)

    @staticmethod
    def backward(ctx, dy):
        from repro_torch.kernels.fused_graph_conv import fused_bwd
        from repro_torch.kernels.ops import bwd_impl_for

        shard = ctx.shard
        values, x, w, bias, rids, cids, y = ctx.saved_tensors
        r, c, v, xx = shard.take(rids, cids, values, x)
        needs = tuple(ctx.needs_input_grad[:4])
        dvals, dx, dw, db, _ = fused_bwd(
            r, c, v, xx, w, bias, y, dy[shard.lo:shard.hi],
            epilogue=ctx.epilogue, bwd_impl=bwd_impl_for(ctx.impl),
            needs=needs + (False,))
        mesh, axis = shard.mesh, shard.axis
        return (None if dvals is None else shard.gather(dvals),
                None if dx is None else shard.gather(dx),
                None if dw is None else all_reduce_sum(dw, mesh, axis),
                None if db is None else all_reduce_sum(db, mesh, axis),
                None, None, None, None, None, None, None, None)


def sharded_fused_graph_conv(row_ids: torch.Tensor, col_ids: torch.Tensor,
                             values: torch.Tensor, nnz: torch.Tensor,
                             x: torch.Tensor, w: torch.Tensor,
                             bias: torch.Tensor, *, mesh, axis: str = "data",
                             epilogue: str = "none",
                             impl: str = "fused") -> torch.Tensor:
    """The fused graph-conv layer with the batch axis sharded over
    ``mesh[axis]``: each rank runs ONE fused kernel launch for its slice
    (ids / values (batch, channels, nnz_pad), nnz (batch, channels),
    x (batch, m_pad, n_in); ``w`` (channels, n_in, n_out) and ``bias``
    (channels, n_out) replicated). Zero-nnz padding (a padded sample has
    zero chunks, so its loop never runs), per-shard plans, the VJP outside
    the collective with dW and dbias all-reduced. ``impl`` is ``"fused"``,
    ``"fused_hybrid"`` or ``"fused_bf16"`` (bf16 operands, as
    ``graph_conv_batched`` casts them). Planner case 3 raises, as the local
    layer does."""
    from repro_torch.kernels.fused_graph_conv import (
        fused_graph_conv,
        plan_fused_layer,
    )

    n = shard_count(mesh, axis)
    if n == 1:
        return fused_graph_conv(row_ids, col_ids, values, nnz, x, w, bias,
                                epilogue=epilogue, impl=impl)
    batch = row_ids.shape[0]
    pad = (-batch) % n
    # per-shard plans: the shapes each rank's kernel runs
    plan, hplan = plan_fused_layer(impl, row_ids, x, w,
                                   batch=(batch + pad) // n)
    if pad:
        row_ids, col_ids, values, nnz, x = (
            _pad_rows(t, pad) for t in (row_ids, col_ids, values, nnz, x))
    out = _ShardedFusedGraphConv.apply(
        values, x, w, bias, row_ids, col_ids, nnz, plan, hplan, epilogue,
        impl, _Shard.of(mesh, axis, batch + pad))
    return out[:batch] if pad else out
