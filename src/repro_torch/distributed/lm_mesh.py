"""The LM on a (data × model) mesh: shards, gathers and the tensor-parallel
pair. The reference has no counterpart: GSPMD partitions its jitted step
from the shardings alone. The port is multi-controller (one process a
rank, every rank holding the global inputs), so it does that work here.

Each rank stores only its shards of the parameters, the Adam state and the
decode caches, as ``distributed.sharding``'s placements say
(:func:`shard_tree`; :func:`gather_tree` gives the full tensors back, for
checkpoints). In a step:

- **"data" (and "pod") split the rows**: each rank computes on its slice
  of the global batch (:func:`local_rows`).
- **"model" splits compute only where a shard holds whole units**: the
  Megatron pair in attention, when ``n_heads`` and ``n_kv_heads`` divide
  the axis (``wq``/``wk``/``wv`` column shards, ``wo`` row shard), and in
  the dense SwiGLU (``w_gate``/``w_up`` column, ``w_down`` row)
  (:func:`tp_local`). :func:`copy_to_model` (identity forward, all-reduce
  backward) marks the block input, :func:`reduce_from_model` (all-reduce
  forward in f32, identity backward) the row product's output.
- **Every other split leaf is gathered at use** (:func:`gather_at_use`):
  an all-gather along its split dims forward; backward, over an axis whose
  ranks computed on the same rows ("model") the rank takes its slice of
  the gradient, over one whose ranks computed on different rows ("data"
  under FSDP) the gradient is summed, then sliced.

:func:`use_layout` tells the model code where it runs: the mesh (also the
``tuning`` mesh hint), the axes that split the batch rows, and whether the
decode caches split their sequence axis over "model".
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import re

import torch

from repro_torch import tree, tuning
from repro_torch.distributed.sharding import DP_AXES, split_axes
from repro_torch.launch.mesh import (
    all_gather_cat,
    all_reduce_sum,
    axis_rank,
    axis_size,
    reduce_scatter,
)

# the f32 elements of one gradient bucket of sync_grads (one all-reduce a
# bucket and axis)
GRAD_BUCKET_ELEMS = 1 << 26

@dataclasses.dataclass(frozen=True)
class Layout:
    """Where the model code runs: ``mesh``; ``rows``, the data axes (of
    more than one rank) that split the batch rows (empty when the rows are
    replicated); ``kv_seq``, whether the KV caches split their sequence
    axis over "model"."""

    mesh: object
    rows: tuple[str, ...] = ()
    kv_seq: bool = False

    @property
    def model(self) -> int:
        """The size of the "model" axis (1 without one)."""
        names = self.mesh.mesh_dim_names or ()
        return axis_size(self.mesh, "model") if "model" in names else 1


_LAYOUT: contextvars.ContextVar[Layout | None] = contextvars.ContextVar(
    "lm_layout", default=None)


@contextlib.contextmanager
def use_layout(layout: Layout | None):
    """Model code under this context runs on ``layout`` (None: one
    device); its mesh is the ``tuning`` mesh hint too."""
    tok = _LAYOUT.set(layout)
    try:
        with tuning.use_mesh_hint(None if layout is None else layout.mesh):
            yield
    finally:
        _LAYOUT.reset(tok)


def layout() -> Layout | None:
    return _LAYOUT.get()


# -- which leaves the Megatron pair keeps local ---------------------------


def tp_attention(cfg) -> bool:
    """Whether attention runs tensor-parallel under the current layout:
    "model" has more than one rank and divides both head counts."""
    lay = layout()
    return (lay is not None and lay.model > 1
            and cfg.n_heads % lay.model == 0
            and cfg.n_kv_heads % lay.model == 0)


def tp_ffn(cfg) -> bool:
    """Whether the dense SwiGLU runs tensor-parallel: "model" has more than
    one rank and divides ``d_ff``."""
    lay = layout()
    return lay is not None and lay.model > 1 and cfg.d_ff % lay.model == 0


_ATTN = re.compile(r"attn/(wq|wk|wv|wo)$")
_FFN = re.compile(r"(ffn|shared)/(w_gate|w_up|w_down)$")


def tp_local(path: str, cfg) -> bool:
    """Whether the leaf at ``path`` stays this rank's "model" shard (the
    Megatron pair) rather than being gathered at use."""
    return bool((_ATTN.search(path) and tp_attention(cfg))
                or (_FFN.search(path) and tp_ffn(cfg)))


# -- shards and gathers ---------------------------------------------------


def shard(t: torch.Tensor, placements: tuple, mesh) -> torch.Tensor:
    """This rank's shard of the full tensor ``t`` (a new contiguous
    tensor)."""
    for axis, dim in split_axes(placements, mesh).items():
        t = t.chunk(axis_size(mesh, axis), dim=dim)[axis_rank(mesh, axis)]
    return t.contiguous().clone()


def gather(t: torch.Tensor, placements: tuple, mesh,
           keep: tuple[str, ...] = ()) -> torch.Tensor:
    """The full tensor of this rank's shard ``t``: all-gathered along every
    split dim but those of the axes in ``keep`` (no autograd)."""
    for axis, dim in reversed(split_axes(placements, mesh).items()):
        if axis not in keep:
            t = all_gather_cat(t, mesh, axis, dim)
    return t


def map_specs(fn, a, b):
    """``fn`` on the leaves of ``a`` and the matching placements of
    ``b``."""
    if isinstance(a, dict):
        return {k: map_specs(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def shard_tree(tree_, placements, mesh):
    """Every leaf of ``tree_`` (full tensors) as this rank's shard."""
    return map_specs(lambda t, p: shard(t, p, mesh), tree_, placements)


def gather_tree(tree_, placements, mesh):
    """Every leaf of ``tree_`` (this rank's shards) as its full tensor, on
    every rank."""
    return map_specs(lambda t, p: gather(t, p, mesh), tree_, placements)


def local_shape(shape: tuple, placements: tuple, mesh) -> tuple:
    """The shape of this rank's shard of a leaf of ``shape``."""
    shape = list(shape)
    for axis, dim in split_axes(placements, mesh).items():
        shape[dim] //= axis_size(mesh, axis)
    return tuple(shape)


class _GatherAtUse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, placements, mesh, keep, rows):
        ctx.args = placements, mesh, keep, rows
        return gather(t, placements, mesh, keep)

    @staticmethod
    def backward(ctx, g):
        placements, mesh, keep, rows = ctx.args
        for axis, dim in split_axes(placements, mesh).items():
            if axis in keep:
                continue
            if axis in rows:         # other rows: sum the partial gradients
                g = reduce_scatter(g, mesh, axis, dim)
            else:                    # the same rows: this rank's slice
                g = g.chunk(axis_size(mesh, axis), dim=dim)[
                    axis_rank(mesh, axis)]
        return g.contiguous(), None, None, None, None


def gather_at_use(t: torch.Tensor, placements: tuple, mesh,
                  keep: tuple[str, ...] = ()) -> torch.Tensor:
    """``t`` (this rank's shard) all-gathered along its split dims but
    those of ``keep``, differentiably: backward, the gradient's slice for
    this rank, summed first over the axes that split the rows of the
    current layout. ``t`` itself when nothing is gathered."""
    if all(a in keep for a in split_axes(placements, mesh)):
        return t
    lay = layout()
    return _GatherAtUse.apply(t, placements, mesh, keep,
                              () if lay is None else lay.rows)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.mesh, "model"), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce_sum(x, mesh, "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """The Megatron pair's block input: ``x`` forward, the gradient summed
    over "model" backward (each rank's shard saw part of the units)."""
    return _CopyToModel.apply(x, layout().mesh)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The Megatron pair's output: the partial row products summed over
    "model" (in f32, returned in ``x``'s dtype) forward, the gradient as
    it is backward."""
    return _ReduceFromModel.apply(x, layout().mesh)


def heads_of_rank(x: torch.Tensor, n_local: int) -> torch.Tensor:
    """This rank's ``n_local`` heads of the full head axis (dim 2: (B, T,
    H, hd)) of ``x``, in rank order along "model"."""
    r = axis_rank(layout().mesh, "model")
    return x.narrow(2, r * n_local, n_local)


# -- the rows: the batch over the data axes -------------------------------


def rows_axes(batch_rows: int, mesh) -> tuple[str, ...]:
    """The data axes (of more than one rank) that split a batch of
    ``batch_rows`` rows: all of them when their product divides it (the
    rule of ``sharding.batch_specs``), else none."""
    names = mesh.mesh_dim_names or ()
    axes = tuple(a for a in DP_AXES if a in names and axis_size(mesh, a) > 1)
    n = math.prod(axis_size(mesh, a) for a in axes)
    return axes if batch_rows % n == 0 and batch_rows >= n else ()


def local_rows(x: torch.Tensor, axes: tuple[str, ...], mesh):
    """This rank's contiguous slice of ``x``'s leading axis over ``axes``
    (mesh order: the first axis takes blocks, the next splits each)."""
    for a in axes:
        x = x.chunk(axis_size(mesh, a))[axis_rank(mesh, a)]
    return x


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``x`` along the current layout's row axes, in
    global row order (``x`` itself when the rows are not split)."""
    lay = layout()
    for a in reversed(lay.rows):
        x = all_gather_cat(x, lay.mesh, a, 0)
    return x


def _sum_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    for a in axes:
        x = all_reduce_sum(x, mesh, a)
    return x


def sum_rows(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks that split the rows (no autograd;
    ``x`` itself when the rows are not split)."""
    lay = layout()
    return _sum_over(x, lay.mesh, lay.rows)


class _SumRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = mesh, axes
        return _sum_over(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g, *ctx.args), None, None


def sum_rows_grad(x: torch.Tensor) -> torch.Tensor:
    """:func:`sum_rows` with its adjoint for autograd: the gradient summed
    over the same ranks. For a value every rank's objective uses in
    equal shares (the MoE balance loss of the global means)."""
    lay = layout()
    if not lay.rows:
        return x
    return _SumRows.apply(x, lay.mesh, lay.rows)


def rows_size() -> int:
    """How many ranks split the rows (1 outside a layout)."""
    lay = layout()
    if lay is None:
        return 1
    return math.prod(axis_size(lay.mesh, a) for a in lay.rows)


def row_offset(counts: torch.Tensor) -> torch.Tensor:
    """The exclusive prefix over the ranks before this one (global row
    order) of ``counts``: what every earlier rank holds."""
    lay = layout()
    every = gather_rows(counts[None])             # (ranks, ...)
    index = 0
    for a in lay.rows:
        index = index * axis_size(lay.mesh, a) + axis_rank(lay.mesh, a)
    return every[:index].sum(0)


# -- trees of placements --------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Shards:
    """How a train step's state splits on ``mesh``: ``params`` and
    ``moments`` are placements trees (the Adam moments and the
    error-feedback residuals follow ``moments``: ZeRO-1 adds "data")."""

    mesh: object
    params: object
    moments: object

    def pairs(self) -> list[tuple]:
        """(param placements, moment placements) of every leaf, in leaf
        order."""
        return list(zip(spec_leaves(self.params), spec_leaves(self.moments),
                        strict=True))


def extra_axes(p_spec: tuple, m_spec: tuple, mesh) -> dict[str, int]:
    """The axes (and their dims) that split a moment but not its
    parameter."""
    p_axes = split_axes(p_spec, mesh)
    return {a: d for a, d in split_axes(m_spec, mesh).items()
            if a not in p_axes}


def narrow(t: torch.Tensor, axes: dict[str, int], mesh) -> torch.Tensor:
    """This rank's slice of ``t`` along each of ``axes`` (axis → dim, in
    mesh order)."""
    for a, d in axes.items():
        t = t.chunk(axis_size(mesh, a), dim=d)[axis_rank(mesh, a)]
    return t


def widen(t: torch.Tensor, axes: dict[str, int], mesh) -> torch.Tensor:
    """The inverse of :func:`narrow`: every rank's slices all-gathered."""
    for a, d in reversed(axes.items()):
        t = all_gather_cat(t, mesh, a, d)
    return t


def sync_grads(grads: list, placements: list, mesh,
               rows: tuple[str, ...]) -> list:
    """Sum each gradient over the row axes over which it is still partial
    after its backward: those that do not split its leaf (a split one was
    summed by :func:`gather_at_use`). Bucketed: the leaves that share
    their axes go in f32 buffers of about GRAD_BUCKET_ELEMS elements, one
    all-reduce a buffer and axis. Returns the gradients in their
    dtypes."""
    out = list(grads)
    groups: dict[tuple, list[int]] = {}
    for i, p in enumerate(placements):
        split = split_axes(p, mesh)
        axes = tuple(a for a in rows if a not in split)
        if axes:
            groups.setdefault(axes, []).append(i)
    for axes, idx in groups.items():
        bucket: list[int] = []
        for j, i in enumerate(idx):
            bucket.append(i)
            if (sum(out[k].numel() for k in bucket) >= GRAD_BUCKET_ELEMS
                    or j == len(idx) - 1):
                flat = torch.cat([out[k].reshape(-1).float() for k in bucket])
                for a in axes:
                    flat = all_reduce_sum(flat, mesh, a)
                for k, piece in zip(bucket, flat.split(
                        [out[k].numel() for k in bucket])):
                    out[k] = piece.view(out[k].shape).to(out[k].dtype)
                bucket = []
    return out


def spec_leaves(specs) -> list:
    """The placements of a placements tree (dicts of tuples), in the
    reference's leaf order (keys sorted)."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in spec_leaves(specs[k])]
    return [specs]


def leaves_with_paths(t, path=""):
    """(path, leaf) of every leaf of a tree of dicts, in the reference's
    leaf order (keys sorted)."""
    if isinstance(t, dict):
        return [x for k in sorted(t)
                for x in leaves_with_paths(t[k], f"{path}/{k}" if path
                                           else str(k))]
    return [(path, t)]


def use_tree(params, p_specs, cfg, mesh):
    """The tree the model code computes with: each leaf this rank's
    "model" shard where :func:`tp_local` keeps it, else gathered at use
    (under the current layout)."""
    leaves = [gather_at_use(t, p, mesh, ("model",) if tp_local(path, cfg)
                            else ())
              for (path, t), p in zip(leaves_with_paths(params),
                                      spec_leaves(p_specs), strict=True)]
    return tree.unflatten(params, leaves)
