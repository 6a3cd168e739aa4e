"""Sharding rules over a ``DeviceMesh`` (the reference's
``distributed/sharding.py``): data inputs, LM parameters, ZeRO-1 optimizer
state and decode caches.

Each leaf gets a tuple of ``DTensor`` placements, one per mesh dimension:
``Shard(d)`` where that mesh axis splits the leaf's dim ``d``, else
``Replicate()``. Two mesh axes that split the same dim (the reference's
``("pod", "data")``) split it in mesh order, as ``DTensor`` does: the first
axis takes contiguous blocks, the second splits each block.
:func:`to_partition_spec` gives the reference's ``PartitionSpec`` entries
back (None, an axis name, or a tuple of them), so tests compare the two
packages leaf by leaf. The rules read only ``mesh_dim_names`` and
``shape``, so they run without devices, and re-evaluate against any mesh
shape (an elastic restart).

- :func:`batch_specs`: a leaf's leading (batch) axis over ("pod", "data")
  where their product divides it, else replicated.
- :func:`param_specs`: the reference's name- and shape-based rules, aligned
  to the LAST dims of each leaf so stacked leading axes (n_blocks, groups)
  stay replicated: MoE banks expert-parallel on "model" when E divides it,
  else split on d_ff; the embedding on vocab, else d_model, never both;
  column-parallel projections on their output dim, row-parallel ones on
  their input dim; every other leaf replicated. A rule whose dim does not
  divide falls back to replicated.
- :func:`zero1_specs`: additionally split a leaf over "data" on its first
  unsplit dim that divides (Adam moments under ZeRO-1, and parameters
  under FSDP); a leaf already split over "data" is left as it is.
- :func:`cache_specs`: KV caches batch → data, sequence → "model"; Mamba's
  SSM state heads → "model" (else head_dim), its conv state channels →
  "model"; RWKV's wkv heads → "model"; at most one "model" a leaf.
"""
from __future__ import annotations

import math
import re
from typing import Any

from torch.distributed.tensor import Replicate, Shard

DP_AXES = ("pod", "data")


def _placements(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(q, (Shard, Replicate))
                                        for q in x)


def _map(fn, t, is_leaf):
    """``fn`` on every leaf of a tree of dicts, lists and tuples, where
    ``is_leaf`` marks leaves that are themselves tuples."""
    if is_leaf(t):
        return fn(t)
    if isinstance(t, dict):
        return {k: _map(fn, v, is_leaf) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_map(fn, v, is_leaf) for v in t)
    return fn(t)


def _map_with_path(fn, t, path=""):
    """``fn(path, leaf)`` on every leaf of a tree of dicts, lists and
    tuples; ``path`` is the reference's ``_path_str`` (keys and indices
    joined by "/")."""
    if isinstance(t, dict):
        return {k: _map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_map_with_path(fn, v, f"{path}/{i}" if path
                                      else str(i)) for i, v in enumerate(t))
    return fn(path, t)


def _axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names or (), mesh.shape))


def _from_parts(parts: list, mesh) -> tuple:
    """Placements of a leaf whose dims are split as ``parts`` (per dim:
    None, an axis name or a tuple of names)."""
    out = []
    for name in mesh.mesh_dim_names or ():
        dim = next((d for d, part in enumerate(parts) if part is not None
                    and name in (part if isinstance(part, tuple)
                                 else (part,))), None)
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


def to_partition_spec(placements: tuple, mesh, ndim: int | None = None
                      ) -> tuple:
    """The reference's ``PartitionSpec`` entries of ``placements``: per
    tensor dim, None, the one axis name that splits it, or the tuple of
    names (in mesh order); padded with None to ``ndim`` when given, else
    ending at the last split dim."""
    names = tuple(mesh.mesh_dim_names or ())
    split: dict[int, list[str]] = {}
    for name, q in zip(names, placements):
        if isinstance(q, Shard):
            split.setdefault(q.dim, []).append(name)
    n = max(split, default=-1) + 1 if ndim is None else ndim
    return tuple(None if d not in split else
                 split[d][0] if len(split[d]) == 1 else tuple(split[d])
                 for d in range(n))


def split_axes(placements: tuple, mesh) -> dict[str, int]:
    """Axis name → the tensor dim it splits, for the axes of size > 1
    that split the leaf (in mesh order)."""
    sizes = _axis_sizes(mesh)
    return {name: q.dim for name, q in zip(mesh.mesh_dim_names or (),
                                           placements)
            if isinstance(q, Shard) and sizes[name] > 1}


def batch_specs(batch_shape: Any, mesh) -> Any:
    """Placements of every leaf of ``batch_shape`` (anything with a
    ``.shape``) on ``mesh``: ``Shard(0)`` over ("pod", "data") where the
    leading axis is at least their product and divisible by it, else
    replicated; 0-d leaves are replicated."""
    names = tuple(mesh.mesh_dim_names or ())
    sizes = _axis_sizes(mesh)
    dp_size = math.prod(sizes[a] for a in DP_AXES if a in sizes)

    def one(leaf):
        shape = tuple(leaf.shape)
        if shape and shape[0] % dp_size == 0 and shape[0] >= dp_size:
            return tuple(Shard(0) if a in DP_AXES else Replicate()
                         for a in names)
        return tuple(Replicate() for _ in names)

    return _map(one, batch_shape, lambda x: False)


# (path regex, trailing-dims rule): per trailing dim a tuple of candidate
# axis names tried in order (the first that divides wins), or None for
# replicated; "MOE_IN" / "MOE_OUT" for the expert banks. Earlier rules win.
_PARAM_RULES: list[tuple[str, tuple | str]] = [
    # MoE expert banks: expert-parallel over "model" when E divides the
    # axis, else split on the d_ff axis
    (r"moe/(w_gate|w_up)$", "MOE_IN"),
    (r"moe/w_down$", "MOE_OUT"),
    # embeddings / output head: the vocab-ish big axis
    (r"embed$", (("model",), ("model",))),       # vocab, else d_model
    (r"lm_head$", (None, ("model",))),
    (r"router$", (None, ("model",))),
    # column-parallel (output-dim) projections
    (r"(wq|wk|wv|wr|wg|w_gate|w_up|cm_k|cm_r|in_proj_zx|in_proj_bc|"
     r"frame_proj|patch_proj|wA)$", (None, ("model",))),
    # row-parallel (input-dim) projections
    (r"(wo|w_down|cm_v|out_proj|wB)$", (("model",), None)),
    # depthwise conv, norms, biases, scalars: replicated
]


def _spec_for(path: str, shape: tuple[int, ...], sizes: dict) -> list:
    """The reference's ``_spec_for``: per dim None or an axis name."""
    for pattern, rule in _PARAM_RULES:
        if not re.search(pattern, path):
            continue
        if rule in ("MOE_IN", "MOE_OUT"):
            if len(shape) < 3:
                continue
            lead = [None] * (len(shape) - 3)
            ms = sizes["model"]
            if shape[-3] % ms == 0:
                return lead + ["model", None, None]
            ff_dim = -1 if rule == "MOE_IN" else -2
            tail = [None, None, None]
            if shape[ff_dim] % ms == 0:
                tail[3 + ff_dim] = "model"
            return lead + tail
        k = len(rule)
        if len(shape) < k:
            continue
        tail = []
        for dim_size, cand in zip(shape[-k:], rule):
            tail.append(next((ax for ax in cand or ()
                              if dim_size % sizes[ax] == 0), None))
        # the embedding: vocab OR d_model over "model", never both
        if path.endswith("embed") and tail[0] == "model":
            tail[1] = None
        return [None] * (len(shape) - k) + tail
    return [None] * len(shape)


def param_specs(params_shape: Any, mesh) -> Any:
    """Placements of every leaf of a parameter tree (tensors, meta tensors
    or anything with a ``.shape``) by the reference's rules."""
    sizes = _axis_sizes(mesh)
    return _map_with_path(
        lambda path, leaf: _from_parts(
            _spec_for(path, tuple(leaf.shape), sizes), mesh), params_shape)


def zero1_specs(p_specs: Any, params_shape: Any, mesh,
                axis: str = "data") -> Any:
    """ZeRO-1: each leaf of ``p_specs`` additionally split over ``axis`` on
    its first dim that no axis splits yet and that ``axis``'s size divides
    (and does not exceed); a leaf already split over ``axis`` (FSDP
    parameters) or with no such dim keeps its placements."""
    names = tuple(mesh.mesh_dim_names or ())
    i_axis = names.index(axis)
    size = mesh.shape[i_axis]

    def one(spec, leaf):
        if isinstance(spec[i_axis], Shard):
            return spec
        taken = {q.dim for q in spec if isinstance(q, Shard)}
        for d, n in enumerate(tuple(leaf.shape)):
            if d not in taken and n % size == 0 and n >= size:
                return spec[:i_axis] + (Shard(d),) + spec[i_axis + 1:]
        return spec

    flat_s, flat_l = [], []
    _map(flat_s.append, p_specs, _placements)
    _map(flat_l.append, params_shape, lambda x: False)
    out = iter([one(s, l) for s, l in zip(flat_s, flat_l, strict=True)])
    return _map(lambda _: next(out), p_specs, _placements)


# (path regex, trailing-dims rule) of the decode caches
_CACHE_RULES: list[tuple[str, tuple]] = [
    # attention KV cache (B, S, KV, hd): batch → data, SEQUENCE → model
    # (sequence-parallel decode: scores shard-local, only the softmax
    # stats and the (B, H, 1, hd) output cross shards)
    (r"(k|v)$", (DP_AXES, ("model",), None, None)),
    # Mamba SSM state (B, H, hd, state): heads → model, else hd
    (r"ssm$", (DP_AXES, ("model",), ("model",), None)),
    # Mamba conv state (B, 3, d_conv): channels → model
    (r"conv$", (DP_AXES, None, ("model",))),
    # RWKV wkv state (B, H, hd, hd)
    (r"wkv$", (DP_AXES, ("model",), None, None)),
    (r"prev_x_(tm|cm)$", (DP_AXES, None)),
]


def cache_specs(cache_shape: Any, mesh) -> Any:
    """Placements of every leaf of a decode-cache tree by the reference's
    rules: the batch axis over the data axes present where their product
    divides it, the rest as :data:`_CACHE_RULES` says, at most one
    "model" a leaf; leaves no rule names are replicated."""
    sizes = _axis_sizes(mesh)

    def pick(n, cand):
        if cand is None:
            return None
        if cand == DP_AXES:
            dp = tuple(a for a in cand if a in sizes)
            if dp and n % math.prod(sizes[a] for a in dp) == 0:
                return dp
            return None
        return next((ax for ax in cand if ax in sizes and n % sizes[ax] == 0),
                    None)

    def one(path, leaf):
        shape = tuple(leaf.shape)
        for pattern, rule in _CACHE_RULES:
            if re.search(pattern, path) and len(shape) >= len(rule):
                k = len(rule)
                tail = [pick(n, c) for n, c in zip(shape[-k:], rule)]
                first = tail.index("model") if "model" in tail else None
                tail = [None if t == "model" and i != first else t
                        for i, t in enumerate(tail)]
                return _from_parts([None] * (len(shape) - k) + tail, mesh)
        return _from_parts([None] * len(shape), mesh)

    return _map_with_path(one, cache_shape)


def named(mesh, specs: Any) -> Any:
    """Each leaf of ``specs`` (a placements tuple) as ``(mesh,
    placements)``, the arguments ``distribute_tensor(t, *pair)`` takes."""
    return _map(lambda p: (mesh, list(p)), specs, _placements)
