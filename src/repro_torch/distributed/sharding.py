"""Sharding rules over a ``DeviceMesh`` (the reference's
``distributed/sharding.py``): the data-parallel GCN half.

:func:`batch_specs` is the reference's rule for data inputs: a leaf's
leading (batch) axis goes over the mesh's data-parallel axes (``"pod"`` and
``"data"``, those present) where their product divides it, and the leaf is
replicated otherwise. Each leaf gets a tuple of ``DTensor`` placements, one
per mesh dimension: ``Shard(0)`` on the data-parallel dimensions and
``Replicate()`` elsewhere, or all ``Replicate()``. :func:`named` pairs a
tree of placements with its mesh, the arguments of
``torch.distributed.tensor.distribute_tensor``.

The LM half of the reference's rules (``param_specs``, ``zero1_specs``,
``cache_specs``: tensor, expert and ZeRO-1 sharding of parameters, optimizer
state and decode caches) waits for the LM slice of the distributed stack
(ROADMAP.md queue 1: sharding and the distributed stack).
"""
from __future__ import annotations

import math
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


def _axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names or (), mesh.shape))


def batch_specs(batch_shape: Any, mesh) -> Any:
    """Placements of every leaf of ``batch_shape`` (anything with a
    ``.shape``) on ``mesh``: ``Shard(0)`` over ("pod", "data") where the
    leading axis is at least their product and divisible by it, else
    replicated; 0-d leaves are replicated. ``mesh`` needs only
    ``mesh_dim_names`` and ``shape``."""
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


def named(mesh, specs: Any) -> Any:
    """Each leaf of ``specs`` (a placements tuple) as ``(mesh,
    placements)``, the arguments ``distribute_tensor(t, *pair)`` takes."""
    return _map(lambda p: (mesh, list(p)), specs, _placements)
