"""Fanout-bounded neighbor sampling over a
:class:`~repro_torch.core.csc.CSCGraph` (DESIGN.md §14), the reference's
``sampling/neighbor.py``: the same numpy calls in the same order, so a
sample is bitwise the reference's for the same arguments.

``neighbor_sample`` walks the layer stack from the seed (output) side
inward: per layer it samples at most ``fanout`` in-neighbors of each
current destination node, compacts the touched node ids into local 0-based
ids with the destinations as the PREFIX of the source set, and emits the
bipartite adjacency as a kernel-ready padded ``BatchedCOO`` (on the CPU).

Determinism: the whole multi-layer sample is a pure function of
``(csc, seeds, fanouts, seed)``, so a trainer resumed from a checkpoint
rebuilds any minibatch from its ``(loader seed, epoch, batch index)``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.csc import Block, CSCGraph, make_block


def _compact(seeds: np.ndarray, flat_src: np.ndarray):
    """Local-id compaction with the dst set as prefix: ``(src_ids,
    cols_local)`` with ``src_ids[:len(seeds)] == seeds`` and every entry of
    ``flat_src`` mapped to its position in ``src_ids`` (first-appearance
    order)."""
    cat = np.concatenate([seeds, flat_src]) if len(flat_src) else seeds
    _, first = np.unique(cat, return_index=True)
    src_ids = cat[np.sort(first)]          # unique, in first-appearance order
    sorter = np.argsort(src_ids)
    if len(flat_src):
        cols = sorter[np.searchsorted(src_ids, flat_src, sorter=sorter)]
    else:
        cols = np.zeros((0,), np.int64)
    return src_ids.astype(np.int64), cols.astype(np.int32)


def sample_layer(
    csc: CSCGraph,
    seeds: np.ndarray,
    fanout: int,
    rng: np.random.Generator,
):
    """One layer's raw sample: for each seed (destination), up to ``fanout``
    of its in-neighbors without replacement (all of them when the in-degree
    is below the fanout).

    Returns ``(rows, cols, src_ids)``: LOCAL dst row ids, LOCAL src col ids,
    and the dst-prefixed global id map.
    """
    if fanout < 1:
        raise ValueError(f"fanout must be >= 1, got {fanout}")
    picked = []
    indptr, indices = csc.indptr, csc.indices
    for g in seeds:
        lo, hi = int(indptr[g]), int(indptr[g + 1])
        deg = hi - lo
        if deg <= fanout:
            picked.append(indices[lo:hi])
        else:
            picked.append(indices[lo + rng.choice(deg, size=fanout,
                                                  replace=False)])
    counts = np.fromiter((len(p) for p in picked), np.int64,
                         count=len(picked))
    rows = np.repeat(np.arange(len(seeds), dtype=np.int32), counts)
    flat_src = (np.concatenate(picked) if len(picked) and counts.sum()
                else np.zeros((0,), np.int64))
    src_ids, cols = _compact(np.asarray(seeds, np.int64),
                             flat_src.astype(np.int64))
    return rows, cols, src_ids


def neighbor_sample(
    csc: CSCGraph,
    seeds: np.ndarray,
    fanouts: Sequence[int],
    *,
    seed: int | tuple = 0,
    normalize: str = "mean",
    shapes: Sequence[tuple[int, int] | None] | None = None,
) -> list[Block]:
    """Sample one minibatch's layered blocks.

    ``fanouts[i]`` bounds layer ``i``'s sample per destination; layer 0 is
    the INPUT-side layer (applied first in the forward pass), matching the
    returned order: ``blocks[-1]`` has ``dst == seeds`` and
    ``blocks[i].dst_ids() == blocks[i+1].src_ids`` (the chaining invariant
    the block forward slices on).

    ``shapes`` optionally pins each block's padded ``(m_pad, nnz_pad)`` to a
    bucket rung; ``None`` entries pad minimally. ``seed`` may be an int or
    an int tuple, e.g. ``(loader_seed, epoch, batch_index)``: anything
    ``np.random.default_rng`` takes.
    """
    seeds = np.asarray(seeds, np.int64)
    if len(seeds) == 0:
        raise ValueError("neighbor_sample needs at least one seed node")
    if len(np.unique(seeds)) != len(seeds):
        raise ValueError("seed nodes must be unique (they become the "
                         "compacted dst prefix)")
    if shapes is not None and len(shapes) != len(fanouts):
        raise ValueError(f"shapes has {len(shapes)} entries for "
                         f"{len(fanouts)} layers")
    rng = np.random.default_rng(seed)
    raw = []                                # seed-side first
    cur = seeds
    for fanout in reversed(list(fanouts)):
        rows, cols, src_ids = sample_layer(csc, cur, fanout, rng)
        raw.append((rows, cols, src_ids, len(cur)))
        cur = src_ids
    blocks = []
    for i, (rows, cols, src_ids, n_dst) in enumerate(reversed(raw)):
        shape = shapes[i] if shapes is not None else None
        m_pad, nnz_pad = shape if shape is not None else (None, None)
        blocks.append(make_block(rows, cols, src_ids, n_dst,
                                 m_pad=m_pad, nnz_pad=nnz_pad,
                                 normalize=normalize))
    return blocks
