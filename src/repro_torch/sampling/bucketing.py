"""Geometry bucketing for sampled blocks (DESIGN.md §14), the reference's
``sampling/bucketing.py``.

Every minibatch draws a different ``(n_src, nnz)`` per layer. Each layer
gets a small static set of ``(m_pad, nnz_pad)`` rungs from its worst-case
caps (``core.batching.tier_ladder``, the serving scheduler's ladder), and
every sampled block is padded UP to the smallest covering rung, so a layer
sees at most ``len(ladder)`` shapes in a whole run: the reference's compile
count, and the port's count of distinct step geometries.

The caps follow from the sampling parameters alone: walking seed-side
inward, layer ``i``'s destination count is at most
``batch · ∏_{l>i} (fanout_l + 1)`` (each dst contributes itself, the dst
prefix, plus at most ``fanout`` sampled sources), its source count one
more fanout factor, and its nnz at most ``dst_cap · fanout_i``.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.core.batching import tier_ladder


def block_caps(
    batch_size: int,
    fanouts: Sequence[int],
    *,
    n_nodes: int | None = None,
) -> list[tuple[int, int]]:
    """Per-layer worst-case ``(m_cap, nnz_cap)``, input-side first (the
    block order of ``neighbor_sample``). ``n_nodes`` clamps the node caps:
    a small graph cannot give more sources than it has nodes."""
    fanouts = list(fanouts)
    caps = []
    dst_cap = batch_size
    for fanout in reversed(fanouts):      # seed-side inward
        src_cap = dst_cap * (fanout + 1)  # dst prefix + sampled sources
        if n_nodes is not None:
            dst_cap = min(dst_cap, n_nodes)
            src_cap = min(src_cap, n_nodes)
        caps.append((src_cap, dst_cap * fanout))
        dst_cap = src_cap
    return list(reversed(caps))


def block_ladders(
    batch_size: int,
    fanouts: Sequence[int],
    *,
    n_nodes: int | None = None,
    levels: int = 3,
) -> list[tuple[tuple[int, int], ...]]:
    """One ``tier_ladder`` per layer (input-side first): the static rungs
    the loader pads every sampled block into."""
    return [
        tier_ladder(m_max=m_cap, nnz_max=nnz_cap, levels=levels)
        for m_cap, nnz_cap in block_caps(batch_size, fanouts,
                                         n_nodes=n_nodes)
    ]


def bucket_for(
    ladder: Sequence[tuple[int, int]],
    n_src: int,
    nnz: int,
) -> tuple[int, int]:
    """Smallest rung covering ``(n_src, nnz)`` on BOTH axes. The top rung
    covers every admissible block by construction; a block past it is a
    caller's error (caps computed from other sampling parameters)."""
    for m_pad, nnz_pad in ladder:         # ladder is sorted ascending
        if n_src <= m_pad and nnz <= nnz_pad:
            return (m_pad, nnz_pad)
    raise ValueError(
        f"block (n_src={n_src}, nnz={nnz}) exceeds the top ladder rung "
        f"{tuple(ladder[-1])} — ladder built for different sampling params?")
