"""Sampled-minibatch loader: ItemSampler × neighbor_sample × feature gather
(DESIGN.md §14), the reference's ``sampling/loader.py``.

``SampledNodeLoader`` is the giant-graph input pipeline the trainer
consumes: per epoch it shuffles the seed set (``ItemSampler``), samples
each minibatch's layered blocks (``neighbor_sample``, addressed by
``(seed, epoch, batch)``), pads every block to its layer's bucket rung
(``bucketing.block_ladders``) and gathers the input layer's source features
through the optional hot-node cache. Everything it builds lies on the host
(numpy, and each block's CPU ``BatchedCOO``); wrap ``epoch(e)`` in a
:class:`~repro_torch.sampling.feature_cache.Prefetcher` to build the next
minibatch during the current step.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np

from repro_torch.core.csc import Block, CSCGraph
from repro_torch.core.formats import coo_from_lists
from repro_torch.sampling.bucketing import block_ladders, bucket_for
from repro_torch.sampling.feature_cache import FeatureStore, HotNodeCache
from repro_torch.sampling.item_sampler import ItemSampler
from repro_torch.sampling.neighbor import neighbor_sample


@dataclasses.dataclass(frozen=True)
class SampledBatch:
    """One training minibatch: layered blocks (input-side first), the
    input layer's source features padded to ``blocks[0].m_pad`` rows, and
    the per-seed labels aligned with ``blocks[-1]``'s dst prefix."""

    blocks: list
    x: np.ndarray          # (blocks[0].m_pad, feat_dim) — rows >= n_src zero
    labels: np.ndarray     # (batch_size,) seed-node labels
    seeds: np.ndarray      # (batch_size,) global seed ids
    epoch: int
    batch_index: int

    def shape_key(self) -> tuple:
        """Static geometry of this minibatch: distinct keys are the
        reference's distinct compiled programs, bounded by the ladder
        product."""
        return tuple((b.m_pad, b.nnz_pad) for b in self.blocks)


class SampledNodeLoader:
    """Deterministic sampled-minibatch stream over one :class:`CSCGraph`."""

    def __init__(
        self,
        csc: CSCGraph,
        features: np.ndarray,
        labels: np.ndarray,
        seed_ids: np.ndarray,
        *,
        fanouts: Sequence[int],
        batch_size: int,
        seed: int = 0,
        levels: int = 3,
        cache: HotNodeCache | None = None,
        store: FeatureStore | None = None,
        registry=None,
    ):
        if len(labels) != csc.n_nodes or len(features) != csc.n_nodes:
            raise ValueError(
                f"features ({len(features)}) / labels ({len(labels)}) must "
                f"cover all {csc.n_nodes} nodes")
        self.csc = csc
        self.labels = np.asarray(labels)
        self.fanouts = list(fanouts)
        self.seed = int(seed)
        self.sampler = ItemSampler(seed_ids, batch_size, seed=seed)
        self.ladders = block_ladders(batch_size, self.fanouts,
                                     n_nodes=csc.n_nodes, levels=levels)
        if cache is not None:
            self.store = cache.store
            self.fetch = cache.gather
        else:
            self.store = store if store is not None else \
                FeatureStore(features, registry=registry)
            self.fetch = self.store.gather

    def batches_per_epoch(self) -> int:
        return self.sampler.batches_per_epoch()

    def sample_batch(self, epoch: int, batch_index: int,
                     seeds: np.ndarray) -> SampledBatch:
        """Build one minibatch: pure in ``(loader seed, epoch, batch_index,
        seeds)``, so any step can be rebuilt after a restore."""
        blocks = neighbor_sample(
            self.csc, seeds, self.fanouts,
            seed=(self.seed, epoch, batch_index))
        blocks = [
            self._rebucket(b, self.ladders[i]) for i, b in enumerate(blocks)
        ]
        b0 = blocks[0]
        x = np.zeros((b0.m_pad, self.store.feat_dim),
                     self.store.features.dtype)
        x[:b0.n_src] = self.fetch(b0.src_ids)
        return SampledBatch(blocks=blocks, x=x,
                            labels=self.labels[seeds],
                            seeds=np.asarray(seeds, np.int64),
                            epoch=epoch, batch_index=batch_index)

    def _rebucket(self, block: Block, ladder) -> Block:
        """Pad a block UP to its layer's smallest covering rung. The edge
        triples (and their sampled-degree normalization) carry over as they
        are; only the structural zero padding grows."""
        m_pad, nnz_pad = bucket_for(ladder, block.n_src, block.nnz)
        if m_pad == block.m_pad and nnz_pad == block.nnz_pad:
            return block
        nnz = block.nnz
        adj = coo_from_lists(
            [(block.adj.row_ids[0, :nnz].numpy(),
              block.adj.col_ids[0, :nnz].numpy(),
              block.adj.values[0, :nnz].numpy())],
            [block.n_dst], nnz_pad=nnz_pad)
        return dataclasses.replace(block, adj=adj, m_pad=m_pad)

    def epoch(self, epoch: int) -> Iterator[SampledBatch]:
        for batch_index, seeds in self.sampler.epoch(epoch):
            yield self.sample_batch(epoch, batch_index, seeds)
