"""Seed-node minibatching with epoch-addressable shuffling (DESIGN.md §14),
the reference's ``sampling/item_sampler.py``.

The ``ItemSampler`` owns WHICH seed nodes form each minibatch,
``neighbor_sample`` the neighborhood drawn around them. Both derive their
randomness from ``(seed, epoch[, batch])`` coordinates rather than a
stream consumed in order, so a run restored from a checkpoint rebuilds any
epoch's batch order without replaying the epochs before it.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


class ItemSampler:
    """Deterministic seed-node batcher over a fixed id set.

    ``epoch(e)`` yields ``(batch_index, seed_ids)`` pairs; the permutation is
    a pure function of ``(seed, e)``.
    """

    def __init__(
        self,
        item_ids: np.ndarray,
        batch_size: int,
        *,
        seed: int = 0,
        shuffle: bool = True,
        drop_remainder: bool = True,
    ):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.item_ids = np.asarray(item_ids, np.int64)
        if len(np.unique(self.item_ids)) != len(self.item_ids):
            raise ValueError("item_ids must be unique (seed nodes become "
                             "the compacted dst prefix)")
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.shuffle = bool(shuffle)
        self.drop_remainder = bool(drop_remainder)

    def batches_per_epoch(self) -> int:
        n = len(self.item_ids)
        return n // self.batch_size if self.drop_remainder else \
            -(-n // self.batch_size)

    def epoch(self, epoch: int) -> Iterator[tuple[int, np.ndarray]]:
        ids = self.item_ids
        if self.shuffle:
            perm = np.random.default_rng((self.seed, epoch)).permutation(
                len(ids))
            ids = ids[perm]
        n_full = len(ids) // self.batch_size
        for b in range(n_full):
            yield b, ids[b * self.batch_size:(b + 1) * self.batch_size]
        rem = len(ids) - n_full * self.batch_size
        if rem and not self.drop_remainder:
            yield n_full, ids[n_full * self.batch_size:]
