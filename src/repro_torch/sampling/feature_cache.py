"""Feature gather with a hot-node cache and a one-deep prefetch (DESIGN.md
§14), the reference's ``sampling/feature_cache.py``.

The node feature matrix stays on the host; each minibatch gathers only its
input block's source rows. Graphs like these are Zipf-hot (hub nodes sit
in most sampled neighborhoods), so a small cache over the hottest rows
takes most of the gathers. Two admission policies:

* ``"static"`` — the top-in-degree rows, pinned once (the CSC's
  ``in_degrees`` is the statistic); no bookkeeping per fetch;
* ``"lru"`` — recency eviction, for access patterns that drift.

Hits, misses, the hit rate and the gathered bytes and rows are
``featcache_*`` series on the port's ``observability`` registry.

``Prefetcher`` overlaps the NEXT minibatch's sample and gather with the
current step: a worker thread fills a ``Queue(maxsize=1)``. The thread does
host work only (numpy, and the CPU tensors of a block); moving a batch to
the device stays on the consumer's thread.
"""
from __future__ import annotations

import collections
import queue
import threading
from typing import Iterable, Iterator

import numpy as np

from repro_torch.observability import default_registry


class FeatureStore:
    """The full (n_nodes, feat_dim) host feature array, counting the rows
    and bytes every :meth:`gather` reads. ``registry=None`` means the
    process default."""

    def __init__(self, features: np.ndarray, *, registry=None):
        if features.ndim != 2:
            raise ValueError(f"features must be 2-D, got {features.shape}")
        self.features = features
        reg = registry if registry is not None else default_registry()
        self._fetch_bytes = reg.counter(
            "featcache_fetch_bytes_total",
            "bytes gathered from the backing feature store")
        self._fetch_rows = reg.counter(
            "featcache_fetch_rows_total",
            "rows gathered from the backing feature store")
        self.row_bytes = int(features.shape[1] * features.dtype.itemsize)

    @property
    def n_nodes(self) -> int:
        return self.features.shape[0]

    @property
    def feat_dim(self) -> int:
        return self.features.shape[1]

    def gather(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids)
        self._fetch_rows.inc(len(ids))
        self._fetch_bytes.inc(len(ids) * self.row_bytes)
        return self.features[ids]


class HotNodeCache:
    """Hot-row cache in front of a :class:`FeatureStore`.

    ``gather(ids)`` returns what a store gather would: hits from the
    cache's copy, misses from the store (admitted under ``"lru"``). Hit and
    miss counters and the hit-rate gauge carry a ``policy`` label.
    """

    def __init__(
        self,
        store: FeatureStore,
        capacity: int,
        *,
        policy: str = "static",
        hot_ids: np.ndarray | None = None,
        registry=None,
    ):
        if policy not in ("static", "lru"):
            raise ValueError(f"unknown cache policy {policy!r}: "
                             "expected 'static' or 'lru'")
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if policy == "static" and hot_ids is None:
            raise ValueError("static policy needs hot_ids (e.g. the top "
                             "in-degree nodes from CSCGraph.in_degrees())")
        self.store = store
        self.capacity = int(capacity)
        self.policy = policy
        reg = registry if registry is not None else default_registry()
        self._hits = reg.counter("featcache_hit_total",
                                 "feature-cache row hits")
        self._misses = reg.counter("featcache_miss_total",
                                   "feature-cache row misses")
        self._hit_rate = reg.gauge("featcache_hit_rate",
                                   "cumulative feature-cache hit rate")
        if policy == "static":
            hot_ids = np.asarray(hot_ids, np.int64)[:capacity]
            # one bulk fill, not counted against the store's per-minibatch
            # fetch counters (a fixed cost, as in the reference)
            self._rows = {int(i): store.features[int(i)] for i in hot_ids}
        else:
            self._rows = collections.OrderedDict()

    def __len__(self) -> int:
        return len(self._rows)

    def hit_rate(self) -> float:
        h = self._hits.value(policy=self.policy)
        m = self._misses.value(policy=self.policy)
        return h / (h + m) if (h + m) else 0.0

    def gather(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids)
        rows = self._rows
        hit_mask = np.fromiter((int(i) in rows for i in ids), bool,
                               count=len(ids))
        miss_ids = ids[~hit_mask]
        out = np.empty((len(ids), self.store.feat_dim),
                       self.store.features.dtype)
        if len(miss_ids):
            out[~hit_mask] = self.store.gather(miss_ids)
        for k in np.flatnonzero(hit_mask):
            out[k] = rows[int(ids[k])]
        if self.policy == "lru":
            # membership is re-checked against the LIVE dict, not hit_mask:
            # an admission earlier in this batch may already have evicted a
            # row that was a hit when the mask was computed (its data is in
            # `out`), and a repeated miss id is admitted once
            for k, i in enumerate(ids):
                i = int(i)
                if i in rows:
                    rows.move_to_end(i)
                else:
                    rows[i] = out[k]
                    if len(rows) > self.capacity:
                        rows.popitem(last=False)
        n_hit = int(hit_mask.sum())
        self._hits.inc(n_hit, policy=self.policy)
        self._misses.inc(len(ids) - n_hit, policy=self.policy)
        self._hit_rate.set(self.hit_rate(), policy=self.policy)
        return out


def static_hot_ids(in_degrees: np.ndarray, capacity: int) -> np.ndarray:
    """Top-``capacity`` node ids by in-degree (descending, stable): the
    static cache's admission set."""
    order = np.argsort(-np.asarray(in_degrees), kind="stable")
    return order[:capacity].astype(np.int64)


class Prefetcher:
    """One-deep double buffer over any minibatch iterator.

    A worker thread drains ``it`` into a ``Queue(maxsize=1)``: while the
    trainer steps on minibatch ``t``, the worker builds ``t+1``. An
    exception reaches the consumer at the item where it occurred; iteration
    ends cleanly on exhaustion. The iterator must do host work only.
    """

    _DONE = object()

    def __init__(self, it: Iterable, *, registry=None):
        self._q: queue.Queue = queue.Queue(maxsize=1)
        reg = registry if registry is not None else default_registry()
        self._depth = reg.gauge("featcache_prefetch_depth",
                                "minibatches resident in the prefetch buffer")
        self._thread = threading.Thread(
            target=self._run, args=(iter(it),), daemon=True)
        self._thread.start()

    def _run(self, it: Iterator) -> None:
        try:
            for item in it:
                self._q.put(item)
        except BaseException as e:  # handed to the consumer
            self._q.put((self._DONE, e))
        else:
            self._q.put((self._DONE, None))

    def __iter__(self):
        while True:
            self._depth.set(self._q.qsize())
            item = self._q.get()
            if isinstance(item, tuple) and len(item) == 2 \
                    and item[0] is self._DONE:
                self._thread.join()
                if item[1] is not None:
                    raise item[1]
                return
            yield item
