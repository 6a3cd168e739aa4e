"""Synthetic molecular-graph datasets shaped like the paper's (Table I), and
the giant node-classification graph of the sampled tier.

A copy of the reference's numpy generators (``repro.data.graphs``): for the
same :class:`GraphDatasetSpec` it yields bitwise the same samples, and
:func:`reddit_like` bitwise the same graph for the same seed. Graphs have
at most 50 nodes and bond degree ≤ 4, with one adjacency channel per bond
type; labels come from a fixed random "teacher" GCN so that training has
signal.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.core.csc import CSCGraph, csc_from_edges
from repro_torch.core.formats import coo_from_lists, powerlaw_degrees


@dataclasses.dataclass(frozen=True)
class GraphSample:
    rows: list[np.ndarray]      # per channel
    cols: list[np.ndarray]
    n_nodes: int
    features: np.ndarray        # (n_nodes, n_features)
    label: np.ndarray


@dataclasses.dataclass(frozen=True)
class GraphDatasetSpec:
    n_samples: int = 1024
    max_nodes: int = 50          # paper Table I: Max dim = 50
    min_nodes: int = 8
    max_degree: int = 4          # chemistry: ≤4 bonds
    channels: int = 4            # bond types
    n_features: int = 62
    n_tasks: int = 12
    task: str = "multitask_binary"
    size_dist: str = "uniform"   # "uniform" over [min_nodes, max_nodes], or
                                 # "skewed": a clipped lognormal whose median
                                 # sits well below max_nodes (Table I's gap
                                 # between Avg dim and Max dim)
    seed: int = 0

    @staticmethod
    def tox21_like(n_samples: int = 1024, **kw) -> "GraphDatasetSpec":
        return GraphDatasetSpec(n_samples=n_samples, n_tasks=12,
                                task="multitask_binary", **kw)

    @staticmethod
    def reaction100_like(n_samples: int = 1024, **kw) -> "GraphDatasetSpec":
        return GraphDatasetSpec(n_samples=n_samples, n_tasks=100,
                                task="multiclass", **kw)


def _random_molecule(rng: np.random.Generator, spec: GraphDatasetSpec):
    """Random connected graph with a chemistry-like degree bound, bond types
    assigned per edge; channel 0 also carries the self-loops (a_uu = 1,
    paper §II-A)."""
    if spec.size_dist == "skewed":
        med = spec.min_nodes + (spec.max_nodes - spec.min_nodes) / 4
        n = int(np.clip(round(rng.lognormal(np.log(med), 0.45)),
                        spec.min_nodes, spec.max_nodes))
    else:
        n = int(rng.integers(spec.min_nodes, spec.max_nodes + 1))
    deg = np.zeros(n, np.int32)
    edges = []
    for v in range(1, n):                       # random spanning tree
        u = int(rng.integers(0, v))
        if deg[u] < spec.max_degree and deg[v] < spec.max_degree:
            edges.append((u, v))
            deg[u] += 1
            deg[v] += 1
    extra = int(rng.integers(0, max(1, n // 4)))  # rings
    for _ in range(extra):
        u, v = rng.integers(0, n, 2)
        if u != v and deg[u] < spec.max_degree and deg[v] < spec.max_degree:
            edges.append((int(u), int(v)))
            deg[u] += 1
            deg[v] += 1
    bond = rng.integers(0, spec.channels, len(edges))
    rows = [[] for _ in range(spec.channels)]
    cols = [[] for _ in range(spec.channels)]
    for (u, v), ch in zip(edges, bond):
        rows[ch] += [u, v]
        cols[ch] += [v, u]
    for v in range(n):                          # self loops on channel 0
        rows[0].append(v)
        cols[0].append(v)
    atom_type = rng.integers(0, spec.n_features, n)
    feats = np.zeros((n, spec.n_features), np.float32)
    feats[np.arange(n), atom_type] = 1.0
    return (
        [np.asarray(r, np.int32) for r in rows],
        [np.asarray(c, np.int32) for c in cols],
        n,
        feats,
    )


def _teacher_logits(sample, spec: GraphDatasetSpec, w1, w2):
    """Fixed random 1-layer GCN teacher → learnable labels."""
    rows, cols, n, feats = sample
    a = np.zeros((n, n), np.float32)
    for r, c in zip(rows, cols):
        a[r, c] = 1.0
    h = np.maximum(a @ (feats @ w1), 0)
    return h.sum(0) @ w2


def generate(spec: GraphDatasetSpec) -> list[GraphSample]:
    rng = np.random.default_rng(spec.seed)
    w1 = rng.normal(size=(spec.n_features, 32)).astype(np.float32) * 0.3
    w2 = rng.normal(size=(32, spec.n_tasks)).astype(np.float32) * 0.3
    out = []
    for _ in range(spec.n_samples):
        rows, cols, n, feats = _random_molecule(rng, spec)
        logits = _teacher_logits((rows, cols, n, feats), spec, w1, w2)
        if spec.task == "multitask_binary":
            label = (logits > np.median(logits)).astype(np.float32)
        else:
            label = np.asarray(int(np.argmax(logits)) % spec.n_tasks)
        out.append(GraphSample(rows, cols, n, feats, label))
    return out


def batches(
    data: list[GraphSample],
    spec: GraphDatasetSpec,
    batch_size: int,
    *,
    m_pad: int | None = None,
    nnz_pad: int | None = None,
    drop_remainder: bool = True,
    seed: int = 0,
    epochs: int = 1,
    start_epoch: int = 0,
) -> Iterator[dict]:
    """Padding batch iterator over host (CPU) tensors: every sample padded to
    the dataset max (one static shape), per-channel BatchedCOO + features.
    Each epoch's shuffle is a pure function of ``(seed, epoch)``, as in the
    reference."""
    m_pad = m_pad or -(-max(s.n_nodes for s in data) // 8) * 8
    if nnz_pad is None:
        nnz_pad = -(-max(
            max(len(s.rows[ch]) for ch in range(spec.channels))
            for s in data) // 8) * 8
    for epoch in range(start_epoch, start_epoch + epochs):
        idx = np.random.default_rng((seed, epoch)).permutation(len(data))
        n_full = len(idx) // batch_size
        for i in range(n_full if drop_remainder else n_full + 1):
            sel = idx[i * batch_size:(i + 1) * batch_size]
            if len(sel) == 0:
                continue
            samples = [data[j] for j in sel]
            adj = []
            for ch in range(spec.channels):
                triples = [
                    (s.rows[ch], s.cols[ch],
                     np.ones(len(s.rows[ch]), np.float32))
                    for s in samples
                ]
                adj.append(coo_from_lists(
                    triples, [s.n_nodes for s in samples], nnz_pad=nnz_pad))
            feats = np.zeros((len(samples), m_pad, spec.n_features),
                             np.float32)
            for k, s in enumerate(samples):
                feats[k, :s.n_nodes] = s.features
            labels = np.stack([s.label for s in samples])
            yield {
                "adj": adj,
                "x": torch.from_numpy(feats),
                "n_nodes": torch.tensor([s.n_nodes for s in samples],
                                        dtype=torch.int32),
                "labels": torch.from_numpy(labels),
            }


# -- giant-graph tier (DESIGN.md §14) -----------------------------------


@dataclasses.dataclass(frozen=True)
class NodeClassData:
    """One giant node-classification graph for the sampled tier: the static
    CSC sampling structure, per-node features and labels, and a train/val
    seed split, all host-side numpy. Features reach the device only through
    the sampled minibatch's gather."""

    csc: CSCGraph
    features: np.ndarray   # (n_nodes, n_features) float32
    labels: np.ndarray     # (n_nodes,) int32 class ids
    train_ids: np.ndarray  # (n_train,) int64
    val_ids: np.ndarray    # (n_val,) int64
    n_classes: int


def reddit_like(
    n_nodes: int = 100_000,
    *,
    n_classes: int = 8,
    n_features: int = 64,
    avg_deg: int = 12,
    alpha: float = 1.2,
    homophily: float = 0.7,
    noise: float = 1.0,
    val_frac: float = 0.1,
    seed: int = 0,
) -> NodeClassData:
    """Synthetic "reddit-like" powerlaw node-classification graph, the
    reference's draws in the reference's order.

    * **Zipf-hot hubs**: per-node in-degrees follow the powerlaw of
      ``random_powerlaw_batch`` (:func:`powerlaw_degrees`), so a few hub
      nodes sit in most sampled neighborhoods.
    * **Learnable labels**: planted partition. Each edge's source comes
      from the destination's own class with probability ``homophily``
      (else uniformly), and features are a noisy class centroid.

    Every node has a self-loop (paper §II-A's ``a_uu = 1``), so a
    destination's own features survive fanout sampling.
    """
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    # class-sorted node table: same-class sources are one fancy-index away
    order = np.argsort(labels, kind="stable")
    class_sizes = np.bincount(labels, minlength=n_classes)
    class_offsets = np.zeros(n_classes + 1, np.int64)
    np.cumsum(class_sizes, out=class_offsets[1:])
    deg = powerlaw_degrees(rng, n_nodes, avg_deg, alpha)
    dst = np.repeat(np.arange(n_nodes, dtype=np.int64), deg)
    e = len(dst)
    same = rng.random(e) < homophily
    dst_cls = labels[dst]
    within = rng.integers(0, np.maximum(class_sizes[dst_cls], 1))
    src = np.where(
        same,
        order[class_offsets[dst_cls] + within],   # same-class source
        rng.integers(0, n_nodes, e),              # long-range source
    )
    loops = np.arange(n_nodes, dtype=np.int64)
    src = np.concatenate([src, loops])
    dst = np.concatenate([dst, loops])
    csc = csc_from_edges(src, dst, n_nodes)
    centroids = rng.standard_normal((n_classes, n_features))
    features = (centroids[labels]
                + noise * rng.standard_normal((n_nodes, n_features))
                ).astype(np.float32)
    perm = rng.permutation(n_nodes).astype(np.int64)
    n_val = int(n_nodes * val_frac)
    return NodeClassData(csc=csc, features=features, labels=labels,
                         train_ids=perm[n_val:], val_ids=perm[:n_val],
                         n_classes=n_classes)
