"""Token data of the LM zoo (the reference's ``data/tokens.py``):
``TokenStreamSpec`` and ``make_batch``, the same numpy code, so a batch is
bitwise the reference's for the same spec and step.

A batch is a pure function of ``(spec, step)``: a fixed random bigram table
(``branch`` successors per token) plus ``noise`` random tokens, drawn by
numpy from the spec's seed, step and shard. The prefetching
``token_stream`` comes with LM training (ROADMAP.md queue 1: the LM zoo
(LM training)).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenStreamSpec:
    vocab: int
    batch: int
    seq_len: int
    seed: int = 0
    branch: int = 4          # bigram successors per token
    noise: float = 0.1
    shard: int = 0
    num_shards: int = 1


def make_batch(spec: TokenStreamSpec, step: int) -> np.ndarray:
    """Batch for `step` — pure function of (spec, step): (batch, seq_len)
    int32."""
    table_rng = np.random.default_rng(spec.seed)
    table = table_rng.integers(0, spec.vocab,
                               size=(spec.vocab, spec.branch))
    rng = np.random.default_rng(
        (spec.seed, step, spec.shard, 0xA5A5))
    toks = np.empty((spec.batch, spec.seq_len), np.int32)
    toks[:, 0] = rng.integers(0, spec.vocab, spec.batch)
    for t in range(1, spec.seq_len):
        nxt = table[toks[:, t - 1], rng.integers(0, spec.branch, spec.batch)]
        mix = rng.random(spec.batch) < spec.noise
        nxt[mix] = rng.integers(0, spec.vocab, int(mix.sum()))
        toks[:, t] = nxt
    return toks
