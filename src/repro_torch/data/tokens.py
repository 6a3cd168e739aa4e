"""Token data of the LM zoo (the reference's ``data/tokens.py``):
``TokenStreamSpec`` and ``make_batch``, the same numpy code, so a batch is
bitwise the reference's for the same spec and step.

A batch is a pure function of ``(spec, step)``: a fixed random bigram table
(``branch`` successors per token) plus ``noise`` random tokens, drawn by
numpy from the spec's seed, step and shard. ``token_stream`` prefetches
batches on a background thread, which makes numpy arrays only: the tensors
are built on the consumer's thread, so the worker does no device work and
holds the interpreter lock for no more than ``make_batch``.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch import resolve_device


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


def token_stream(spec: TokenStreamSpec, start_step: int = 0,
                 prefetch: int = 2, *, device=None) -> Iterator[dict]:
    """Prefetching iterator of ``{"tokens": (batch, seq) int32}`` on
    ``device`` (the current CUDA device unless asked for another), from
    ``start_step`` on: batch ``i`` is ``make_batch(spec, i)``, so a restart
    at ``start_step`` resumes the exact sequence. A bounded queue of
    ``prefetch`` numpy batches sits between the worker thread and the
    consumer; an error in the worker is raised to the consumer. Closing the
    iterator stops the worker."""
    device = resolve_device(device)
    q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
    stop = threading.Event()

    def put(item) -> None:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def worker():
        step = start_step
        try:
            while not stop.is_set():
                put(make_batch(spec, step))
                step += 1
        except Exception as e:          # raised again on the consumer's side
            put(e)

    th = threading.Thread(target=worker, name="token_stream", daemon=True)
    th.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, Exception):
                raise item
            yield {"tokens": torch.from_numpy(item).to(device)}
    finally:
        stop.set()
        th.join(timeout=5)
