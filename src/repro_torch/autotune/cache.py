"""Persistent tuning cache for ``impl="auto"`` (the reference's
``autotune/cache.py``): per workload key, the median seconds each impl took
where it was measured.

The document is the reference's, version 1, so each package reads the
other's file::

    {"version": 1,
     "records": {"b128_m56_nnz256_k8_n64_i4_c4_nin62": {
         "best": "fused",
         "times": {"fused": 1.1e-4, "ref": 2.0e-4},
         "interpret": false}}}

``interpret`` is true where no kernel ran (the CPU). Writes merge with what
is on disk, then replace the file atomically (tmp + rename). The default
location is ``$REPRO_TORCH_TUNE_CACHE``, the port's own variable, so that a
record measured by the JAX package never steers the card; unset means no
persistent cache.

On the card :func:`measure_workload` times each call as the wall time
between two ``torch.cuda.synchronize()``: what a caller waits for, host
prep included (the reference's ``block_until_ready``).
"""
from __future__ import annotations

import functools
import json
import os
import tempfile

from repro_torch.autotune.cost_model import Workload, precision_of, rank, \
    rank_layer

ENV_VAR = "REPRO_TORCH_TUNE_CACHE"
_VERSION = 1


def _merge_records(disk: dict, mine: dict) -> dict:
    """Union of two record maps (see :meth:`TuningCache.save`): disk-only
    keys survive, shared keys merge their ``times`` at the per-impl minimum
    with ``best`` recomputed; ``interpret`` follows the merged best's
    side."""
    merged = dict(disk)
    for key, rec in mine.items():
        other = merged.get(key)
        if other is None:
            merged[key] = rec
            continue
        times = dict(other.get("times", {}))
        for impl, t in rec.get("times", {}).items():
            times[impl] = min(t, times[impl]) if impl in times else t
        best = min(times, key=times.get) if times else rec.get("best")
        interpret = (rec if best in rec.get("times", {})
                     and rec["times"].get(best) == times.get(best)
                     else other).get("interpret")
        merged[key] = {"best": best, "times": times, "interpret": interpret}
    return merged


class TuningCache:
    """Workload key → measured per-impl seconds, persisted as JSON."""

    def __init__(self, path: str | None):
        self.path = path
        self.records: dict[str, dict] = {}
        if path and os.path.exists(path):
            try:
                with open(path) as f:
                    doc = json.load(f)
                if doc.get("version") == _VERSION:
                    self.records = doc.get("records", {})
            except (json.JSONDecodeError, OSError):
                self.records = {}

    def best(self, key: str) -> str | None:
        rec = self.records.get(key)
        return rec.get("best") if rec else None

    def times(self, key: str) -> dict[str, float]:
        rec = self.records.get(key)
        return dict(rec.get("times", {})) if rec else {}

    def put(self, key: str, times: dict[str, float], *,
            interpret: bool) -> str:
        best = min(times, key=times.get)
        self.records[key] = {"best": best, "times": times,
                             "interpret": interpret}
        self.save()
        return best

    def save(self) -> None:
        """Merge with the file on disk, then replace it atomically.

        Two processes sharing one path would otherwise drop each other's
        records: the file is re-read and its records unioned into ours
        (disk-only keys adopted; for keys both sides measured, the per-impl
        times merge at the minimum and ``best`` is recomputed), and the
        merged view becomes ``self.records``. A torn or corrupt file loses
        the merge, not the save."""
        if not self.path:
            return
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        if os.path.exists(self.path):
            try:
                with open(self.path) as f:
                    doc = json.load(f)
                if doc.get("version") == _VERSION:
                    self.records = _merge_records(doc.get("records", {}),
                                                  self.records)
            except (json.JSONDecodeError, OSError):
                pass    # a torn/corrupt file loses the merge, not the save
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump({"version": _VERSION, "records": self.records},
                          f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)


@functools.lru_cache(maxsize=8)
def _cache_for(path: str) -> TuningCache:
    return TuningCache(path)


def default_cache() -> TuningCache | None:
    """The process's cache, from ``$REPRO_TORCH_TUNE_CACHE`` (None when
    unset), memoized per path: the file is parsed once a process, and
    :func:`autotune`'s puts update the memoized instance and the file."""
    path = os.environ.get(ENV_VAR)
    return _cache_for(path) if path else None


def workload_call(w: Workload, *, device, seed: int = 0):
    """``call(impl)``: one forward call of ``impl`` on inputs at exactly
    ``w``'s shapes on ``device``, the inputs of :func:`measure_workload`
    (drawn once, from ``seed``)."""
    import numpy as np
    import torch

    from repro_torch.core.formats import BatchedCOO

    layer = w.channels is not None and w.n_in is not None
    rng = np.random.default_rng(seed)
    dtype = torch.bfloat16 if w.itemsize == 2 else torch.float32

    def t(a, dt=None):
        return torch.as_tensor(a, dtype=dt).to(device)

    def make_coo():
        if w.k_pad is not None and w.nnz_pad <= w.m_pad * w.k_pad:
            base = (np.arange(w.nnz_pad, dtype=np.int64) // w.k_pad) % w.m_pad
            rid = np.stack([
                rng.permutation(w.m_pad).astype(np.int32)[base]
                for _ in range(w.batch)])
        else:
            rid = rng.integers(0, w.m_pad,
                               (w.batch, w.nnz_pad)).astype(np.int32)
        cid = rng.integers(0, w.m_pad, (w.batch, w.nnz_pad)).astype(np.int32)
        return BatchedCOO(
            row_ids=t(rid), col_ids=t(cid),
            values=t(rng.normal(size=(w.batch, w.nnz_pad)), dtype),
            nnz=t(np.full((w.batch,), w.nnz_pad, np.int32)),
            n_rows=t(np.full((w.batch,), w.m_pad, np.int32)))

    if layer:
        from repro_torch.core.graph_conv import graph_conv_batched

        adj = [make_coo() for _ in range(w.channels)]
        x = t(rng.normal(size=(w.batch, w.m_pad, w.n_in)), dtype)
        params = {"w": t(rng.normal(size=(w.channels, w.n_in, w.n_b)),
                         dtype),
                  "b": torch.zeros((w.channels, w.n_b), dtype=dtype,
                                   device=device)}

        def call(impl):
            return graph_conv_batched(params, adj, x, impl=impl,
                                      k_pad=w.k_pad)
    else:
        from repro_torch.kernels.ops import batched_gspmm, batched_spmm

        coo = make_coo()
        b = t(rng.normal(size=(w.batch, w.m_pad, w.n_b)), dtype)
        if w.d_e is not None:
            coo = coo.with_values(
                t(rng.normal(size=(w.batch, w.nnz_pad, w.d_e)), dtype))

        def call(impl):
            if w.is_gspmm:
                return batched_gspmm(coo, b, op=w.op, reduce=w.reduce,
                                     impl=impl, k_pad=w.k_pad)
            return batched_spmm(coo, b, impl=impl, k_pad=w.k_pad)

    return call


def measure_workload(
    w: Workload,
    impls: tuple[str, ...] | None = None,
    *,
    device=None,
    warmup: int = 2,
    iters: int = 10,
    seed: int = 0,
) -> dict[str, float]:
    """Median seconds of one call of each impl on inputs at exactly
    ``w``'s shapes, on ``device`` (the current CUDA device unless the
    caller asks for another).

    The inputs are the reference's: (batch, nnz_pad) COO arrays drawn from
    ``seed`` (every row bounded by ``k_pad`` where the ELL class can hold
    the workload, so that every impl computes the same product), B
    (batch, m_pad, n_b), bfloat16 where ``itemsize`` is 2. A LAYER
    workload is timed as one whole ``graph_conv_batched`` call, a g-SpMM
    workload as one ``batched_gspmm`` call of its (op, reduce) with
    ``d_e``-wide vector edges where ``d_e`` is set. Each call runs under
    ``torch.inference_mode()``; on the card it is timed from one
    ``torch.cuda.synchronize()`` to the next: ``iters`` calls of each
    candidate in a row after ``warmup`` (more than the reference's 5 after
    1: the card's host is shared and its pace noisy).

    With ``impls=None`` the candidates are those the model ranks on this
    device, less the ELL class where it cannot hold the workload; an ELL
    impl asked for by name on such a workload raises. A candidate that
    raises while it runs raises here: it does not vanish from the
    record."""
    import time

    import numpy as np
    import torch

    from repro_torch import resolve_device

    device = resolve_device(device)
    on_card = device.type == "cuda"
    layer = w.channels is not None and w.n_in is not None
    ell_lossy = (w.k_pad is not None and w.nnz_pad > w.m_pad * w.k_pad)
    if impls is None:
        ranked = (rank_layer if layer else rank)(w, allow_pallas=on_card)
        impls = tuple(i for i, _ in ranked)
        if ell_lossy:
            impls = tuple(i for i in impls
                          if precision_of(i)[0] not in ("ell", "pallas_ell"))
    elif ell_lossy and any(precision_of(i)[0] in ("ell", "pallas_ell")
                           for i in impls):
        raise ValueError(
            f"workload {w.key()}: nnz_pad={w.nnz_pad} > m_pad*k_pad="
            f"{w.m_pad * w.k_pad} — the requested ELL impl(s) cannot "
            "represent it losslessly, so their timings would be bogus")

    call = workload_call(w, device=device, seed=seed)

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    times: dict[str, float] = {}
    with torch.inference_mode():
        for impl in impls:
            for _ in range(warmup):
                call(impl)
            sync()
            ts = []
            for _ in range(iters):
                t0 = time.perf_counter()
                call(impl)
                sync()
                ts.append(time.perf_counter() - t0)
            times[impl] = float(np.median(ts))
    return times


def autotune(
    w: Workload,
    *,
    cache: TuningCache,
    impls: tuple[str, ...] | None = None,
    device=None,
    refresh: bool = False,
) -> str:
    """Measured-best impl for ``w``, memoized in ``cache``: a record
    already there answers without measuring unless ``refresh``."""
    key = w.key()
    if not refresh:
        best = cache.best(key)
        if best is not None:
            return best
    from repro_torch import resolve_device

    device = resolve_device(device)
    times = measure_workload(w, impls, device=device)
    if not times:
        raise RuntimeError(f"no candidate impl ran for workload {key}")
    return cache.put(key, times, interpret=device.type != "cuda")
