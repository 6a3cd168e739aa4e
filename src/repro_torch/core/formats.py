"""Batched sparse-matrix containers (paper §II-B), as dataclasses of tensors.

Every matrix of a batch is padded to the batch maxima (``m_pad`` rows,
``nnz_pad`` non-zeros, ``k_pad`` non-zeros per row for ELL). Padded slots
carry value 0.0 and index 0, so under (mul, sum) they contribute nothing —
the paper's §IV-C "launch for the max and let the extra threads idle"
policy. The conversions run on whatever device the tensors are on and are
bitwise equal to the reference's for the same input.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# Largest index an int16 id array can hold. The COO kernels pad row ids
# with the sentinel ``m_pad`` (one past the last row), so the narrowing
# guard needs ``m_pad`` itself, not only ``m_pad - 1``, to fit.
INT16_MAX = 32767


def narrow_col_ids(ids: torch.Tensor, m_pad: int) -> torch.Tensor:
    """Narrow an id array to int16 storage, the reduced-precision kernels'
    index width. ``m_pad`` is the exclusive bound and the COO padding
    sentinel, so the guard is on ``m_pad`` itself; it is a shape, so an
    overflow raises on the host instead of wrapping negative."""
    if m_pad > INT16_MAX:
        raise ValueError(
            f"m_pad={m_pad} does not fit int16 column indices (max "
            f"{INT16_MAX} including the m_pad padding sentinel): use a "
            "full-precision impl for this geometry")
    return ids.to(torch.int16)


def quantize_values_i8(values: torch.Tensor):
    """Per-matrix symmetric int8 quantization of a batched values array,
    the reference's arithmetic: ``scale = maxabs / 127`` in f32 (1.0 for
    an all-zero matrix), ``codes = round(values / scale)`` rounding half to
    even. Returns ``(codes, scale)``: int8 codes of the input's shape and
    a (batch,) f32 scale with ``codes * scale ≈ values``. Padded 0.0 slots
    quantize to code 0. SpMM is linear in the values, so the kernels apply
    the scale once to the f32 accumulator after the reduction."""
    v = values.float()
    maxabs = v.abs().amax(dim=tuple(range(1, v.dim())))
    scale = torch.where(maxabs > 0, maxabs / 127.0,
                        torch.ones_like(maxabs))
    codes = torch.round(v / scale.view((-1,) + (1,) * (v.dim() - 1)))
    return codes.to(torch.int8), scale


@dataclasses.dataclass(frozen=True)
class BatchedCOO:
    """SparseTensor/COO analogue: flat non-zero triples, padded to nnz_pad.

    row_ids, col_ids : (batch, nnz_pad) int32  — padding points at row/col 0
    values           : (batch, nnz_pad) float  — padding is 0.0; g-SpMM
                       vector edges are (batch, nnz_pad, d_e)
    nnz              : (batch,) int32          — true nnz per matrix
    n_rows           : (batch,) int32          — true m_A per matrix
    """

    row_ids: torch.Tensor
    col_ids: torch.Tensor
    values: torch.Tensor
    nnz: torch.Tensor
    n_rows: torch.Tensor

    @property
    def batch(self) -> int:
        return self.values.shape[0]

    @property
    def nnz_pad(self) -> int:
        return self.values.shape[1]

    def with_values(self, values: torch.Tensor) -> "BatchedCOO":
        return dataclasses.replace(self, values=values)

    def to(self, device) -> "BatchedCOO":
        return BatchedCOO(*(t.to(device) for t in dataclasses.astuple(self)))

    def transpose(self, m_pad: int) -> "BatchedCOO":
        """Aᵀ for the backward pass (paper §IV-D): in COO, the index arrays
        swapped. ``m_pad`` is unused, as in the reference."""
        del m_pad
        return dataclasses.replace(self, row_ids=self.col_ids,
                                   col_ids=self.row_ids)


@dataclasses.dataclass(frozen=True)
class BatchedELL:
    """Row-padded ELL, the layout of the row-split (SWA-CSR) kernel.

    col_ids : (batch, m_pad, k_pad) int32  — padding points at column 0
    values  : (batch, m_pad, k_pad[, d_e]) float  — padding is 0.0
    n_rows  : (batch,) int32
    """

    col_ids: torch.Tensor
    values: torch.Tensor
    n_rows: torch.Tensor


@dataclasses.dataclass(frozen=True)
class BatchedCSR:
    """CSR over padded rows (paper Fig. 1/4), the layout of the row-split
    CSR kernel.

    rpt     : (batch, m_pad + 1) int32 — row r owns slots rpt[r]..rpt[r+1]
    col_ids : (batch, nnz_pad) int32   — row-sorted; padding at the tail
    values  : (batch, nnz_pad[, d_e]) float
    n_rows  : (batch,) int32
    """

    rpt: torch.Tensor
    col_ids: torch.Tensor
    values: torch.Tensor
    n_rows: torch.Tensor

    @property
    def batch(self) -> int:
        return self.values.shape[0]

    @property
    def m_pad(self) -> int:
        return self.rpt.shape[1] - 1

    @property
    def nnz_pad(self) -> int:
        return self.values.shape[1]

    @property
    def nnz(self) -> torch.Tensor:
        """(batch,) int32 — true nnz per matrix: ``rpt``'s last entry counts
        exactly the valid slots."""
        return self.rpt[:, -1]


def coo_from_lists(
    triples: Sequence[tuple[np.ndarray, np.ndarray, np.ndarray]],
    n_rows: Sequence[int],
    *,
    nnz_pad: int | None = None,
) -> BatchedCOO:
    """Build a host (CPU) BatchedCOO from per-sample (rows, cols, vals)
    numpy triples; move it with :meth:`BatchedCOO.to`."""
    batch = len(triples)
    max_nnz = max((len(t[0]) for t in triples), default=1)
    nnz_pad = nnz_pad or max(1, _round_up(max_nnz, 8))
    rid = np.zeros((batch, nnz_pad), np.int32)
    cid = np.zeros((batch, nnz_pad), np.int32)
    val = np.zeros((batch, nnz_pad), np.float32)
    nnz = np.zeros((batch,), np.int32)
    for b, (r, c, v) in enumerate(triples):
        k = len(r)
        rid[b, :k], cid[b, :k], val[b, :k] = r, c, v
        nnz[b] = k
    return BatchedCOO(
        row_ids=torch.from_numpy(rid),
        col_ids=torch.from_numpy(cid),
        values=torch.from_numpy(val),
        nnz=torch.from_numpy(nnz),
        n_rows=torch.from_numpy(np.asarray(n_rows, np.int32)),
    )


def _valid_slots(coo: BatchedCOO) -> torch.Tensor:
    """(batch, nnz_pad) bool — True on the first ``nnz`` slots of each row."""
    slot = torch.arange(coo.nnz_pad, device=coo.nnz.device)
    return slot[None, :] < coo.nnz[:, None]


def _gather_slots(values: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """``values[s, order[s, i]]`` along the slot axis, for scalar edges
    (batch, nnz_pad) and vector edges (batch, nnz_pad, d_e) alike."""
    idx = order.view(order.shape + (1,) * (values.dim() - 2))
    return torch.gather(values, 1, idx.expand(order.shape + values.shape[2:]))


def row_degrees(coo: BatchedCOO, m_pad: int) -> torch.Tensor:
    """(batch, m_pad) int32 — the true per-row non-zero count of each sample
    (only valid slots counted; row ids clipped into range as the reference
    does)."""
    idx = coo.row_ids.long().clamp(0, m_pad - 1)
    deg = torch.zeros((coo.batch, m_pad), dtype=torch.int32,
                      device=coo.row_ids.device)
    return deg.scatter_add_(1, idx, _valid_slots(coo).to(torch.int32))


def max_row_degree(coo: BatchedCOO, m_pad: int) -> torch.Tensor:
    """(batch,) int32 — the true max nnz in any single row of each sample:
    the statistic ``k_pad`` must cover for a lossless ELL conversion."""
    return row_degrees(coo, m_pad).amax(dim=1)


def validate_ell_k_pad(coo: BatchedCOO, m_pad: int, k_pad: int) -> None:
    """Raise when any row holds more than ``k_pad`` non-zeros (``coo_to_ell``
    would zero the overflow out and the product would be silently wrong).

    The worst degree is reduced on the tensors' device and read back with
    one ``.item()``: on the GPU that is one device-to-host sync per call."""
    worst = int(max_row_degree(coo, m_pad).max().item()) if coo.batch else 0
    if worst > k_pad:
        raise ValueError(
            f"k_pad={k_pad} is smaller than the batch's true max row degree "
            f"{worst}: the ELL conversion would silently zero out "
            f"{worst - k_pad} non-zero(s) in the worst row. Size k_pad from "
            "the batch maximum (repro_torch.core.formats.max_row_degree) or "
            "pick the COO impl, which has no per-row bound.")


def coo_to_ell(coo: BatchedCOO, m_pad: int, k_pad: int) -> BatchedELL:
    """COO → ELL on the tensors' device: a stable sort by row id and a
    running segment start give each non-zero its slot within its row. Rows
    with more than ``k_pad`` non-zeros drop the excess, so callers size
    ``k_pad`` from the true max row degree (:func:`validate_ell_k_pad`)."""
    batch, nnz_pad = coo.row_ids.shape
    dev = coo.row_ids.device
    slot = torch.arange(nnz_pad, device=dev).expand(batch, nnz_pad)
    valid = _valid_slots(coo)
    rid_eff = torch.where(valid, coo.row_ids.long(), m_pad)
    rid_s, order = torch.sort(rid_eff, dim=1, stable=True)
    cid_s = torch.gather(coo.col_ids, 1, order)
    val_s = _gather_slots(coo.values, order)
    valid_s = torch.gather(valid, 1, order)
    # position within row = slot - first slot of this row
    is_start = torch.ones_like(valid_s)
    is_start[:, 1:] = rid_s[:, 1:] != rid_s[:, :-1]
    seg_start = torch.cummax(torch.where(is_start, slot, 0), dim=1).values
    k_in_row = slot - seg_start
    ok = valid_s & (rid_s >= 0) & (rid_s < m_pad) & (k_in_row < k_pad)
    flat = torch.where(ok, rid_s * k_pad + k_in_row, m_pad * k_pad)
    col = torch.zeros((batch, m_pad * k_pad + 1), dtype=coo.col_ids.dtype,
                      device=dev)
    col.scatter_(1, flat, torch.where(ok, cid_s, 0))
    tail = tuple(coo.values.shape[2:])
    val = torch.zeros((batch, m_pad * k_pad + 1) + tail,
                      dtype=coo.values.dtype, device=dev)
    ok_v = ok.view(ok.shape + (1,) * len(tail))
    val.scatter_(1, flat.view(flat.shape + (1,) * len(tail)).expand(
        val_s.shape), torch.where(ok_v, val_s, 0))
    shape = (batch, m_pad, k_pad)
    return BatchedELL(col_ids=col[:, :-1].contiguous().view(shape),
                      values=val[:, :-1].contiguous().view(shape + tail),
                      n_rows=coo.n_rows)


def coo_to_csr(coo: BatchedCOO, m_pad: int) -> BatchedCSR:
    """COO → CSR on the tensors' device: slots at or past ``nnz`` go to row
    ``m_pad``, a stable sort by row id sends them to the tail, and ``rpt`` is
    rebuilt from the counts of valid slots."""
    valid = _valid_slots(coo)
    rid_eff = torch.where(valid, coo.row_ids, m_pad)
    rid_s, order = torch.sort(rid_eff, dim=1, stable=True)
    # the reference's scatter indexes numpy-style: a negative row id wraps,
    # and one still out of range is dropped
    idx = rid_s.clamp(max=m_pad)
    idx = torch.where(idx < 0, idx + m_pad + 1, idx)
    keep = torch.gather(valid, 1, order) & (idx >= 0)
    counts = torch.zeros((coo.batch, m_pad + 1), dtype=torch.int32,
                         device=rid_s.device)
    counts.scatter_add_(1, idx.clamp(min=0).long(), keep.to(torch.int32))
    rpt = torch.zeros((coo.batch, m_pad + 1), dtype=torch.int32,
                      device=rid_s.device)
    rpt[:, 1:] = torch.cumsum(counts[:, :m_pad], dim=1)
    return BatchedCSR(rpt=rpt, col_ids=torch.gather(coo.col_ids, 1, order),
                      values=_gather_slots(coo.values, order),
                      n_rows=coo.n_rows)


def csr_slot_rows(rpt: torch.Tensor, nnz_pad: int) -> torch.Tensor:
    """(batch, nnz_pad) int32 — the row that owns each slot, from a search of
    ``rpt``; slots past the last row clip to row ``m_pad - 1`` (callers mask
    them with ``slot < rpt[:, -1]``)."""
    slot = torch.arange(nnz_pad, dtype=torch.int32, device=rpt.device)
    rows = torch.searchsorted(rpt, slot.expand(rpt.shape[0], nnz_pad)
                              .contiguous(), right=True, out_int32=True) - 1
    return rows.clamp(0, rpt.shape[1] - 2)


def csr_transpose(csr: BatchedCSR, n_cols: int | None = None) -> BatchedCSR:
    """Aᵀ in CSR for the backward pass: expand ``rpt`` back to per-slot row
    ids, swap them with the column ids, and re-sort through
    :func:`coo_to_csr` over ``n_cols`` rows (square by default)."""
    coo_t = BatchedCOO(row_ids=csr.col_ids,
                       col_ids=csr_slot_rows(csr.rpt, csr.nnz_pad),
                       values=csr.values, nnz=csr.nnz, n_rows=csr.n_rows)
    return coo_to_csr(coo_t, n_cols or csr.m_pad)


def coo_to_dense(coo: BatchedCOO, m_pad: int,
                 n_cols: int | None = None) -> torch.Tensor:
    """Densify the batch of adjacency matrices (the gemmBatched baseline,
    paper §V-A). Invalid slots and out-of-range ids add nothing."""
    n_cols = n_cols or m_pad
    rid, cid = coo.row_ids.long(), coo.col_ids.long()
    ok = (_valid_slots(coo) & (rid >= 0) & (rid < m_pad)
          & (cid >= 0) & (cid < n_cols))
    cells = m_pad * n_cols
    base = torch.arange(coo.batch, device=rid.device)[:, None] * (cells + 1)
    flat = base + torch.where(ok, rid * n_cols + cid, cells)
    out = torch.zeros(coo.batch * (cells + 1), dtype=coo.values.dtype,
                      device=rid.device)
    out.index_add_(0, flat.reshape(-1),
                   torch.where(ok, coo.values, 0).reshape(-1))
    return out.view(coo.batch, cells + 1)[:, :cells].reshape(
        coo.batch, m_pad, n_cols)


def random_batch(rng: np.random.Generator, *, batch: int,
                 dim: int | tuple[int, int],
                 nnz_per_row: int | tuple[int, int]) -> tuple[BatchedCOO, int]:
    """Random square sparse matrices with self-loops following the paper's
    §V-A generator (the reference's ``random_batch``: same draws from the
    same ``rng``). Returns (BatchedCOO, m_pad)."""
    dims = (dim, dim) if isinstance(dim, int) else dim
    ks = (nnz_per_row,) * 2 if isinstance(nnz_per_row, int) else nnz_per_row
    triples, n_rows = [], []
    for _ in range(batch):
        m = int(rng.integers(dims[0], dims[1] + 1))
        k = int(rng.integers(ks[0], ks[1] + 1))
        rows, cols = [], []
        for r in range(m):
            cs = rng.choice(m, size=min(k, m), replace=False).tolist()
            rows.extend([r] * len(cs))
            cols.extend(cs)
            if r not in cs:
                rows.append(r)
                cols.append(r)
        triples.append((np.asarray(rows, np.int32), np.asarray(cols, np.int32),
                        np.ones(len(rows), np.float32)))
        n_rows.append(m)
    m_pad = _round_up(max(n_rows), 8)
    return coo_from_lists(triples, n_rows), m_pad


def powerlaw_degrees(rng: np.random.Generator, n: int, avg_deg: float,
                     alpha: float = 1.2) -> np.ndarray:
    """(n,) int64 truncated power-law degrees, ``deg_r ∝ (r+1)^-alpha``
    rescaled to mean ≈ ``avg_deg``, capped at ``n`` and shuffled so hubs
    land on random ids (the reference's recipe and draws)."""
    w = (np.arange(n, dtype=np.float64) + 1.0) ** -alpha
    deg = np.minimum(
        np.maximum(np.rint(w * (avg_deg * n / w.sum())), 0.0), n
    ).astype(np.int64)
    rng.shuffle(deg)
    return deg


def random_powerlaw_batch(rng: np.random.Generator, *, batch: int,
                          dim: int | tuple[int, int], avg_deg: float,
                          alpha: float = 1.2,
                          self_loops: bool = True) -> tuple[BatchedCOO, int]:
    """Degree-skewed square sparse matrices with :func:`powerlaw_degrees`
    rows — a few hub rows hold a large share of the non-zeros, the regime
    the hybrid split is for. The reference's ``random_powerlaw_batch``: the
    same draws from the same ``rng``. Returns (BatchedCOO, m_pad)."""
    dims = (dim, dim) if isinstance(dim, int) else dim
    triples, n_rows = [], []
    for _ in range(batch):
        m = int(rng.integers(dims[0], dims[1] + 1))
        deg = powerlaw_degrees(rng, m, avg_deg, alpha)
        rows, cols = [], []
        for r in range(m):
            cs = rng.choice(m, size=int(deg[r]), replace=False).tolist()
            rows.extend([r] * len(cs))
            cols.extend(cs)
            if self_loops and r not in cs:
                rows.append(r)
                cols.append(r)
        triples.append((np.asarray(rows, np.int32), np.asarray(cols, np.int32),
                        np.ones(len(rows), np.float32)))
        n_rows.append(m)
    m_pad = _round_up(max(n_rows), 8)
    return coo_from_lists(triples, n_rows), m_pad
