"""Ragged grouped matmul: ``out[i] = x[i] @ w[g(i)]`` for rows sorted by
group, with ragged group sizes — the batch of small matmuls of differing
sizes that the paper batches into one kernel, here R-GCN's per-relation
transforms (``models/gnn.rgcn_layer``).

The kernel is ``csrc/grouped_matmul.cu`` (the batched GEMM's f32 mainloop,
K through a ``cp.async`` ring, whose row tiles make one pass per group they
hold; :func:`gmm_tile` picks the tile); the plain version is
:func:`repro_torch.kernels.ref.grouped_matmul_ref`. :func:`grouped_matmul`
is differentiable in ``x`` and ``w`` with the reference's VJP: ``dx`` is the
same kernel against the transposed weights, ``dw[g] = Σ_{i∈g} x[i]ᵀ ·
dout[i]`` a one-hot grouped einsum (plain in the reference too); each is
computed only when asked for. Rows past ``sum(group_sizes)`` belong to group
``E - 1`` in both directions.

As in the reference, a ``tm``-row tile (128) visits at most
``max_groups_per_tile`` (4) groups, the first row's group and the next
three: the rows of any later group in that tile come out 0, in the forward
and in ``dx``; ``dw`` is not masked (:func:`_visited_groups`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, check_operand, on_cpu, ref, \
    stream_handle

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P,) * 4 + (_I,) * 8 + (_P,)

THREAD_ROWS = 8         # rows a thread holds
TILE_GROUPS = 8         # row groups of 16 threads: 64-row tiles


def gmm_tile(m: int, n: int) -> tuple[int, int]:
    """The kernel's tile ``(row groups, columns a thread)``, 8 rows a
    thread: 8 row groups (64-row tiles), or ``ceil(m / 8)`` below 64 rows;
    4 columns a thread (64-column panels) up to n 64, 8 past it
    (128-column panels). Of the tiles the kernel takes (4, 8 or 16 row
    groups; 4 or 8 columns), 64 x 64 was the fastest at N 64 (M 11,200 and
    28,672) in every run; at N 512 the fastest tile moved from card to
    card, this one within 10% of it (``scripts/gmm_tiles.py``, PERF.md)."""
    return min(TILE_GROUPS, -(-m // THREAD_ROWS)), 4 if n <= 64 else 8


def _row_groups(group_sizes: torch.Tensor, m: int, e: int) -> torch.Tensor:
    """(m,) int32 group of each row from the ragged sizes, on their device
    with no host sync: a search over the cumulative sizes, rows past the
    last boundary clamped to group ``e - 1``."""
    starts = torch.cumsum(group_sizes.to(torch.int64), 0)
    rows = torch.arange(m, device=group_sizes.device)
    return torch.searchsorted(starts, rows, right=True).clamp(
        max=e - 1).to(torch.int32)


def _visited_groups(row_group: torch.Tensor, tm: int,
                    max_groups_per_tile: int) -> torch.Tensor:
    """``row_group`` with -1 for every row that the reference's kernel
    leaves 0: a row whose group lies ``max_groups_per_tile`` or more past
    the group of the first row of its ``tm``-row tile (groups ascend down
    the rows)."""
    m = row_group.shape[0]
    first = (torch.arange(m, device=row_group.device) // tm) * tm
    keep = row_group - row_group[first] < max_groups_per_tile
    return torch.where(keep, row_group, -1).to(torch.int32)


def _gmm(x: torch.Tensor, w: torch.Tensor, row_group: torch.Tensor, *,
         tm: int = 128, max_groups_per_tile: int = 4) -> torch.Tensor:
    """The kernel's wrapper: x (M, K) f32 rows sorted by group, w (E, K, N)
    f32, row_group (M,) int32 → (M, N) f32, the rows that a ``tm``-row tile
    of the reference does not visit 0 (:func:`_visited_groups`; the kernel
    applies the same rule as it stages a tile)."""
    if x.dim() != 2 or w.dim() != 3:
        raise ValueError("_gmm takes a 2-D x and a 3-D w")
    m, k = x.shape
    e, _, n = w.shape
    check_operand("x", x, (m, k), torch.float32)
    check_operand("w", w, (e, k, n), torch.float32)
    check_operand("row_group", row_group, (m,), torch.int32)
    if tm < 1 or max_groups_per_tile < 1:
        raise ValueError(f"tm={tm} and max_groups_per_tile="
                         f"{max_groups_per_tile} must be positive")
    if on_cpu(x, w, row_group):
        return ref.grouped_matmul_ref(
            x, _visited_groups(row_group, tm, max_groups_per_tile), w)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0 or e == 0 or k == 0:
        return out.zero_()
    fn = _build.entry("grouped_matmul", "grouped_matmul_f32", _ARGTYPES)
    code = fn(x.data_ptr(), w.data_ptr(), row_group.data_ptr(),
              out.data_ptr(), m, k, n, e, tm, max_groups_per_tile,
              *gmm_tile(m, n), stream_handle())
    _build.check("grouped_matmul", code)
    _gmm.launches += 1
    return out


_gmm.launches = 0


class _GroupedMatmul(torch.autograd.Function):
    """``_gmm`` with the reference's custom VJP."""

    @staticmethod
    def forward(ctx, x, w, row_group, tm, max_groups_per_tile):
        ctx.save_for_backward(x, w, row_group)
        ctx.tiling = dict(tm=tm, max_groups_per_tile=max_groups_per_tile)
        return _gmm(x, w, row_group, **ctx.tiling)

    @staticmethod
    def backward(ctx, dout):
        x, w, row_group = ctx.saved_tensors
        dout = dout.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _gmm(dout, w.transpose(1, 2).contiguous(), row_group,
                      **ctx.tiling)
        if ctx.needs_input_grad[1]:
            onehot = torch.nn.functional.one_hot(
                row_group.long(), w.shape[0]).to(torch.float32)
            dw = torch.einsum("me,mk,mn->ekn", onehot, x.float(),
                              dout.float()).to(w.dtype)
        return dx, dw, None, None, None


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   group_sizes: torch.Tensor, *, tm: int = 128,
                   max_groups_per_tile: int = 4) -> torch.Tensor:
    """``out[i] = x[i] @ w[group_of(i)]`` with rows pre-sorted by group:
    x (M, K), w (E, K, N), group_sizes (E,) int32 with sum ≤ M (rows past
    it go to group E - 1); a ``tm``-row tile visits at most
    ``max_groups_per_tile`` groups, as in the reference. Differentiable in
    ``x`` and ``w``."""
    row_group = _row_groups(group_sizes, x.shape[0], w.shape[0])
    return _GroupedMatmul.apply(x.contiguous(), w.contiguous(), row_group,
                                tm, max_groups_per_tile)


def sort_by_group(eids: torch.Tensor, e: int):
    """Stable sort of token slots by group: (order, group_sizes (e,)
    int32)."""
    order = torch.sort(eids, stable=True).indices
    sizes = torch.zeros((e,), dtype=torch.int32, device=eids.device)
    sizes.index_add_(0, eids.long(), torch.ones_like(eids, dtype=torch.int32))
    return order, sizes
