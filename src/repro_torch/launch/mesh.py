"""Device meshes over ``torch.distributed`` (the reference's ``launch/mesh.py``)
and the few collectives the mesh paths use.

The reference is single-controller: one process holds a ``jax.sharding.Mesh``
of every device. The port is multi-controller: one process per rank, each
joined to one process group (:func:`init_ranks`), and a
``torch.distributed.device_mesh.DeviceMesh`` over that group
(:func:`make_mesh`). Every rank runs the same program on the same global
inputs; the sharded ops of ``repro_torch.distributed.spmm`` split the work
by the rank's place on the mesh's ``"data"`` axis.

Backend (:func:`pick_backend`): NCCL when each rank has a card of its own;
gloo when ranks share a card (NCCL refuses two ranks on one GPU) and on the
CPU. The collectives below hand NCCL the device tensor. Under gloo, when
every rank of the world shares one card, they exchange through that card:
each rank's window (a device buffer) is mapped into every other rank by
CUDA IPC (:func:`init_ranks` opens them), a rank writes its part into its
own window, and after a host barrier every rank copies every part out;
otherwise they stage a CUDA tensor through the host for gloo. The mesh
paths use only :func:`all_gather_cat`, :func:`all_reduce_sum`,
:func:`all_reduce_max`, :func:`reduce_scatter` (a sum, then this rank's
slice), :func:`broadcast` and :func:`barrier` (an all-reduce); the sums of
the windows run in f32 in rank order, the same on every rank. A collective
over an axis of one rank returns a copy of its input and calls nothing.
:func:`close_ranks` unmaps the windows and leaves the group.
"""
from __future__ import annotations

import math
import socket

import torch
import torch.distributed as dist

# the bytes of each rank's window: a larger part goes through in pieces
WINDOW_BYTES = 1 << 28
# this process's (own window, every rank's window by global rank) while
# every rank of the world shares this card, else empty (init_ranks,
# close_ranks)
_WINDOWS: list = []


def pick_backend(world_size: int, device_type: str = "cuda") -> str:
    """``"nccl"`` when every rank can have a CUDA card of its own, else
    ``"gloo"`` (ranks sharing a card, or CPU ranks)."""
    if (device_type == "cuda" and dist.is_nccl_available()
            and torch.cuda.device_count() >= world_size):
        return "nccl"
    return "gloo"


def init_ranks(rank: int, world_size: int, init_method: str, *,
               device_type: str = "cuda") -> str:
    """Join this process to the default process group as ``rank`` of
    ``world_size`` (``init_method``: ``"tcp://localhost:<port>"`` or
    ``"file://<path>"``), with :func:`pick_backend`'s backend; a CUDA rank
    first takes card ``rank % device_count``. Returns the backend."""
    backend = pick_backend(world_size, device_type)
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    if device_type == "cuda" and backend == "gloo":
        _open_windows()
    return backend


def _open_windows() -> None:
    """Map every rank's window into this one (CUDA IPC) when every rank of
    the world runs on this host's same card; else every rank keeps the
    host path. Raises on every rank when the ranks share the card but one
    could not map the others' windows."""
    from torch.multiprocessing.reductions import (
        rebuild_cuda_tensor,
        reduce_tensor,
    )

    dev = torch.cuda.current_device()
    mine = torch.empty(WINDOW_BYTES, dtype=torch.uint8, device=dev)
    props = torch.cuda.get_device_properties(dev)
    where = (socket.gethostname(), str(getattr(props, "uuid", dev)))
    infos = [None] * dist.get_world_size()
    dist.all_gather_object(infos, (where, reduce_tensor(mine)[1]))
    if not all(w == where for w, _ in infos):
        return
    me, windows, why = dist.get_rank(), None, ""
    try:
        windows = [mine if r == me else rebuild_cuda_tensor(*args)
                   for r, (_, args) in enumerate(infos)]
    except RuntimeError as e:       # CUDA refused the mapping
        why = str(e)
    failed = [None] * len(infos)
    dist.all_gather_object(failed, why)
    if any(failed):                 # the same outcome on every rank
        raise RuntimeError("the ranks share one card but could not map "
                           f"each other's windows (CUDA IPC): {failed}")
    _WINDOWS[:] = [mine, windows]


def transport() -> str:
    """How this process's collectives move CUDA tensors: ``"windows"``
    (CUDA IPC through the shared card) or the default group's backend."""
    return "windows" if _WINDOWS else dist.get_backend()


def close_ranks() -> None:
    """Unmap the windows (every rank first lets go of the others'), then
    leave the process group."""
    if _WINDOWS:
        _WINDOWS.clear()
        torch.cuda.synchronize()
        dist.barrier()
    dist.destroy_process_group()


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the process group in
    place (every rank of the world, in rank order); ``device_type`` is
    ``"cuda"`` unless the caller asks for ``"cpu"``. As in the reference,
    the rules of the sharded paths re-evaluate against any mesh shape, so
    a restart on another world size builds another mesh and goes on."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "init_ranks (or init_process_group) first")
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"mesh shape {tuple(shape)} holds "
                         f"{math.prod(shape)} ranks, the world has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The reference's production shapes: 16×16 ("data", "model"), or
    2×16×16 with a leading "pod" axis. Raises when the world is smaller
    than the mesh, as the reference does with too few devices; a larger
    world is refused too (a DeviceMesh spans the whole process group)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < need:
        raise RuntimeError(
            f"production mesh needs {need} devices, have {have} — the "
            "multi-pod dry-run is not ported yet (ROADMAP.md queue 1: "
            "launch/dryrun)")
    return make_mesh(shape, axes, device_type=device_type)


def mesh_device(mesh) -> torch.device:
    """The device this rank computes on under ``mesh``: the CPU for a CPU
    mesh, else card ``rank % device_count``."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device(mesh.device_type,
                        dist.get_rank() % torch.cuda.device_count())


def check_device(mesh, device) -> torch.device:
    """``device`` for an entry point under ``mesh``: the mesh's
    (:func:`mesh_device`) when None; raises when the caller's disagrees,
    and when ``mesh`` is not a ``DeviceMesh``."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh= takes a torch.distributed DeviceMesh "
                        f"(launch.mesh.make_mesh), got {type(mesh).__name__}")
    want = mesh_device(mesh)
    if device is None:
        return want
    got = torch.device(device)
    if got.type == "cuda" == want.type and got.index is None:
        got = torch.device("cuda", torch.cuda.current_device())
    if got != want:
        raise ValueError(f"device={got} conflicts with the mesh: this rank "
                         f"computes on {want}")
    return got


def _host_staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _exchange(flat: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``flat`` (1-D, the same size on every rank of
    ``group``) in group rank order, through the card's windows: a piece
    of at most WINDOW_BYTES at a time, each rank writing its own window,
    a barrier, every rank reading every window, a barrier."""
    mine, windows = _WINDOWS
    ranks = dist.get_process_group_ranks(group)
    src = flat.view(torch.uint8)
    outs = [torch.empty_like(src) for _ in ranks]
    stream = torch.cuda.current_stream()
    for lo in range(0, src.numel(), mine.numel()):
        n = min(mine.numel(), src.numel() - lo)
        mine[:n].copy_(src[lo:lo + n])
        stream.synchronize()
        dist.barrier(group=group)           # every part written
        for out, r in zip(outs, ranks):
            out[lo:lo + n].copy_(windows[r][:n])
        stream.synchronize()
        dist.barrier(group=group)           # every part read
    return [o.view(flat.dtype) for o in outs]


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate on ``mesh[axis]``."""
    return mesh.get_local_rank(axis)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def all_gather_cat(t: torch.Tensor, mesh, axis: str = "data",
                   dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` along ``mesh[axis]``, concatenated on ``dim`` in
    rank order (the same shape on every rank)."""
    if axis_size(mesh, axis) == 1:
        return t.detach().clone()
    group = mesh.get_group(axis)
    src = t.detach().contiguous()
    if src.is_cuda and _WINDOWS:
        return torch.cat([p.view(src.shape) for p in _exchange(
            src.reshape(-1), group)], dim=dim)
    if _host_staged(src, group):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def _all_reduce(t: torch.Tensor, mesh, axis: str, op,
                dtype: torch.dtype) -> torch.Tensor:
    if t.is_cuda and _WINDOWS and axis_size(mesh, axis) > 1:
        parts = _exchange(t.detach().contiguous().reshape(-1),
                          mesh.get_group(axis))
        acc = parts[0].to(dtype)
        for p in parts[1:]:                  # rank order
            acc = (acc + p.to(dtype) if op == dist.ReduceOp.SUM
                   else torch.maximum(acc, p.to(dtype)))
        return acc.view(t.shape).to(t.dtype)
    buf = t.detach().to(dtype, copy=True).contiguous()
    if axis_size(mesh, axis) > 1:
        group = mesh.get_group(axis)
        if _host_staged(buf, group):
            buf = buf.cpu()
        dist.all_reduce(buf, op=op, group=group)
    return buf.to(device=t.device, dtype=t.dtype)


def all_reduce_sum(t: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """The sum of every rank's ``t`` along ``mesh[axis]`` (a new tensor),
    reduced in f32 and returned in ``t``'s dtype."""
    return _all_reduce(t, mesh, axis, dist.ReduceOp.SUM, torch.float32)


def all_reduce_max(t: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """The elementwise max of every rank's ``t`` along ``mesh[axis]`` (a
    new tensor of ``t``'s dtype: a max rounds nothing)."""
    return _all_reduce(t, mesh, axis, dist.ReduceOp.MAX, t.dtype)


def reduce_scatter(t: torch.Tensor, mesh, axis: str = "data",
                   dim: int = 0) -> torch.Tensor:
    """This rank's slice on ``dim`` (rank order along ``mesh[axis]``) of
    the sum of every rank's ``t``: :func:`all_reduce_sum`, then the slice
    (gloo has no reduce-scatter)."""
    n = axis_size(mesh, axis)
    full = all_reduce_sum(t, mesh, axis)
    return full.chunk(n, dim=dim)[axis_rank(mesh, axis)].clone()


def broadcast(t: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """Rank 0 of ``mesh[axis]``'s ``t`` on every rank (a new tensor of
    ``t``'s shape, dtype and device)."""
    buf = t.detach().clone().contiguous()
    if axis_size(mesh, axis) == 1:
        return buf
    group = mesh.get_group(axis)
    if buf.is_cuda and _WINDOWS:
        return _exchange(buf.reshape(-1), group)[0].view(buf.shape)
    if _host_staged(buf, group):
        buf = buf.cpu()
    dist.broadcast(buf, src=dist.get_global_rank(group, 0), group=group)
    return buf.to(t.device)


def barrier(mesh, axis: str | None = None) -> None:
    """Return once every rank of ``mesh[axis]`` (every rank of the mesh
    when ``axis`` is None) has reached this call (the host waits for the
    all-reduces' result)."""
    t = torch.zeros(1, device=mesh_device(mesh))
    for a in (mesh.mesh_dim_names if axis is None else (axis,)):
        t = all_reduce_sum(t, mesh, a)
    t.item()
