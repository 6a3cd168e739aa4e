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
CPU. Gloo's collectives take host tensors here: :func:`all_gather_cat`,
:func:`all_reduce_sum` and :func:`broadcast` stage a CUDA tensor through
the host under gloo and hand NCCL the device tensor. Only these three
collectives (and :func:`barrier`, an all-reduce) are used.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist


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
    return backend


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
            "sharding and the distributed stack)")
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


def all_gather_cat(t: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """Every rank's ``t`` along ``mesh[axis]``, concatenated on dim 0 in
    rank order (the same shape on every rank)."""
    group = mesh.get_group(axis)
    src = t.detach().contiguous()
    if _host_staged(src, group):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(t.device)


def all_reduce_sum(t: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """The sum of every rank's ``t`` along ``mesh[axis]`` (a new tensor),
    reduced in f32 and returned in ``t``'s dtype."""
    group = mesh.get_group(axis)
    buf = t.detach().to(torch.float32, copy=True).contiguous()
    if _host_staged(buf, group):
        buf = buf.cpu()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(device=t.device, dtype=t.dtype)


def broadcast(t: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """Rank 0 of ``mesh[axis]``'s ``t`` on every rank (a new tensor of
    ``t``'s shape, dtype and device)."""
    group = mesh.get_group(axis)
    buf = t.detach().clone().contiguous()
    if _host_staged(buf, group):
        buf = buf.cpu()
    dist.broadcast(buf, src=dist.get_global_rank(group, 0), group=group)
    return buf.to(t.device)


def barrier(mesh, axis: str = "data") -> None:
    """Return once every rank of ``mesh[axis]`` has reached this call (the
    host waits for the all-reduce's result)."""
    all_reduce_sum(torch.zeros(1, device=mesh_device(mesh)), mesh,
                   axis).item()
