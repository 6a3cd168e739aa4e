"""PyTorch + CUDA port of the batched-SpMM GCN system (the JAX package
``repro`` is the reference it is held against).

The port mirrors the reference's layout module by module. Its entry points
run on the GPU unless the caller passes ``device="cpu"``; on the CPU every
kernel wrapper runs its plain PyTorch version instead. Without a GPU and
without ``device="cpu"`` they raise rather than fall back quietly.
"""
from __future__ import annotations

import torch


def resolve_device(device=None, mesh=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the current CUDA
    device, and raises when there is none; anything else is taken as asked.
    Under a ``DeviceMesh``, this rank's device on the mesh
    (``repro_torch.launch.mesh.check_device``)."""
    if mesh is not None:
        from repro_torch.launch.mesh import check_device

        return check_device(mesh, device)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU by default; pass "
                "device='cpu' to run its plain PyTorch versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
