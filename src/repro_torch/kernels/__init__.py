"""Hand-written CUDA kernels for Hopper (``csrc/``) with their plain PyTorch
versions (``ref.py``).

Each wrapper checks its operands, then runs the plain version when every
operand lies on the CPU, or launches its kernel when every operand lies on
the current CUDA device. Anything else raises: a CUDA tensor never falls
back to the plain version. Each wrapper counts its kernel launches in a
plain integer attribute, ``<wrapper>.launches``.
"""
from __future__ import annotations

import torch


def on_cpu(*tensors) -> bool:
    """True when every operand lies on the CPU, False when all lie on the
    current CUDA device; raises on mixed or other devices."""
    devs = {t.device for t in tensors if t is not None}
    if devs == {torch.device("cpu")}:
        return True
    if len(devs) == 1:
        (dev,) = devs
        if dev.type == "cuda" and dev.index == torch.cuda.current_device():
            return False
    raise ValueError(
        "kernel operands must all lie on the CPU (plain version) or all on "
        f"the current CUDA device (kernel), got {sorted(map(str, devs))}")


def check_operand(name: str, t: torch.Tensor, shape, dtype) -> None:
    """Raise unless ``t`` has this shape and dtype and is contiguous."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes contiguous tensors")


def check_plan(plan, *, batch: int, m_pad: int, n_b: int,
               large: bool = False) -> None:
    """Raise unless ``plan`` is for these shapes; a planner case-3 plan
    passes only to a large-matrix entry (``large``), which streams through
    global memory what the batched entries keep in shared memory."""
    if (plan.batch, plan.m_pad, plan.n_b) != (batch, m_pad, n_b):
        raise ValueError(f"{plan} does not match batch={batch}, "
                         f"m_pad={m_pad}, n_b={n_b}")
    if plan.case == 3 and not large:
        raise ValueError(f"{plan} is planner case 3: the batched kernel does "
                         "not take matrices this large (its large-matrix "
                         "entry does)")


# The static g-SpMM axes, in the order of the kernels' codes
# (csrc/common.cuh). ``copy_lhs`` ignores the edge value.
GSPMM_OPS = ("mul", "add", "copy_lhs")
GSPMM_REDUCES = ("sum", "max", "mean")


def gspmm_codes(op: str, reduce: str) -> tuple[int, int]:
    """The kernels' integer codes of a g-SpMM ``(op, reduce)``."""
    if op not in GSPMM_OPS:
        raise ValueError(f"unknown g-SpMM op {op!r}; expected {GSPMM_OPS}")
    if reduce not in GSPMM_REDUCES:
        raise ValueError(
            f"unknown g-SpMM reduce {reduce!r}; expected {GSPMM_REDUCES}")
    return GSPMM_OPS.index(op), GSPMM_REDUCES.index(reduce)


def stream_handle() -> int:
    """PyTorch's current CUDA stream, as the handle the kernels launch on."""
    return torch.cuda.current_stream().cuda_stream
