"""User-facing batched SpMM API (re-export; the implementation lives in
``repro_torch.kernels.ops`` next to the kernels it dispatches to)."""
from repro_torch.kernels.ops import IMPLS, batched_gspmm, batched_spmm

__all__ = ["IMPLS", "batched_gspmm", "batched_spmm"]
