"""User-facing batched SpMM API (re-export; the implementation lives in
``repro_torch.kernels.ops`` next to the kernels it dispatches to)."""
from repro_torch.kernels.ops import (
    GSPMM_OPS,
    GSPMM_REDUCES,
    IMPLS,
    batched_gspmm,
    batched_spmm,
    resolve_gspmm_impl,
    resolve_impl,
)

__all__ = ["GSPMM_OPS", "GSPMM_REDUCES", "IMPLS", "batched_gspmm",
           "batched_spmm", "resolve_gspmm_impl", "resolve_impl"]
