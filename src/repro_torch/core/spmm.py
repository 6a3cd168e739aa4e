"""User-facing batched SpMM API (re-export; the implementation lives in
``repro_torch.kernels.ops`` next to the kernels it dispatches to).

``sharded_batched_spmm``, ``sharded_batched_gspmm`` and
``resolve_sharded_impl`` are the mesh-sharded variants
(``repro_torch.distributed.spmm``), imported on first use."""
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
           "batched_spmm", "resolve_gspmm_impl", "resolve_impl",
           "sharded_batched_spmm", "sharded_batched_gspmm",
           "resolve_sharded_impl"]


def __getattr__(name):
    if name in ("sharded_batched_spmm", "sharded_batched_gspmm",
                "resolve_sharded_impl"):
        from repro_torch.distributed import spmm as _dspmm

        return getattr(_dspmm, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
