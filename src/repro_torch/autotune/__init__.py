"""Adaptive dispatch for batched SpMM on the H100 (the reference's
``autotune`` package): ``impl="auto"`` resolved from the call's shapes.

- :mod:`repro_torch.autotune.cost_model` — the analytic ranking of the
  impls on the card (roofline terms over the planner's case analysis plus
  the host ops each impl's wrapper issues);
- :mod:`repro_torch.autotune.selector` — the Decision and its precedence
  (case-3 force → tuning-cache winner → model winner);
- :mod:`repro_torch.autotune.cache` — the JSON cache of measurements on the
  card (``$REPRO_TORCH_TUNE_CACHE``), refining the model per workload key.
"""
from repro_torch.autotune.cache import (  # noqa: F401
    ENV_VAR,
    TuningCache,
    autotune,
    default_cache,
    measure_workload,
)
from repro_torch.autotune.cost_model import (  # noqa: F401
    GSPMM_IMPLS,
    PRECISION_IMPLS,
    Workload,
    estimate,
    estimate_layer,
    precision_of,
    rank,
    rank_layer,
    spmm_plan,
    supports_gspmm,
)
from repro_torch.autotune.selector import (  # noqa: F401
    KINDS,
    Decision,
    forced_decision,
    resolve_auto,
    select_graph_conv_impl,
    select_impl,
)

__all__ = [
    "ENV_VAR", "TuningCache", "autotune", "default_cache", "measure_workload",
    "GSPMM_IMPLS", "PRECISION_IMPLS", "Workload", "estimate",
    "estimate_layer", "precision_of", "rank", "rank_layer", "spmm_plan",
    "supports_gspmm", "KINDS", "Decision", "forced_decision", "resolve_auto",
    "select_graph_conv_impl", "select_impl",
]
