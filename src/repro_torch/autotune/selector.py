"""Shape-keyed implementation selection for ``impl="auto"`` (the
reference's ``autotune/selector.py``).

``select_impl`` turns a :class:`~repro_torch.autotune.cost_model.Workload`
into a :class:`Decision`: the concrete impl ``kernels/ops.py`` runs, with
what audits the choice (the planner case, the model's ranking, and whether
a measured tuning-cache record overrode the model). The precedence is the
reference's:

1. past ``LARGE_M`` rows (the reference's planner case 3) — forced to
   the per-sample ``ref`` path, as in the reference (:func:`forces_ref`).
   The port's own plan reaches case 3 earlier (a 32-column f32 panel of
   2,048 rows is more than a block's shared memory); below ``LARGE_M``
   such a workload is ranked like any other, and a kernel impl picked
   there runs its large-matrix entry. ``Decision.case`` reports the
   port's plan;
2. a measured winner from the tuning cache, where one exists for this
   workload key and names a candidate of the allowed ladder;
3. the cost model's cheapest candidate.

``allow_pallas`` means "a kernel runs here": the tensors lie on a CUDA
device. On the CPU a kernel impl runs its plain version, so the CPU
posture never ranks one, as the reference's interpret posture never ranks
a Pallas kernel.
"""
from __future__ import annotations

import dataclasses
import functools

from repro_torch.analysis.roofline import HW
from repro_torch.autotune.cost_model import (
    PRECISION_IMPLS,
    Workload,
    precision_of,
    rank,
    rank_layer,
    spmm_plan,
)
from repro_torch.core.batching import (
    LARGE_M,
    BatchPlan,
    plan_fused_graph_conv,
)


@functools.lru_cache(maxsize=4096)
def _layer_plan(w: Workload, impl: str) -> BatchPlan:
    """The plan a layer impl runs: the fused kernel's own plan for the
    fused class (a bf16 variant at 2-byte elements), the stacked
    (channels·batch) SpMM plan otherwise."""
    base, policy = precision_of(impl)
    if base.startswith("fused"):
        return plan_fused_graph_conv(
            batch=w.batch, m_pad=w.m_pad, n_in=w.n_in or 0, n_out=w.n_b,
            itemsize=2 if policy == "bf16" else w.itemsize)
    return spmm_plan(dataclasses.replace(
        w, batch=w.batch * (w.channels or 1), channels=None, n_in=None,
        nnz_avg=None), impl)


# impl → kernel class, the reference's table: the class is the decision the
# paper's policy makes; kernel or plain within a class is where the tensors
# lie, and a precision variant keeps its base impl's class.
KINDS = {
    "ref": "scatter", "loop": "scatter",
    "ell": "ell", "pallas_ell": "ell",
    "csr": "csr", "pallas_csr": "csr",
    "pallas_coo": "coo",
    "hybrid": "hybrid", "pallas_hybrid": "hybrid",
    "dense": "gemm", "pallas_gemm": "gemm",
    "fused": "fused", "fused_hybrid": "fused",
}
KINDS.update({v: KINDS[base] for v, (base, _) in PRECISION_IMPLS.items()})


@dataclasses.dataclass(frozen=True)
class Decision:
    """An auditable ``impl="auto"`` resolution."""

    impl: str                       # concrete impl for kernels/ops.py
    kind: str                       # kernel class (KINDS[impl])
    case: int                       # planner case 1/2/3 for this workload
    plan: BatchPlan                 # the blocking decision behind `case`
    scores: tuple[tuple[str, float], ...]  # model ranking, cheapest first
    source: str                     # "model" | "cache" | "forced"
    reason: str                     # one-line human-readable justification
    workload: Workload | None = None  # the shape key this decision resolved


def forced_decision(w: Workload, impl: str, *, note: str = "") -> Decision:
    """The Decision for a caller-pinned concrete ``impl``: no ranking, the
    same plan and case fields as a model decision. A LAYER workload
    (``channels``/``n_in`` set) reports the plan the layer impl runs."""
    if w.channels is not None and w.n_in is not None:
        plan = _layer_plan(w, impl)
    else:
        plan = spmm_plan(w, impl)
    return Decision(
        impl=impl, kind=KINDS.get(impl, impl), case=plan.case, plan=plan,
        scores=(), source="forced", workload=w,
        reason=f"caller pinned impl={impl!r}{note}")


def forces_ref(w: Workload) -> bool:
    """Whether ``impl="auto"`` forces the per-sample ``ref`` path: the
    reference's rule, ``m_pad > LARGE_M`` (its planner's case 3, which
    depends on m_pad alone), shared by :func:`select_impl` and
    :func:`select_graph_conv_impl`."""
    return w.m_pad > LARGE_M


def select_impl(
    w: Workload,
    *,
    allow_pallas: bool = True,
    cache=None,
    hw: HW = HW(),
) -> Decision:
    """Resolve ``impl="auto"`` for one SpMM workload. Host work only:
    ``rank`` is memoized and ``cache.best`` is a dict lookup."""
    scores = rank(w, allow_pallas=allow_pallas, hw=hw)
    if forces_ref(w):
        plan = spmm_plan(w, "ref")
        return Decision(
            impl="ref", kind="scatter", case=3, plan=plan, scores=scores,
            source="forced", workload=w,
            reason=(f"m_pad={w.m_pad} > LARGE_M: paper case 3 — batching "
                    "does not pay, per-sample scatter-add fallback"),
        )
    allowed = {i for i, _ in scores}
    if cache is not None:
        measured = cache.best(w.key())
        if measured in allowed:
            plan = spmm_plan(w, measured)
            return Decision(
                impl=measured, kind=KINDS[measured], case=plan.case,
                plan=plan, scores=scores, source="cache", workload=w,
                reason=f"measured winner for key {w.key()} (tuning cache)",
            )
    impl, est = scores[0]
    plan = spmm_plan(w, impl)
    runner_up = f"; runner-up {scores[1][0]} @ {scores[1][1]:.2e}s" \
        if len(scores) > 1 else ""
    return Decision(
        impl=impl, kind=KINDS[impl], case=plan.case, plan=plan,
        scores=scores, source="model", workload=w,
        reason=f"cost model: {impl} @ {est:.2e}s (case {plan.case}, "
               f"p={plan.p}){runner_up}",
    )


def select_graph_conv_impl(
    w: Workload,
    *,
    allow_pallas: bool = True,
    cache=None,
    hw: HW = HW(),
) -> Decision:
    """Resolve ``impl="auto"`` for one graph-conv LAYER workload
    (``w.channels``/``w.n_in`` set): every SpMM impl priced as the stacked
    layer, plus the fused kernels (``rank_layer``). Same precedence as
    :func:`select_impl`."""
    if w.channels is None or w.n_in is None:
        raise ValueError(f"not a layer workload (channels/n_in unset): {w}")
    scores = rank_layer(w, allow_pallas=allow_pallas, hw=hw)
    if forces_ref(w):
        plan = spmm_plan(w, "ref")
        return Decision(
            impl="ref", kind="scatter", case=3, plan=plan, scores=scores,
            source="forced", workload=w,
            reason=(f"m_pad={w.m_pad} > LARGE_M: paper case 3 — neither "
                    "batching nor fusion pays, per-sample scatter-add "
                    "fallback"),
        )
    allowed = {i for i, _ in scores}
    if cache is not None:
        measured = cache.best(w.key())
        if measured in allowed:
            plan = _layer_plan(w, measured)
            return Decision(
                impl=measured, kind=KINDS[measured], case=plan.case,
                plan=plan, scores=scores, source="cache", workload=w,
                reason=f"measured winner for key {w.key()} (tuning cache)",
            )
    impl, est = scores[0]
    plan = _layer_plan(w, impl)
    runner_up = f"; runner-up {scores[1][0]} @ {scores[1][1]:.2e}s" \
        if len(scores) > 1 else ""
    return Decision(
        impl=impl, kind=KINDS[impl], case=plan.case, plan=plan,
        scores=scores, source="model", workload=w,
        reason=f"layer cost model: {impl} @ {est:.2e}s "
               f"(channels={w.channels}, case {plan.case}){runner_up}",
    )


def resolve_auto(
    *,
    batch: int,
    m_pad: int,
    nnz_pad: int,
    k_pad: int | None,
    n_b: int,
    itemsize: int,
    allow_pallas: bool = False,
    cache=None,
    dtype: str = "f32",
) -> Decision:
    """Entry point of ``kernels/ops.py``: the Workload of one
    ``batched_spmm`` call's shapes, then :func:`select_impl`.
    ``allow_pallas`` (the tensors lie on CUDA) is the counterpart of the
    reference's ``not interpret``; ``dtype`` is the caller's precision
    policy, which admits its variants to the ranking. ``cache`` defaults to
    the process's :func:`~repro_torch.autotune.cache.default_cache`."""
    if cache is None:
        from repro_torch.autotune.cache import default_cache
        cache = default_cache()
    w = Workload(batch=batch, m_pad=m_pad, nnz_pad=nnz_pad, k_pad=k_pad,
                 n_b=n_b, itemsize=itemsize, dtype=dtype)
    return select_impl(w, allow_pallas=allow_pallas, cache=cache)
