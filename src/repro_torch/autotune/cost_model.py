"""Analytic per-implementation cost model for batched SpMM on the H100
(the reference's ``autotune/cost_model.py``, re-derived for the port).

The reference extends the planner's case analysis into a *which-kernel*
decision by estimating wall time for every impl of the registry on a
shape-keyed :class:`Workload`; so does this module, with the same
structure, ladders and keys:

    t(impl) = max(flops / unit_peak, bytes / hbm_bw) + overheads

What differs is what the terms price. The reference's are a TPU's: one-hot
MXU contractions in chunks of 128 slots, a 128 × 128 MXU tile fill and a
Pallas grid step. Here they are the port's kernels on an NVIDIA H100
(``repro_torch.analysis.roofline.HW``) and, above all, the host: an eager
call issues every PyTorch op of its wrapper one by one, and at the main
path's shapes those ops cost more than the kernels (PERF.md §3, §5). So:

- **Compute peak.** The f32 kernels, the stacked layer's einsum and
  ``dense`` (TF32 off) run on the CUDA cores' FMA peak (``HW.fma_flops``)
  at an efficiency measured on the card; ``fused_bf16`` runs its transform
  on the tensor cores (``HW.peak_flops``) at the fill of ``mma.sync``
  m16n8k16 tiles (:func:`_mma_fill`).
- **Traffic.** The port's SpMM kernels read B through the L2 (once a
  matrix), so they pay B once plus their index streams; the plain impls
  gather one B row per slot into a tensor they write and read back.
  ``pallas_coo`` buckets slots by row: each slot reads one row of
  B, its ids and its value, with no one-hot contraction. The fused layer
  prices its transform at the FMA (or tensor) peak plus the aggregation's
  gathers, and the write and re-read of U where its plan is ``large``.
- **Overheads.** ``OP_OVERHEAD`` is one PyTorch op of a dispatch path
  issued eagerly from the host, with the Python around it;
  ``LAUNCH_OVERHEAD`` a kernel wrapper's own host work. Each impl is
  charged the ops its wrapper really runs on CUDA tensors
  (:data:`HOST_OPS`, counted on the card by ``scripts/autotune_fit.py``),
  the ELL guard its device-to-host sync (``SYNC_OVERHEAD``), a precision
  variant its casts. A CUDA block costs no host time, so the reference's
  ``GRID_STEP_OVERHEAD`` has no counterpart.
- **Overlap.** A call issues its prep ops, then its kernel: the host's
  time and the kernel's add (:func:`estimate`). The stacked layer issues
  its einsum first, which runs while the host issues the rest
  (:func:`estimate_layer`).

The constants were fitted on an NVIDIA H100 80GB HBM3 at 700.00 W from
``measure_workload`` records (PERF.md §6); none comes from a TPU.

The model sees only static shapes, as the reference's does: ``nnz_pad``
stands in for density and every padded slot is charged.
"""
from __future__ import annotations

import dataclasses
import functools

# Reduced-precision kernel variants (DESIGN.md §10): variant impl → (base
# impl, storage policy). The base impl sets the execution structure (and so
# the branch of :func:`estimate`), the policy the bytes of each element:
#
# - ``"bf16"``: values and the dense operand in bfloat16, column ids (and
#   the COO row ids) in int16, f32 accumulation in the kernel, the output
#   rounded to bfloat16 once and cast back to the caller's dtype;
# - ``"i8"``: values as int8 codes with a per-matrix f32 scale applied to
#   the f32 accumulator after the reduction, int16 ids, the dense operand
#   and the output at the caller's f32.
PRECISION_IMPLS = {
    "ell_bf16": ("ell", "bf16"),
    "csr_bf16": ("csr", "bf16"),
    "pallas_ell_bf16": ("pallas_ell", "bf16"),
    "pallas_csr_bf16": ("pallas_csr", "bf16"),
    "pallas_coo_bf16": ("pallas_coo", "bf16"),
    "pallas_ell_i8": ("pallas_ell", "i8"),
    "pallas_csr_i8": ("pallas_csr", "i8"),
    "fused_bf16": ("fused", "bf16"),
    "pallas_hybrid_bf16": ("pallas_hybrid", "bf16"),
}

POLICIES = ("f32", "bf16", "i8")


def precision_of(impl: str) -> tuple[str, str]:
    """(base impl, storage policy) of any registry impl: ("csr", "bf16")
    for a variant, (impl, "f32") for a full-precision impl."""
    return PRECISION_IMPLS.get(impl, (impl, "f32"))


# Impls that implement the full g-SpMM matrix (op × reduce × edge-feature
# width, DESIGN.md §11). The GEMM and hybrid classes are the (mul, sum)
# product only, and the precision variants are (mul, sum)-only, so a g-SpMM
# workload (reduce != "sum", op != "mul" or d_e set) restricts the ladder
# to this set at f32.
GSPMM_IMPLS = ("ref", "loop", "ell", "pallas_ell", "csr", "pallas_csr",
               "pallas_coo")


def supports_gspmm(impl: str) -> bool:
    """Whether ``impl`` can run a non-(mul, sum) or vector-edge workload."""
    base, policy = precision_of(impl)
    return base in GSPMM_IMPLS and policy == "f32"


def _traffic(policy: str, itemsize: int) -> tuple[int, int, int, int]:
    """(value, index, feature, output) bytes per element under a storage
    policy: f32 keeps 4-byte ids and the caller's itemsize elsewhere."""
    if policy == "bf16":
        return 2, 2, 2, 2
    if policy == "i8":
        return 1, 2, itemsize, itemsize
    return itemsize, 4, itemsize, itemsize


# Below the registry on purpose, as in the reference: kernels/ops.py imports
# PRECISION_IMPLS from this module while repro_torch.core is initializing.
from repro_torch.analysis.roofline import HW  # noqa: E402
from repro_torch.core.batching import (  # noqa: E402
    BatchPlan,
    plan_batched_gemm,
    plan_batched_spmm,
    plan_fused_graph_conv,
    plan_hybrid,
)

# Constants (seconds), fitted on an NVIDIA H100 80GB HBM3 at 700.00 W by
# scripts/autotune_fit.py --fit over its records of two runs (PERF.md §6):
# least squares over the calls' wall time less their kernel's for the
# host's, over the kernels' profiled times for the device's.
OP_OVERHEAD = 17.79e-6       # one PyTorch op of a dispatch path, issued
                             # eagerly with the Python around it
LAUNCH_OVERHEAD = 39.4e-6    # a kernel wrapper's own host work: its operand
                             # checks, plan and the ctypes launch
SYNC_OVERHEAD = 13.7e-6      # one device-to-host read beyond its op
SCAN_STEP_OVERHEAD = 38 * 8.7e-6  # one sample of "loop": 38 bare ops
KERNEL_LATENCY = 7e-6        # an SpMM kernel's time beyond its bytes at the
                             # stacked Tox21 SpMM (9.8-11.7 us against ~3)
SCATTER_PENALTY = 3.0        # read-modify-write of a plain scatter-add
# the port's FMA tiles (the fused transform; the GEMM and hybrid kernels
# are taken at the same fraction) and the fused kernel's fixed time (its
# phases: stage X and W, transform, bucket, aggregate)
KERNEL_FMA_EFF = 0.443
FUSED_LATENCY = 46.6e-6
# cuBLAS without TF32 on the stacked layer's einsum (and dense's bmm)
BLAS_FMA_EFF = 0.934
BLAS_LATENCY = 21.6e-6
# the fused bf16 entry's mma.sync tiles, a fraction of the tensor-core
# peak where they are full (at Reaction100 layer 2)
MMA_EFF = 0.091

# PyTorch ops one forward call of each impl issues from the host, on CUDA
# tensors, kernel launches not included (TorchDispatchMode counts of
# scripts/autotune_fit.py at the Tox21 serving shape; they do not depend
# on the shape). "loop" issues LOOP_STEP_OPS a sample (SCAN_STEP_OVERHEAD).
# A precision variant adds POLICY_OPS (casts, the int16 narrowing, the i8
# quantization), a g-SpMM corner GSPMM_OPS (its padding masks).
HOST_OPS = {
    "ref": 30, "ell": 75, "csr": 72, "hybrid": 131, "dense": 36,
    "pallas_ell": 61, "pallas_csr": 32, "pallas_coo": 2,
    "pallas_hybrid": 86, "pallas_gemm": 35,
    "fused": 21, "fused_hybrid": 77,
}
POLICY_OPS = {"f32": 0, "bf16": 4, "i8": 16}
GSPMM_OPS = {"ref": 16, "ell": 18, "pallas_ell": 9}
# the ELL guard (formats.validate_ell_k_pad) reads the worst row degree
# back to the host once a call
SYNCS = {"ell": 1, "pallas_ell": 1}
# the stacked layer's own ops around its SpMM: the einsum, the bias add,
# flatten_channels, the reshapes and the channel sum
STACKED_LAYER_OPS = 32
# the fused layer with the bf16 policy: the int16 narrowing and the casts
FUSED_BF16_OPS = 7


def _mma_fill(m: int, n: int) -> float:
    """Fraction of the ``mma.sync`` m16n8k16 tiles a (m, n) product fills:
    rows in 16s, columns in 8s."""
    return max((m / (-(-m // 16) * 16)) * (n / (-(-n // 8) * 8)), 1e-3)


@dataclasses.dataclass(frozen=True)
class Workload:
    """Static shape key for one batched SpMM call (hashable), the
    reference's fields and key letter for letter, so that a cache record
    names the same shapes in both packages.

    ``nnz_pad`` is the COO slot count per matrix, ``k_pad`` the ELL slots per
    row or None. A *graph-conv layer* workload also carries ``channels`` and
    ``n_in``; ``nnz_avg`` is the mean real non-zeros per (sample × channel)
    where the host knows it. A *g-SpMM* workload carries ``op``, ``reduce``
    and ``d_e`` (edge-vector width); non-defaults restrict the ladder to
    :data:`GSPMM_IMPLS`. ``max_deg`` is the batch's worst row degree (the
    skew knob of the row-split classes), ``block`` the padded dst-row count
    of a sampled bipartite block (DESIGN.md §14). Defaults keep the key
    format unchanged.
    """

    batch: int
    m_pad: int
    nnz_pad: int
    k_pad: int | None
    n_b: int
    itemsize: int = 4
    channels: int | None = None
    n_in: int | None = None
    nnz_avg: int | None = None
    dtype: str = "f32"      # precision policy: "f32" | "bf16" | "i8"
    d_e: int | None = None  # edge-feature width (g-SpMM vector edges)
    reduce: str = "sum"     # g-SpMM reduce kind: "sum" | "max" | "mean"
    op: str = "mul"         # g-SpMM combine op: "mul" | "add" | "copy_lhs"
    max_deg: int | None = None
    block: int | None = None

    def key(self) -> str:
        """Stable string key of the tuning cache; the suffixes appear only
        for non-default values."""
        k = self.k_pad if self.k_pad is not None else 0
        base = (f"b{self.batch}_m{self.m_pad}_nnz{self.nnz_pad}"
                f"_k{k}_n{self.n_b}_i{self.itemsize}")
        if self.channels is not None:
            base += f"_c{self.channels}_nin{self.n_in or 0}"
        if self.dtype != "f32":
            base += f"_d{self.dtype}"
        if self.d_e is not None:
            base += f"_e{self.d_e}"
        if self.reduce != "sum":
            base += f"_r{self.reduce}"
        if self.op != "mul":
            base += f"_o{self.op}"
        if self.max_deg is not None:
            base += f"_md{self.max_deg}"
        if self.block is not None:
            base += f"_blk{self.block}"
        return base

    @property
    def is_gspmm(self) -> bool:
        """True when this workload needs a g-SpMM-capable impl."""
        return (self.op != "mul" or self.reduce != "sum"
                or self.d_e is not None)

    def shard(self, n_shards: int) -> "Workload":
        """The per-shard view of this workload on an ``n_shards``-way mesh:
        batch ``ceil(batch / n_shards)`` (the batch is padded to a multiple
        before it is split), every other field unchanged. It is the workload
        each rank runs under ``repro_torch.distributed.spmm``, so
        ``impl="auto"`` resolves against it and the tuning cache keys on
        it."""
        return dataclasses.replace(self, batch=-(-self.batch // n_shards))


@functools.lru_cache(maxsize=4096)
def spmm_plan(w: Workload, impl: str | None = None) -> BatchPlan:
    """The planner decision ``kernels/ops.py`` takes for this workload and
    impl: the column-panel plan of the ELL, CSR and COO kernels (the COO
    ones at 4-byte elements whatever B's type), the hybrid kernel's own
    plan, the GEMM kernel's. ``impl=None`` is the SpMM plan at the
    caller's itemsize, the one whose case 3 forces ``ref``. A bf16 variant
    plans at 2-byte elements, an i8 one at the caller's itemsize."""
    base, policy = (None, "f32") if impl is None else precision_of(impl)
    itemsize = 2 if policy == "bf16" else w.itemsize
    if base in ("hybrid", "pallas_hybrid"):
        return plan_hybrid(batch=w.batch, m_pad=w.m_pad, n_b=w.n_b,
                           nnz_pad=w.nnz_pad, itemsize=itemsize).spmm
    if base in ("dense", "pallas_gemm"):
        return plan_batched_gemm(batch=w.batch, m=w.m_pad, n=w.n_b,
                                 k=w.m_pad)
    if base == "pallas_coo":
        itemsize = 4
    return plan_batched_spmm(batch=w.batch, m_pad=w.m_pad, n_b=w.n_b,
                             itemsize=itemsize)


def _roofline(flops: float, bytes_: float, unit_peak: float,
              hw: HW) -> float:
    return max(flops / unit_peak, bytes_ / hw.hbm_bw)


def host_seconds(w: Workload, impl: str) -> float:
    """Host seconds one forward call of SpMM ``impl`` takes to issue on
    ``w``: its PyTorch ops, its kernel launch and its syncs."""
    base, policy = precision_of(impl)
    if base == "loop":
        return w.batch * SCAN_STEP_OVERHEAD
    ops = HOST_OPS[base] + POLICY_OPS[policy]
    if w.is_gspmm:
        ops += GSPMM_OPS.get(base, 0)
    launch = LAUNCH_OVERHEAD if base.startswith("pallas") else 0.0
    return (ops * OP_OVERHEAD + launch
            + SYNCS.get(base, 0) * SYNC_OVERHEAD)


def _device(w: Workload, impl: str, hw: HW) -> float:
    """Device seconds of one SpMM call of ``impl`` on ``w``."""
    base, policy = precision_of(impl)
    f32_path = policy == "f32"
    vb, ib, fb, ob = _traffic(policy, w.itemsize)
    fma = hw.fma_flops
    rows_out = w.block if w.block is not None else w.m_pad
    out_bytes = w.batch * rows_out * w.n_b * ob
    b_bytes = w.batch * w.m_pad * w.n_b * fb
    # g-SpMM extras: vector edges read (d_e - 1) more value elements a
    # slot, a max / mean reduce one more pass over the output
    d_x = (w.d_e - 1) if w.d_e else 0
    gfix = out_bytes if w.reduce != "sum" else 0.0
    edge_x = w.batch * w.nnz_pad * d_x * vb
    slot_bytes = (8 + w.itemsize) if f32_path else (2 * ib + vb)

    if base in ("ref", "loop", "csr", "ell"):
        # plain impls: one gathered B row per slot, written and read back,
        # then a scatter-add (ell: its slots are m_pad * k_pad)
        slots = w.batch * (w.m_pad * w.k_pad if base == "ell"
                           else w.nnz_pad)
        gather = slots * w.n_b * fb
        idx = slots * slot_bytes + (w.batch * w.m_pad * 4
                                    if base == "csr" else 0)
        flops = 2.0 * slots * w.n_b
        bytes_ = 2 * gather + idx + SCATTER_PENALTY * out_bytes + edge_x \
            + gfix
        return _roofline(flops, bytes_, fma, hw)

    if base in ("pallas_ell", "pallas_csr", "pallas_coo"):
        # B through the L2 once a matrix, the index streams, the output once
        if base == "pallas_ell":
            slots = w.batch * w.m_pad * w.k_pad
            row_bound = w.k_pad
        else:
            slots = w.batch * w.nnz_pad
            row_bound = w.max_deg if w.max_deg is not None else (
                w.k_pad if w.k_pad is not None
                else max(1, -(-w.nnz_pad // w.m_pad)))
        if base == "pallas_csr":
            # one sub-warp walks a row: the worst row's slots serialize
            flops = 2.0 * w.batch * rows_out * row_bound * w.n_b
            idx = slots * (4 + vb) + w.batch * (w.m_pad + 1) * 4
        else:
            flops = 2.0 * slots * w.n_b
            idx = slots * (slot_bytes - (4 if base == "pallas_ell" else 0))
        bytes_ = b_bytes + idx + out_bytes + edge_x + gfix
        return _roofline(flops, bytes_, fma, hw) + KERNEL_LATENCY

    if base in ("hybrid", "pallas_hybrid"):
        hp = plan_hybrid(batch=w.batch, m_pad=w.m_pad, n_b=w.n_b,
                         nnz_pad=w.nnz_pad,
                         itemsize=2 if policy == "bf16" else w.itemsize)
        slab_bytes = 2.0 * w.batch * hp.d_pad * w.m_pad * vb
        perm_bytes = 6.0 * w.batch * w.m_pad * 4
        flops_d = 2.0 * w.batch * hp.d_pad * w.m_pad * w.n_b
        if base == "hybrid":
            # the plain sibling: an ELL gather over k = dmin - 1 slots a
            # row and the hub einsum
            k_sp = min(w.m_pad, max(1, hp.dmin - 1))
            slots = w.batch * w.m_pad * k_sp
            bytes_ = (slots * (2 * w.n_b * fb + 8)
                      + SCATTER_PENALTY * out_bytes + slab_bytes + perm_bytes)
            return (_roofline(2.0 * slots * w.n_b, bytes_, fma, hw)
                    + flops_d / (fma * BLAS_FMA_EFF) + BLAS_LATENCY)
        row_bound = (min(w.max_deg, max(1, hp.dmin - 1))
                     if w.max_deg is not None
                     else (w.k_pad if w.k_pad is not None
                           else max(1, -(-w.nnz_pad // w.m_pad))))
        flops_s = 2.0 * w.batch * rows_out * row_bound * w.n_b
        bytes_ = (b_bytes + w.batch * w.nnz_pad * (4 + vb)
                  + 4 * w.batch * w.m_pad * 4 + out_bytes + slab_bytes
                  + perm_bytes)
        return (_roofline(flops_s, bytes_, fma, hw)
                + flops_d / (fma * KERNEL_FMA_EFF) + KERNEL_LATENCY)

    if base in ("dense", "pallas_gemm"):
        densify = 2.0 * w.batch * w.m_pad * w.m_pad * w.itemsize
        flops = 2.0 * w.batch * w.m_pad * w.m_pad * w.n_b
        if base == "dense":
            return (_roofline(flops, densify + b_bytes + out_bytes,
                              fma * BLAS_FMA_EFF, hw) + BLAS_LATENCY)
        return (_roofline(flops, densify + b_bytes + out_bytes,
                          fma * KERNEL_FMA_EFF, hw) + KERNEL_LATENCY)

    raise ValueError(f"unknown impl {impl!r}")


def _fused(w: Workload, impl: str, hw: HW) -> float:
    """Seconds of one fused layer call (``fused``, ``fused_hybrid``,
    ``fused_bf16``) on the layer workload ``w``: its host ops and launch,
    then the kernel (issued last, so nothing hides it): the transform of
    every channel at the FMA peak (tensor-core peak for bf16) and the
    aggregation, or the bytes each block reads where those take longer,
    plus U written to and read back from the scratch where the plan is
    ``large``."""
    base, policy = precision_of(impl)
    vb, ib, fb, ob = _traffic(policy, w.itemsize)
    itemsize = 2 if policy == "bf16" else w.itemsize
    plan = plan_fused_graph_conv(batch=w.batch, m_pad=w.m_pad, n_in=w.n_in,
                                 n_out=w.n_b, itemsize=itemsize)
    if plan.case == 3:
        return float("inf")     # the wrapper raises: the stacked form runs
    ch = w.channels
    flops_t = 2.0 * w.batch * ch * w.m_pad * w.n_in * w.n_b
    if policy == "bf16":
        peak = hw.peak_flops * MMA_EFF * _mma_fill(w.m_pad, plan.n_block)
    else:
        peak = hw.fma_flops * KERNEL_FMA_EFF
    nnz_eff = w.nnz_avg if w.nnz_avg is not None else w.nnz_pad
    slot_bytes = (8 + w.itemsize) if policy == "f32" else (2 * ib + vb)
    # X and W once, every block's slots of every channel, Y once
    bytes_ = (w.batch * w.m_pad * w.n_in * fb + ch * w.n_in * w.n_b * fb
              + w.batch * plan.p * ch * nnz_eff * slot_bytes
              + w.batch * w.m_pad * w.n_b * ob)
    if plan.large:
        bytes_ += 2.0 * ch * w.batch * w.m_pad * w.n_b * 4
    flops_a = 2.0 * w.batch * ch * nnz_eff * w.n_b
    device = FUSED_LATENCY + max(flops_t / peak + flops_a / hw.fma_flops,
                                 bytes_ / hw.hbm_bw)
    ops = HOST_OPS[base] + (FUSED_BF16_OPS if policy == "bf16" else 0)
    if base == "fused_hybrid":
        hp = plan_hybrid(batch=w.batch, m_pad=w.m_pad, n_b=w.n_b,
                         nnz_pad=ch * w.nnz_pad, itemsize=itemsize)
        device += (2.0 * w.batch * ch * hp.d_pad * w.m_pad * w.n_b
                   / (hw.fma_flops * KERNEL_FMA_EFF)
                   + (2.0 * w.batch * ch * hp.d_pad * w.m_pad * vb
                      + 6.0 * w.batch * w.m_pad * 4) / hw.hbm_bw)
    return ops * OP_OVERHEAD + LAUNCH_OVERHEAD + device


def estimate(w: Workload, impl: str, hw: HW = HW()) -> float:
    """Estimated seconds a caller waits for one eager batched call of
    ``impl`` on workload ``w``: the host issues the wrapper's ops, then
    the device runs the product (its prep ops hide under the host's). The
    fused impls price a layer workload and are ``inf`` on a bare SpMM
    workload. Precision variants keep their base impl's structure with
    their policy's bytes and casts; the pricing follows the impl's policy,
    not ``w.dtype``."""
    base, _ = precision_of(impl)
    if base.startswith("fused"):
        if w.channels is None or w.n_in is None:
            return float("inf")     # not a layer workload
        return _fused(w, impl, hw)
    if base in ("ell", "pallas_ell") and w.k_pad is None:
        return float("inf")
    return host_seconds(w, impl) + _device(w, impl, hw)


def _candidates(dtype: str, allow_pallas: bool) -> list[str]:
    """The SpMM candidate ladder for a precision policy, the reference's:
    reduced policies add their variants next to the full-precision impls.
    ``allow_pallas`` means a kernel runs here (the tensors are on CUDA)."""
    cands = ["ref", "ell", "csr", "hybrid", "dense", "loop"]
    if dtype in ("bf16", "i8"):
        cands += ["ell_bf16", "csr_bf16"]
    if allow_pallas:
        cands += ["pallas_ell", "pallas_csr", "pallas_coo", "pallas_hybrid",
                  "pallas_gemm"]
        if dtype in ("bf16", "i8"):
            cands += ["pallas_ell_bf16", "pallas_csr_bf16", "pallas_coo_bf16",
                      "pallas_hybrid_bf16"]
        if dtype == "i8":
            cands += ["pallas_ell_i8", "pallas_csr_i8"]
    return cands


@functools.lru_cache(maxsize=4096)
def rank(w: Workload, *, allow_pallas: bool = True,
         hw: HW = HW()) -> tuple[tuple[str, float], ...]:
    """All runnable impls for ``w``, cheapest first, as (impl, seconds).

    ``allow_pallas=False`` (tensors on the CPU, where a kernel impl runs
    its plain version) ranks no kernel impl; ``w.dtype`` widens the ladder
    with the policy's variants; a g-SpMM workload ranks only the
    :func:`supports_gspmm` impls."""
    cands = _candidates(w.dtype, allow_pallas)
    if w.is_gspmm:
        cands = [c for c in cands if supports_gspmm(c)]
    scored = [(i, estimate(w, i, hw)) for i in cands]
    scored = [(i, t) for i, t in scored if t != float("inf")]
    return tuple(sorted(scored, key=lambda it: it[1]))


def estimate_layer(w: Workload, impl: str, hw: HW = HW()) -> float:
    """Estimated seconds of one WHOLE graph-conv layer ``Y = Σ_ch
    A_ch·(X·W_ch + b_ch)`` on a channels-aware workload: a fused impl is
    one call (:func:`estimate`); any SpMM impl is the stacked form, one
    einsum and bias add (U written to memory), ONE (channels·batch) SpMM
    and the channel sum, with the stacked layer's own host ops. The einsum
    runs on the device while the host issues the rest of the layer."""
    if w.channels is None or w.n_in is None:
        raise ValueError(f"not a layer workload (channels/n_in unset): {w}")
    if precision_of(impl)[0].startswith("fused"):
        return estimate(w, impl, hw)
    stacked = dataclasses.replace(w, batch=w.batch * w.channels,
                                  channels=None, n_in=None, nnz_avg=None)
    if estimate(stacked, impl, hw) == float("inf"):
        return float("inf")
    ch, b = w.channels, w.batch
    u_bytes = ch * b * w.m_pad * w.n_b * w.itemsize
    x_bytes = b * w.m_pad * w.n_in * w.itemsize
    out_bytes = b * w.m_pad * w.n_b * w.itemsize
    mm_flops = 2.0 * ch * b * w.m_pad * w.n_in * w.n_b
    # the einsum and the bias add (U written, read and written again)
    t_mm = _roofline(mm_flops, x_bytes + 3 * u_bytes,
                     hw.fma_flops * BLAS_FMA_EFF, hw) + BLAS_LATENCY
    # channel sum: read the `ch` SpMM outputs, write Y
    t_sum = (ch + 1) * out_bytes / hw.hbm_bw
    # the einsum is issued first and runs while the host issues the rest;
    # the SpMM and the sum come last
    host = host_seconds(stacked, impl) + STACKED_LAYER_OPS * OP_OVERHEAD
    return max(host, t_mm) + _device(stacked, impl, hw) + t_sum


@functools.lru_cache(maxsize=4096)
def rank_layer(w: Workload, *, allow_pallas: bool = True,
               hw: HW = HW()) -> tuple[tuple[str, float], ...]:
    """All runnable impls for a graph-conv LAYER workload, cheapest first:
    the SpMM impls of :func:`rank` priced as the stacked layer, plus the
    fused layer kernels where a kernel runs (``fused_bf16`` too under a
    reduced policy)."""
    candidates = _candidates(w.dtype, allow_pallas)
    if allow_pallas:
        candidates += ["fused", "fused_hybrid"]
        if w.dtype in ("bf16", "i8"):
            candidates += ["fused_bf16"]
    scored = [(i, estimate_layer(w, i, hw)) for i in candidates]
    scored = [(i, t) for i, t in scored if t != float("inf")]
    return tuple(sorted(scored, key=lambda it: it[1]))
