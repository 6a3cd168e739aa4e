#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Runs from the root of a checkout, needs one CUDA device and ``nvcc``, and
imports nothing of JAX or of the JAX package. Phases, each fatal on failure:

1. device: the card's name and power limit; TF32 off for matmul and cuDNN;
2. build: the CUDA kernels from ``src/repro_torch/csrc`` (``build/kernels``),
   with each kernel's registers and spill bytes;
3. kernels: each kernel against its plain PyTorch version, at the main
   paths' shapes (taken from a real Tox21 / Reaction100 wave and training
   batch, and the degree-skewed powerlaw batch) and on the uniform /
   skewed / zero-nnz regimes, with kernel, plain, library-call and bound
   times (device times by CUDA-graph replay; the kernel's back-to-back
   call time beside it, and the PyTorch prep of the hybrid kernels; the
   hybrid rows' bound counts the slab rows up to each sample's hub count,
   and a [bound] line gives it over all d_pad rows too); the CSR, hybrid
   GEMM and batched COO kernels also twice for identical bits, the hybrid
   kernel also without a slab, and the COO and CSR kernels in their
   backward roles (dU of the fused layer, dB of ``pallas_csr`` on the
   transposed CSR), the COO and CSR kernels also at the powerlaw batch
   (hub rows), and the CSR kernel's g-SpMM entry at R-GCN Reaction100
   serving (n_b 512, the row batched_spmm_csr[reaction100]);
   then the g-SpMM entries of the ELL, CSR and COO
   kernels at the R-GCN ((copy_lhs, mean), n_b 64) and GAT ((mul, sum),
   vector edges, n_b 16) Tox21 serving shapes and on every (op, reduce)
   corner of the three regimes (max corners bitwise), and the grouped
   matmul at R-GCN's Tox21 serving and training layer-1 shapes, the
   training step's dx at layer 2 and Reaction100 layers 1 and 2 (ELL, CSR
   and grouped matmul twice for identical bits; the grouped matmul also
   with 5 groups in one 128-row tile, whose fifth group's rows come out 0
   as in the reference, and with an inf in one group's W and a NaN in
   another's: every other row within the f32 tolerance of the plain
   version and finite, the bad groups' non-finite values where the plain
   version has them); the batched and large-matrix entries of ELL (f32,
   bf16, i8) and GEMM at Tox21 serving and Reaction100 layer 2 for the
   same bits, timed ([fork] lines: one kernel each); then the seven
   reduced-precision entries (bf16 ELL, CSR, COO, hybrid and fused, i8
   ELL and CSR) at the Tox21 serving shape (and Reaction100 layer 2 for
   the fused one, the powerlaw batch for the hybrid one), each timed
   beside its f32 entry on the same inputs,
   and on the three regimes: bf16 within one bf16 ulp, i8 within the f32
   tolerance, CSR, COO and hybrid identical bits twice; the fused entries also
   at every other panel width ([panels] lines), the hybrid one also with
   its head over all d_pad slab rows instead of each sample's hub rows
   ([hubs] lines: the same result, one launch each), and the HMMA
   (mma.sync) count of each instance of the fused kernel (bf16: some; f32:
   none); then the fused layer's large-matrix branch (f32, hybrid, bf16)
   at m_pad 1024 (8 samples, n_in 512: the rows fused_forward[large],
   fused_hybrid_forward[large], fused_forward_bf16[large]) and 3072 (2,
   n_in 62: the same with ", m_pad 3072"), each against its plain version,
   twice for identical bits, and timed; then the nine
   large-matrix entries (planner case 3: ELL, CSR f32 / bf16 / i8, COO f32
   / bf16, the GEMM) at m_pad 2048 (8 matrices) and 9000 (2), n_b
   64, timed beside their bytes bound, plain versions and ``torch.bmm``,
   identical bits twice; the COO ones also on bf16 int32 ids and in
   g-SpMM (copy_lhs, mean) and (mul, max) there and at the giant-graph
   tier's two sampled blocks (33,792 rows, 3,072 x 10 slots live; 3,072
   rows, 512 x 5), and with their batched entries' bits at 64 x 56; then
   the case-3 path:
   ``ops.batched_spmm`` forward and first-step gradients with every kernel
   impl and precision variant, and g-SpMM (copy_lhs, mean), at m_pad
   9000 on the card with the plain per-sample paths trapped, against the
   same impls on the CPU;
4. powerlaw model: ChemGCN at Tox21 widths on four channels of 40
   degree-skewed 256-row graphs, ``apply_gcn`` and first-step gradients
   of ``gcn_loss`` with ``impl`` = pallas_hybrid and fused_hybrid against
   ``ref``, hub rows per matrix, launch counts;
5. serve Tox21 (62 -> 64 -> 64, 12 tasks): 512 requests through
   ``GraphServeEngine(batch=128, m_pad=56, nnz_pad=256)`` with
   ``impl`` = fused, pallas_ell, pallas_coo, pallas_hybrid, fused_hybrid,
   pallas_gemm and ref; launch counts, logits against ``ref``,
   wave-composition invariance, host/device wave times;
6. serve Reaction100 (62 -> 512 x 3, 100 classes) with ``impl`` = fused,
   fused_hybrid and pallas_hybrid against ``ref``;
7. train Tox21: ``GCNTrainer.fit``, 20 Adam steps (lr 3e-3) over 1,000
   ``tox21_like`` molecules in batches of 50, with ``impl`` = fused,
   pallas_coo, pallas_ell, pallas_csr, pallas_hybrid, fused_hybrid,
   pallas_gemm and ref from one set of seed-0 parameters; first-step
   gradients against ``ref``, the loss curve against the mean of three
   ``ref`` runs, kernel launches per step,
   ms per step split into batch placement, forward, backward and
   optimizer, and a resume from the step-10 checkpoint;
8. train Reaction100: 5 steps in batches of 100, ``impl`` = fused,
   fused_hybrid and pallas_hybrid against ``ref``;
9. GAT and R-GCN ChemGCN (``GCNConfig.tox21(layer="gat" | "rgcn")``):
   serve the Tox21 requests and train 12 Tox21 steps (a resume from step
   10) with ``impl`` = pallas_coo, pallas_csr, pallas_ell against ``ref``,
   and serve Reaction100 with R-GCN (pallas_csr against ref; the grouped
   matmul at 512 width); launch counts per wave and per step;
10. reduced precision: serve Tox21 with each of the nine variants
   (logits within tests/oracle.py TOLS[policy] of ref) and Reaction100
   with fused_bf16, pallas_hybrid_bf16 and pallas_csr_i8 (the gap to ref
   printed), and train 20 Tox21 steps with fused_bf16, pallas_csr_bf16,
   pallas_hybrid_bf16 and pallas_ell_i8 (first-step gradients against
   the variant's own plain versions on the CPU, loss curves within the
   policy's rtol of the mean f32 ref curve); exact launch counts;
11. impl="auto": the cost model's decision for every conv layer of Tox21
   and Reaction100 serving and training, then ``autotune`` times every
   candidate into a fresh tuning cache (the model's pick within
   AUTO_MODEL_RATIO of the measured best); with that cache as
   ``$REPRO_TORCH_TUNE_CACHE`` every layer resolves from it (the pick
   re-timed within AUTO_CACHE_RATIO of its rivals), ``GCNConfig.tox21()``
   serves the Tox21 requests and trains 5 steps beside ``ref`` and the
   pinned impl (exact launches, logits within F32_TOL of ref, losses
   within F32_TOL of the pinned run); GAT, R-GCN and the bf16 policy serve
   Tox21 with ``auto``; the case-3 decision at 2 x 9000 is the forced
   ``ref``, timed beside the CSR large entry;
12. continuous batching (``repro_torch.scheduler``): 512 skewed Tox21-like
   requests over the 3-rung ladder ``TierPolicy.from_requests`` gives at
   128-slot waves; the fused, ELL, COO (SpMM and g-SpMM), CSR kernels and
   the grouped matmul at each rung against their plain versions; per impl
   (``GCNConfig.tox21`` with auto, fused, pallas_coo, pallas_csr,
   pallas_ell, and R-GCN auto) a warmed ``Scheduler`` on the default
   device drains every request on the wall clock, then on a VirtualClock
   (Poisson arrivals at half the wall run's throughput, seed 0, each
   tier's median wave time as the service model): every request done and
   within F32_TOL of ``ref`` at the tier it rode, one program per tier
   used, exact launches per wave, no kernel library loaded while draining,
   each tier's decision with its measured / predicted ratio; ``[sched]``
   lines (throughput, p50 / p99, padding waste, fill, host / device ms a
   wave, the card); a telemetry drain (pallas_coo) exported as strict
   Chrome JSON with sched/wave > serve/wave > spmm/* nested and a regret
   report; the device idle share of one ``auto`` drain under
   ``torch.profiler`` and its three longest gaps by enclosing span; 10
   fused Tox21 training steps with the trainer's telemetry.

Before phases 4-12, the LM zoo's serving path runs (and frees its model):

- the flash-attention kernel against its plain version at the Llama-3-8B
  prefill shape (bf16 within one bf16 ulp, timed beside its bound and SDPA;
  f32 within 2e-5), on the five corners of ``tests/test_kernels.py`` and at
  head widths 48, 72, 80, 112, 160 and 256 in f32 and bf16, identical bits
  twice; the HGMMA (wgmma) instructions in its bf16 entry's SASS;
- Llama-3-8B at full width (bf16, seed-0 random weights on the card):
  ``lm.prefill`` of 2 x 4096 tokens with ``attention_impl`` = pallas (32
  kernel launches a call), xla_packed and xla_chunked (at the default
  blocks and at 512-blocks, the second plain order), the kernel's last
  logits within ``NOISE_MULT`` times the two plain orders' difference and
  its argmax where the top-2 margin exceeds it; then ``ServeEngine`` waves
  of greedy decode over 8 requests (exact lengths, identical twice, no
  flash launch: decode attends by plain products), ms per step split into
  device and host, and one-request waves' first tokens against prefill's
  argmax where the top-2 margin exceeds the prompt's noise floor.

The line before the last is the ``{"kernels": [...]}`` record (25
kernels: the nine large-matrix entries report their m_pad 9000 row and
the case-3 path's launches); the last line is ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_FLOP_PER_S = 67e12         # H100 SXM f32, outside the tensor cores
BF16_FLOP_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
F32_TOL = (1e-4, 1e-5)         # (atol, rtol): tests/oracle.py TOLS["f32"]
# tests/oracle.py TOLS: each storage policy against the f32 oracle
POLICY_TOLS = {"f32": F32_TOL, "bf16": (8e-2, 2e-2), "i8": (0.25, 2e-2)}
# a bf16 entry against its plain version: both round the same f32 sum to
# bf16 once, so they differ by at most one bf16 ulp (2^-7 of the value)
# where the two f32 sums straddle a rounding boundary, plus f32 noise
BF16_KERNEL_TOL = (1e-4, 8e-3)
# head widths the flash phase checks in both entries beside the main shape's
# 128: zamba2's 112, StableLM's 160, the widest (256) and widths that are
# padded (48, 72, 80 in the f32 entry; 72 in both)
FLASH_WIDTHS = (48, 72, 80, 112, 160, 256)
# flash attention against its plain version: the reference test's
# tolerances (tests/test_kernels.py), as (atol, rtol), on its five corners
FLASH_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (3e-2, 3e-2)}
# at the main-path shape, where randn inputs give outputs of ~0.03: one bf16
# ulp (2^-7 of the value; both sides round the same f32 sum once) plus f32
# noise in bf16; the f32 run of the same shape is held at FLASH_TOL
FLASH_MAIN_TOL = {"float32": FLASH_TOL["float32"], "bfloat16": (1e-4, 8e-3)}
DEVICE = "cuda"
GRAD_TOL = (3e-4, 3e-5)        # layer gradients: 3x F32_TOL (tests/oracle.py)
CURVE_RTOL = 1e-3              # loss curves against impl="ref"
# ref adds with atomics, so its curve varies from run to run; the impls are
# held against the mean curve of this many ref runs
REF_RUNS = 3
# a ReLU input whose sign differs between an impl and ref must be this
# close to 0 (f32 noise of the unit-scale batch-norm outputs is ~1e-6),
# and at most MAX_FLIPS of them may differ in one comparison
FLIP_ATOL = 1e-5
MAX_FLIPS = 4
# the same for a bf16 variant against its own plain versions: there a ReLU
# input of a unit-scale batch-norm output is bf16 noise, one bf16 ulp of
# 1.0 (7.8e-3), from 0 when its sign differs
FLIP_ATOL_BF16 = 1e-2
TOX21 = dict(batch=128, m_pad=56, nnz_pad=256)
# kernel launches per wave (serving) and per step (training) of the Tox21
# model with every conv layer pinned to one impl
SERVE_TOX21_LAUNCHES = {"fused": {"fused_forward": 2},
                        "pallas_ell": {"batched_spmm_ell": 2},
                        "pallas_coo": {"batched_spmm_coo": 2},
                        "pallas_csr": {"batched_spmm_csr": 2},
                        "pallas_hybrid": {"batched_spmm_hybrid": 2},
                        "fused_hybrid": {"fused_hybrid_forward": 2},
                        "pallas_gemm": {"batched_gemm": 2}}
TRAIN_TOX21_LAUNCHES = {
    "fused": {"fused_forward": 2, "batched_spmm_coo": 2},
    "pallas_coo": {"batched_spmm_coo": 4},
    "pallas_ell": {"batched_spmm_ell": 2, "batched_spmm_coo": 2},
    "pallas_csr": {"batched_spmm_csr": 4},
    "pallas_hybrid": {"batched_spmm_hybrid": 2, "batched_spmm_csr": 2},
    "fused_hybrid": {"fused_hybrid_forward": 2, "batched_spmm_coo": 2},
    "pallas_gemm": {"batched_gemm": 2, "batched_spmm_coo": 2}}
# the kernel a layer of each kernel impl launches in its forward
KERNEL_OF = {"fused": "fused_forward", "fused_hybrid": "fused_hybrid_forward",
             "pallas_coo": "batched_spmm_coo",
             "pallas_csr": "batched_spmm_csr",
             "pallas_ell": "batched_spmm_ell",
             "pallas_hybrid": "batched_spmm_hybrid",
             "pallas_gemm": "batched_gemm",
             "pallas_ell_bf16": "batched_spmm_ell_bf16",
             "pallas_ell_i8": "batched_spmm_ell_i8",
             "pallas_csr_bf16": "batched_spmm_csr_bf16",
             "pallas_csr_i8": "batched_spmm_csr_i8",
             "pallas_coo_bf16": "batched_spmm_coo_bf16",
             "fused_bf16": "fused_forward_bf16",
             "pallas_hybrid_bf16": "batched_spmm_hybrid_bf16"}
# impl="auto" on the card: the cost model's pick at most this many times
# the measured best of its layer; with the measured cache, the pick at most
# this many times the fastest when re-timed beside its rivals
AUTO_MODEL_RATIO = 1.25
AUTO_CACHE_RATIO = 1.1
AUTO_TRAIN_STEPS = 5
N_REQUESTS = 512
TRAIN_TOX21 = dict(n_samples=1000, batch=50, steps=20, lr=3e-3)
TRAIN_R100 = dict(batch=100, steps=5, lr=3e-3)
TRAIN_GNN_STEPS = 12           # GAT / R-GCN Tox21 steps (a resume at 10)
# the degree-skewed geometry the reference benchmarks the hybrid split on
# (benchmarks/bench_formats.py "powerlaw"), seed 0
POWERLAW = dict(batch=40, dim=256, avg_deg=8)
# continuous-batching serving (phase_scheduler): skewed Tox21-like traffic
# over a 3-rung ladder of 128-slot waves, the impls it serves with, and the
# trainer-telemetry steps
SCHED = dict(n_requests=512, levels=3, batch=128, flush_after=0.05,
             default_slo=0.5)
SCHED_IMPLS = ("auto", "fused", "pallas_coo", "pallas_csr", "pallas_ell")
SCHED_TRAIN = dict(steps=10, log_every=5)
CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt"
# Llama-3-8B at full width, bf16, seed-0 random weights. Prefill: 2 x 4096
# prompt tokens (train_4k's length; prefill_32k's 32 x 32768 is cut to fit
# the time limit). Serving: waves of 4 slots, 8 requests.
LM_ARCH = "llama3-8b"
PREFILL = dict(batch=2, seq_len=4096, calls=2)
LM_SERVE = dict(batch=4, max_len=256, n_requests=8, new_tokens=16,
                min_prompt=16, max_prompt=96)
# the kernel's prefill logits may differ from xla_packed's by at most this
# multiple of the two plain orders' difference (the bf16 noise floor)
NOISE_MULT = 2.0
# the second plain order: xla_chunked at these blocks (at the default 1024
# it is xla_packed's arithmetic, bit for bit)
CHUNKED_ORDER = dict(q_block=512, kv_block=512)
TPU_SITE = {
    "batched_spmm_ell": "src/repro/kernels/batched_spmm_ell.py:142",
    "batched_spmm_coo": "src/repro/kernels/batched_spmm_coo.py:168",
    "batched_spmm_csr": "src/repro/kernels/batched_spmm_csr.py:163",
    "fused_forward": "src/repro/kernels/fused_graph_conv.py:197",
    "batched_spmm_hybrid": "src/repro/kernels/batched_spmm_hybrid.py:223",
    "batched_gemm": "src/repro/kernels/batched_gemm.py:44",
    "fused_hybrid_forward": "src/repro/kernels/fused_graph_conv.py:197",
    "grouped_matmul": "src/repro/kernels/grouped_matmul.py:87",
    "flash_attention": "src/repro/kernels/flash_attention.py:110",
    "batched_spmm_ell_bf16": "src/repro/kernels/batched_spmm_ell.py:142",
    "batched_spmm_ell_i8": "src/repro/kernels/batched_spmm_ell.py:142",
    "batched_spmm_csr_bf16": "src/repro/kernels/batched_spmm_csr.py:163",
    "batched_spmm_csr_i8": "src/repro/kernels/batched_spmm_csr.py:163",
    "batched_spmm_coo_bf16": "src/repro/kernels/batched_spmm_coo.py:168",
    "fused_forward_bf16": "src/repro/kernels/fused_graph_conv.py:197",
    "batched_spmm_hybrid_bf16":
        "src/repro/kernels/batched_spmm_hybrid.py:223",
}
# the large-matrix entries (planner case 3): branches of the kernels that
# replace these pallas_calls, where the reference takes its plain
# per-sample path (src/repro/kernels/ops.py _forward_base, _csr_forward)
LARGE = {"batched_spmm_ell_large": "batched_spmm_ell",
         "batched_spmm_ell_large_bf16": "batched_spmm_ell_bf16",
         "batched_spmm_ell_large_i8": "batched_spmm_ell_i8",
         "batched_spmm_csr_large": "batched_spmm_csr",
         "batched_spmm_csr_large_bf16": "batched_spmm_csr_bf16",
         "batched_spmm_csr_large_i8": "batched_spmm_csr_i8",
         "batched_spmm_coo_large": "batched_spmm_coo",
         "batched_spmm_coo_large_bf16": "batched_spmm_coo_bf16",
         "batched_gemm_large": "batched_gemm"}
TPU_SITE.update({k: TPU_SITE[v] for k, v in LARGE.items()})
SOURCE = {"batched_spmm_ell": "batched_spmm_ell",
          "batched_spmm_coo": "batched_spmm_coo",
          "batched_spmm_csr": "batched_spmm_csr",
          "fused_forward": "fused_graph_conv",
          "batched_spmm_hybrid": "batched_spmm_hybrid",
          "batched_gemm": "batched_gemm",
          "fused_hybrid_forward": "fused_graph_conv",
          "grouped_matmul": "grouped_matmul",
          "flash_attention": "flash_attention",
          "batched_spmm_ell_bf16": "batched_spmm_ell",
          "batched_spmm_ell_i8": "batched_spmm_ell",
          "batched_spmm_csr_bf16": "batched_spmm_csr",
          "batched_spmm_csr_i8": "batched_spmm_csr",
          "batched_spmm_coo_bf16": "batched_spmm_coo",
          "fused_forward_bf16": "fused_graph_conv",
          "batched_spmm_hybrid_bf16": "batched_spmm_hybrid"}
SOURCE.update({k: SOURCE[v] for k, v in LARGE.items()})
# the row of each kernel that its {"kernels": ...} entry reports: the shape
# its first main path gives it (serving for ELL, COO, fused, hybrid, GEMM,
# fused hybrid and the grouped matmul, training for CSR, the Llama-3-8B
# prefill for flash attention, the Tox21 serving shape for the seven
# reduced-precision entries); the other rows, the g-SpMM entries of the
# ELL, COO and CSR kernels and the Reaction100 row of the bf16 fused entry
# among them, are printed as [kernels] lines
ENTRY_ROW = {"batched_spmm_ell": "batched_spmm_ell",
             "batched_spmm_coo": "batched_spmm_coo",
             "batched_spmm_csr": "batched_spmm_csr",
             "fused_forward": "fused_forward[tox21]",
             "batched_spmm_hybrid": "batched_spmm_hybrid[tox21]",
             "batched_gemm": "batched_gemm[tox21]",
             "fused_hybrid_forward": "fused_hybrid_forward[tox21]",
             "grouped_matmul": "grouped_matmul[rgcn tox21 serving layer 1]",
             "flash_attention": "flash_attention[llama3-8b prefill]",
             **{k: f"{k}[tox21]" for k in (
                 "batched_spmm_ell_bf16", "batched_spmm_ell_i8",
                 "batched_spmm_csr_bf16", "batched_spmm_csr_i8",
                 "batched_spmm_coo_bf16", "fused_forward_bf16",
                 "batched_spmm_hybrid_bf16")},
             **{k: f"{k}[m_pad 9000]" for k in LARGE}}
# planner case 3: (tag, m_pad, batch) of the large-matrix kernel checks; the
# case-3 path runs the second, past LARGE_M, where every variant is case 3
LARGE_SHAPES = (("m_pad 2048", 2048, 8), ("m_pad 9000", 9000, 2))
# the giant-graph tier's sampled blocks (block_caps(512, (10, 5)) in the
# reference's sampling), one matrix each: (tag, m_pad, live rows, slots a
# live row); the COO large-matrix entries run there too
TIER_BLOCKS = (("tier block 33792", 33_792, 3_072, 10),
               ("tier block 3072", 3_072, 512, 5))
# the fused layer past a block's panels (the kernel's large-matrix branch):
# (tag, m_pad, batch, n_in, n_out); m_pad 1024 x n_in 512 is a shape the
# port's planner used to refuse, 3072 the giant-graph tier's block size
FUSED_LARGE = (("m_pad 1024", 1024, 8, 512, 64),
               ("m_pad 3072", 3072, 2, 62, 64))
# the kernel impls and precision variants the case-3 path drives
CASE3_IMPLS = ("pallas_ell", "pallas_csr", "pallas_coo", "pallas_hybrid",
               "pallas_gemm", "pallas_ell_bf16", "pallas_csr_bf16",
               "pallas_coo_bf16", "pallas_hybrid_bf16", "pallas_ell_i8",
               "pallas_csr_i8")
GSPMM_CORNERS = [(op, red) for op in ("mul", "add", "copy_lhs")
                 for red in ("sum", "max", "mean")]


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Mean time of ``fn`` in ms, by CUDA events over ``iters`` back-to-back
    calls (inputs stay L2-warm, as on the serving path). Where one call's
    device work is shorter than the host's time to issue the next, this is
    the host's pace, not the device time: see :func:`graph_ms`."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


_CAPTURE_STREAM = []


def graph_ms(fn, iters: int = 30, replays: int = 5) -> float:
    """Mean device time of ``fn`` in ms: ``iters`` calls captured in one
    CUDA graph and replayed ``replays`` times between CUDA events, so that
    the host's cost of issuing each call drops out (inputs L2-warm). Every
    capture runs on one side stream: PyTorch keeps a cuBLAS workspace for
    each stream that runs a cuBLAS call, and never frees it."""
    import torch

    if not _CAPTURE_STREAM:
        _CAPTURE_STREAM.append(torch.cuda.Stream())
    side = _CAPTURE_STREAM[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # relaxed: a kernel's first launch above 48 KB of shared memory sets
    # its function attribute, which the default capture mode refuses
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (iters * replays)
    del graph
    torch.cuda.empty_cache()
    return ms


def bound(nbytes: float, flops: float,
          flop_rate: float = F32_FLOP_PER_S) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of bytes over the
    HBM rate and operations over the peak of their type (f32 unless
    ``flop_rate`` says otherwise)."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def max_err(got, want, what: str, tol=F32_TOL) -> float:
    import torch

    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    atol, rtol = tol
    err = (got - want).abs()
    ok = bool((err <= atol + rtol * want.abs()).all())
    check(ok, f"{what}: max abs error {err.max().item():.3e} above "
              f"atol={atol} rtol={rtol}")
    return float(err.max().item())


# ---------------------------------------------------------------------------

def phase_device():
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {name}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.device_count()} device(s)")
    log(f"[device] TF32 off: matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}")
    return name, card


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    per = _build.build()
    log(f"[build] {len(per)} kernel libraries in "
        f"{time.perf_counter() - t0:.2f} s ({per})")
    for name in _build.SOURCES:
        log_file = _build._library_path(name).with_suffix(".log")
        log(f"[build] {name}: " + "; ".join(
            f"{fn}: {regs} registers, spill {spill} bytes (stores / loads)"
            for fn, regs, spill in _ptxas(log_file.read_text())))


def _ptxas(text: str) -> list[tuple[str, str, str]]:
    """(kernel, registers, spill stores / loads) of each entry function in
    a ``ptxas -v`` log, the kernel's name demangled without its parameters
    (by the toolkit's ``cu++filt`` where it runs)."""
    import os
    import re

    from repro_torch.kernels import _build

    out, fn, spill = [], None, "?"
    for ln in text.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", ln):
            fn, spill = m.group(1), "?"
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", ln):
            spill = f"{m.group(1)} / {m.group(2)}"
        elif (m := re.search(r"Used (\d+) registers", ln)) and fn:
            out.append((fn, m.group(1), spill))
            fn = None
    filt = os.path.join(os.path.dirname(_build.nvcc()), "cu++filt")
    try:
        names = subprocess.run([filt, "-p"] + [f for f, _, _ in out],
                               capture_output=True, text=True, timeout=60,
                               check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        names = []
    if len(names) == len(out):
        out = [(n.strip(), r, sp) for n, (_, r, sp) in zip(names, out)]
    return out


def _requests(spec):
    from repro_torch.data.graphs import generate
    from repro_torch.serving.engine import GraphRequest

    return [GraphRequest(rows=list(s.rows), cols=list(s.cols),
                         features=s.features, n_nodes=s.n_nodes)
            for s in generate(spec)]


def _params(cfg, seed: int, device):
    import torch
    from repro_torch.core.gcn import init_gcn

    return init_gcn(cfg, generator=torch.Generator().manual_seed(seed),
                    device=device)


def _regimes(device):
    """(name, BatchedCOO on device, m_pad) for the uniform / skewed /
    zero-nnz regimes at small sizes, with N(0, 1) values."""
    import numpy as np
    import torch
    from repro_torch.core.formats import coo_from_lists, random_batch

    rng = np.random.default_rng(11)
    uni, m_uni = random_batch(rng, batch=4, dim=24, nnz_per_row=3)
    uni = uni.with_values(torch.where(
        uni.values != 0, torch.from_numpy(rng.normal(
            size=tuple(uni.values.shape)).astype(np.float32)), 0.0))
    heavy_r = np.repeat(np.arange(4, dtype=np.int32), 8)
    heavy_c = rng.integers(0, 24, heavy_r.size).astype(np.int32)
    empty = (np.zeros(0, np.int32),) * 2 + (np.zeros(0, np.float32),)
    skew = coo_from_lists(
        [(heavy_r, heavy_c, rng.normal(size=heavy_r.size).astype(np.float32)),
         (np.array([0, 5], np.int32), np.array([1, 2], np.int32),
          rng.normal(size=2).astype(np.float32)), empty], [24, 24, 24])
    zero = coo_from_lists([empty, empty], [16, 16])
    return [("uniform", uni.to(device), m_uni), ("skewed", skew.to(device), 24),
            ("zero_nnz", zero.to(device), 16)]


def _powerlaw_channels(device, channels: int = 4):
    """``channels`` degree-skewed batches drawn one after the other from one
    seed-0 generator (the first is the reference's powerlaw geometry), on
    ``device``, and their m_pad."""
    import numpy as np
    from repro_torch.core.formats import random_powerlaw_batch

    rng = np.random.default_rng(0)
    adj = []
    for _ in range(channels):
        coo, m_pad = random_powerlaw_batch(rng, **POWERLAW)
        adj.append(coo.to(device))
    return adj, m_pad


def _on(batch, device):
    """A training batch's tensors on ``device``."""
    return {"adj": [a.to(device) for a in batch["adj"]],
            "x": batch["x"].to(device), "n_nodes": batch["n_nodes"].to(device),
            "labels": batch["labels"].to(device)}


def _train_batches(spec, batch: int):
    from repro_torch.data.graphs import batches, generate

    return list(batches(generate(spec), spec, batch))


def _measure(rows, key, kernel, kern, plain, nbytes, flops, shape,
             library=None, bitwise=False, tol=F32_TOL,
             flop_rate=F32_FLOP_PER_S, iters=30, replays=5, library_tol=None):
    """Hold ``kern()`` against ``plain()`` within ``tol`` (and
    ``library()`` when given within ``library_tol``, by default ``tol``, and
    two calls for identical bits when ``bitwise``), then time all three by
    CUDA-graph replay (``iters`` calls replayed ``replays`` times), and the
    kernel by back-to-back calls too; adds the row ``key`` of kernel
    ``kernel``."""
    import torch

    got = kern()
    err = max_err(got, plain(), key, tol)
    if bitwise:
        check(torch.equal(got, kern()), f"{key}: two calls differ")
    if library is not None:
        max_err(library(), plain(), f"{key} library call",
                library_tol or tol)
    b_ms, b_by = bound(nbytes, flops, flop_rate)
    timed = dict(iters=iters, replays=replays)
    rows[key] = dict(
        name=key, kernel=kernel, max_abs_err=err, ms=graph_ms(kern, **timed),
        stream_ms=cuda_ms(kern, iters=iters),
        plain_ms=graph_ms(plain, **timed), bound_ms=b_ms, bound_by=b_by,
        library_ms=None if library is None else graph_ms(library, **timed),
        shape=shape)


def _fork_times(tag, a, b, m_pad, k_pad):
    """The two entries of the ELL and GEMM kernels at a shape the batched
    entries take: the batched and the large-matrix entry on the same inputs
    (f32 and, for ELL, bf16 and i8) must give the same bits, and both are
    timed by graph replay, in the order batched, large, large, batched, and
    each time is printed on a [fork] line, the GEMM's beside its library
    call (``torch.bmm`` on the same inputs). (Each kernel has one design at
    every plan: the ELL and CSR kernels read B through the L2, the GEMM
    streams K, so the two entries launch the same kernel, counted apart;
    the lines show that they stay one function and one time.)"""
    import torch
    from repro_torch.core.formats import coo_to_dense, coo_to_ell, \
        narrow_col_ids, quantize_values_i8
    from repro_torch.kernels.batched_gemm import batched_gemm, \
        batched_gemm_large
    from repro_torch.kernels.batched_spmm_ell import batched_spmm_ell, \
        batched_spmm_ell_bf16, batched_spmm_ell_i8, batched_spmm_ell_large, \
        batched_spmm_ell_large_bf16, batched_spmm_ell_large_i8

    bf = torch.bfloat16
    ell = coo_to_ell(a, m_pad, k_pad)
    codes, scale = quantize_values_i8(a.values)
    ell_q = coo_to_ell(a.with_values(codes), m_pad, k_pad)
    e16, eq16 = (narrow_col_ids(t, m_pad) for t in (ell.col_ids,
                                                     ell_q.col_ids))
    eh, bh = ell.values.to(bf), b.to(bf)
    dense = coo_to_dense(a, m_pad).contiguous()
    pairs = [
        ("batched_spmm_ell",
         lambda f: f(ell.col_ids, ell.values, b),
         batched_spmm_ell, batched_spmm_ell_large),
        ("batched_spmm_ell_bf16", lambda f: f(e16, eh, bh),
         batched_spmm_ell_bf16, batched_spmm_ell_large_bf16),
        ("batched_spmm_ell_i8", lambda f: f(eq16, ell_q.values, scale, b),
         batched_spmm_ell_i8, batched_spmm_ell_large_i8),
        ("batched_gemm", lambda f: f(dense, b), batched_gemm,
         batched_gemm_large)]
    for name, call, batched, large in pairs:
        kb, kl = (lambda: call(batched)), (lambda: call(large))
        check(torch.equal(kb(), kl()),
              f"fork[{tag}] {name}: the two branches differ")
        t = [graph_ms(f) for f in (kb, kl, kl, kb)]
        lib = (f", library (torch.bmm) {graph_ms(lambda: torch.bmm(dense, b))}"
               " ms" if name == "batched_gemm" else "")
        log(f"[fork] {tag} {name}: batched {t[0]} / {t[3]} ms, large "
            f"{t[1]} / {t[2]} ms (identical bits){lib}")


def _hybrid_work(ops, b, d_pad):
    """What the hybrid kernel must move and compute on prepared operands
    ``ops`` (those of ``hybrid_operands``) and B: (bytes, operations,
    sparse slots, hub rows, bytes over the whole d_pad slab). Bytes: the
    hub counts, rank, start and rlen, each sparse slot's id and value, the
    slab rows up to each sample's hub count, B read once and C written
    once; operations: the sparse slots' and the hub rows' products."""
    rank, _, rl, cid, val, slab, hubs = ops
    m_pad, n_b = b.shape[1], b.shape[2]
    sparse = int(rl.sum().item())
    hub_rows = 0 if slab is None else int(hubs.sum().item())
    fixed = (hubs.numel() * 4 + 3 * rank.numel() * 4
             + sparse * (cid.element_size() + val.element_size())
             + 2 * b.numel() * b.element_size())
    slab_row = m_pad * val.element_size()
    return (fixed + hub_rows * slab_row, 2 * (sparse + hub_rows * m_pad) * n_b,
            sparse, hub_rows, fixed + rank.shape[0] * d_pad * slab_row)


def _panel_times(key, call, want, tol, plan):
    """The fused kernel at its planner's panel width and the other widths
    it could take (16 to 128 columns, at most the layer's width): each
    checked against ``want`` within ``tol`` and timed by graph replay; one
    [panels] line."""
    import dataclasses

    times = {}
    for nb in (16, 32, 64, 128):
        if nb > max(plan.n_b, 16):
            break
        p = -(-plan.n_b // nb)
        pl = dataclasses.replace(plan, n_block=nb, p=p,
                                 case=1 if p == 1 else 2)
        max_err(call(pl), want, f"{key} at n_block {nb}", tol)
        times[nb] = graph_ms(lambda pl=pl: call(pl))
    log(f"[panels] {key}: " + ", ".join(
        f"n_block {nb} {ms:.4f} ms" for nb, ms in times.items())
        + f" (the planner's: {plan.n_block})")


def _fused_hmma() -> dict:
    """HMMA (mma.sync) instructions in the SASS of each instance of the
    fused kernel and of the large-matrix branch's transform, keyed by
    (entry, tile columns, tile rows, large); the large branch's transform
    serves the f32 and hybrid entries alike ("f32")."""
    import re

    from repro_torch.kernels import _build

    out = {}
    for kernel, large in (("fused_kernel", False), ("large_transform", True)):
        try:
            counts = _build.sass_count("fused_graph_conv", kernel, "HMMA")
        except RuntimeError as e:
            raise SmokeFailure(str(e)) from e
        for fn, n in counts.items():
            tn, tm, hybrid = re.search(r"Li(\d+)ELi(\d+)E(?:Lb([01])E)?",
                                       fn).groups()
            entry = ("bf16" if "bfloat16" in fn else
                     "hybrid f32" if hybrid == "1" else "f32")
            out[(entry, int(tn), int(tm), large)] = n
    return out


def phase_kernels(device):
    """Each kernel against its plain version; times at the main-path shapes.
    Returns (rows, the largest error of each kernel over every check)."""
    import numpy as np
    import torch
    from repro_torch.core.formats import BatchedCOO, coo_to_csr, \
        coo_to_dense, coo_to_ell, csr_transpose, max_row_degree
    from repro_torch.core.gcn import GCNConfig
    from repro_torch.core.graph_conv import flatten_channels, stack_channels
    from repro_torch.data.graphs import GraphDatasetSpec
    from repro_torch.kernels import ref
    from repro_torch.kernels.batched_spmm_coo import batched_spmm_coo
    from repro_torch.kernels.batched_spmm_csr import batched_spmm_csr
    from repro_torch.kernels.batched_spmm_ell import batched_spmm_ell
    from repro_torch.core.batching import plan_hybrid
    from repro_torch.core.formats import coo_from_lists, row_degrees
    from repro_torch.kernels.batched_gemm import batched_gemm
    from repro_torch.kernels.batched_spmm_hybrid import \
        batched_spmm_hybrid, hybrid_launch, hybrid_operands
    from repro_torch.core.batching import plan_fused_graph_conv
    from repro_torch.kernels.fused_graph_conv import fused_forward, \
        fused_hybrid_forward, fused_hybrid_operands, runtime_chunks
    from repro_torch.serving.engine import GraphServeEngine

    rows = {}
    gen = torch.Generator(device="cpu").manual_seed(1)

    # -- the Tox21 serving path: the first wave of the serving phase -------
    cfg = GCNConfig.tox21(impl="fused", bn_mode="sample")
    params = _params(cfg, 0, device)
    wave = GraphServeEngine(params, cfg, device=device, **TOX21).assemble(
        _requests(GraphDatasetSpec.tox21_like(TOX21["batch"], seed=0)))
    conv = params["convs"][0]
    m_pad = TOX21["m_pad"]

    # stacked SpMMs: B = X·W_ch + b_ch for every (channel, sample)
    a_flat = flatten_channels(wave.adj)
    u = (torch.einsum("bmn,cnf->cbmf", wave.x, conv["w"])
         + conv["b"][:, None, None, :]).reshape(-1, m_pad, 64).contiguous()
    nnz = int(a_flat.nnz.sum().item())
    ell = coo_to_ell(a_flat, m_pad, cfg.k_pad)
    a_dense = coo_to_dense(a_flat, m_pad)
    io = 2 * u.numel() * 4                       # B read once, C written once
    flops = 2 * nnz * u.shape[-1]
    shape = (f"{u.shape[0]} matrices x {m_pad} rows, k_pad {cfg.k_pad}, "
             f"nnz_pad {a_flat.nnz_pad}, n_b 64, {nnz} real nnz")
    _measure(rows, "batched_spmm_ell", "batched_spmm_ell",
             lambda: batched_spmm_ell(ell.col_ids, ell.values, u),
             lambda: ref.batched_spmm_ell_plain(ell.col_ids, ell.values, u),
             io + nnz * 8, flops, shape, lambda: torch.bmm(a_dense, u))
    _measure(rows, "batched_spmm_coo", "batched_spmm_coo",
             lambda: batched_spmm_coo(a_flat.row_ids, a_flat.col_ids,
                                      a_flat.values, u),
             lambda: ref.batched_spmm_coo_plain(a_flat.row_ids, a_flat.col_ids,
                                                a_flat.values, u),
             io + nnz * 12, flops, shape, lambda: torch.bmm(a_dense, u),
             bitwise=True)

    # fused layers: Tox21 layer 1 and Reaction100 layer 2 (n_in 512)
    def fused_case(tag, adj, x, w, bias, n_nodes):
        rid, cid, val, nnz_sc = stack_channels(adj)
        chunks = runtime_chunks(nnz_sc)
        live = int((chunks > 0).sum().item())
        # the transform this data needs: real rows of each live channel
        live_rows = int(((chunks > 0) * n_nodes[:, None]).sum().item())
        real = int(nnz_sc.sum().item())
        n_in, n_out = x.shape[-1], w.shape[-1]
        dense = torch.stack([coo_to_dense(a, m_pad) for a in adj])  # ch,b,m,m

        def library():
            uu = torch.einsum("bmn,cnf->cbmf", x, w) + bias[:, None, None, :]
            return torch.matmul(dense, uu).sum(dim=0)

        nbytes = (real * 12 + chunks.numel() * 4 + x.numel() * 4
                  + w.numel() * 4 + bias.numel() * 4 + x.shape[0] * m_pad
                  * n_out * 4)
        plain = ref.fused_graph_conv_plain(rid, cid, val, chunks, x, w, bias)
        _measure(rows, f"fused_forward[{tag}]", "fused_forward",
                 lambda: fused_forward(rid, cid, val, chunks, x, w, bias),
                 lambda: ref.fused_graph_conv_plain(rid, cid, val, chunks, x,
                                                    w, bias),
                 nbytes, 2 * real * n_out + 2 * live_rows * n_in * n_out,
                 f"{x.shape[0]} samples x {w.shape[0]} channels, m_pad "
                 f"{m_pad}, n_in {n_in} -> n_out {n_out}, {real} real nnz, "
                 f"{live} live (sample, channel) pairs", library)
        _panel_times(f"fused_forward[{tag}]", lambda plan: fused_forward(
            rid, cid, val, chunks, x, w, bias, plan=plan), plain,
            F32_TOL, plan_fused_graph_conv(
                batch=x.shape[0], m_pad=m_pad, n_in=n_in, n_out=n_out))

    fused_case("tox21", wave.adj, wave.x, conv["w"], conv["b"], wave.n_nodes)
    # Reaction100 layer 2 (512 -> 512): a real wave's adjacency and layer
    # weights, with a random masked stand-in for the layer-1 activations
    r_cfg = GCNConfig.reaction100(impl="fused", bn_mode="sample")
    r_params = _params(r_cfg, 0, device)
    rw = GraphServeEngine(r_params, r_cfg, device=device, **TOX21).assemble(
        _requests(GraphDatasetSpec.reaction100_like(TOX21["batch"], seed=0)))
    x2 = torch.randn((TOX21["batch"], m_pad, 512), generator=gen).to(device)
    x2 *= (torch.arange(m_pad, device=device)[None, :, None]
           < rw.n_nodes[:, None, None])
    conv2 = r_params["convs"][1]
    fused_case("reaction100", rw.adj, x2, conv2["w"], conv2["b"], rw.n_nodes)

    # both branches of ELL and GEMM at Tox21 serving and at
    # Reaction100 layer 2's stacked SpMM (n_b 512)
    _fork_times("tox21", a_flat, u, m_pad, cfg.k_pad)
    r_flat = flatten_channels(rw.adj)
    u2 = (torch.einsum("bmn,cnf->cbmf", x2, conv2["w"])
          + conv2["b"][:, None, None, :]).reshape(-1, m_pad, 512)
    _fork_times("reaction100 layer 2", r_flat, u2.contiguous(), m_pad,
                r_cfg.k_pad)
    del u2

    # -- the training path: the first Tox21 batch of phase 6, layer 1 ------
    tb = _on(_train_batches(GraphDatasetSpec.tox21_like(
        TRAIN_TOX21["n_samples"], seed=0), TRAIN_TOX21["batch"])[0], device)
    t_flat = flatten_channels(tb["adj"])
    t_m = tb["x"].shape[1]
    t_u = (torch.einsum("bmn,cnf->cbmf", tb["x"], conv["w"])
           + conv["b"][:, None, None, :]).reshape(-1, t_m, 64).contiguous()
    t_nnz = int(t_flat.nnz.sum().item())
    n_mat = t_u.shape[0]
    t_shape = (f"{n_mat} matrices x {t_m} rows, nnz_pad {t_flat.nnz_pad}, "
               f"n_b 64, {t_nnz} real nnz")

    def swapped(a):
        return BatchedCOO(a.col_ids, a.row_ids, a.values, a.nnz, a.n_rows)

    def csr_rows(key, a, b, shape):
        csr = coo_to_csr(a, t_m)
        dense = coo_to_dense(a, t_m)
        _measure(rows, key, "batched_spmm_csr",
                 lambda: batched_spmm_csr(csr.rpt, csr.col_ids, csr.values, b),
                 lambda: ref.batched_spmm_csr_plain(csr.rpt, csr.col_ids,
                                                    csr.values, b),
                 csr.rpt.numel() * 4 + t_nnz * 8 + 2 * b.numel() * 4,
                 2 * t_nnz * b.shape[-1], shape,
                 lambda: torch.bmm(dense, b), bitwise=True)

    # forward of pallas_csr, then its dB: the same kernel on the transposed
    # CSR (the swapped COO re-sorted, as ops.backward_db does)
    csr_rows("batched_spmm_csr", t_flat, t_u, t_shape)
    dc = torch.randn(tuple(t_u.shape), generator=gen).to(device)
    csr_rows("batched_spmm_csr[dB, transposed CSR]", swapped(t_flat), dc,
             t_shape)

    # the COO kernel as dU = Aᵀ·dZ of the fused backward: every slot, ids
    # swapped, at Tox21 (n_b 64) and Reaction100 (batch 100, n_b 512) width
    def coo_du(key, a, n_b, m):
        dz = torch.randn((a.batch, m, n_b), generator=gen).to(device)
        at = swapped(a)
        real = int(a.nnz.sum().item())
        dense = coo_to_dense(at, m)
        _measure(rows, key, "batched_spmm_coo",
                 lambda: batched_spmm_coo(at.row_ids, at.col_ids, at.values,
                                          dz),
                 lambda: ref.batched_spmm_coo_plain(at.row_ids, at.col_ids,
                                                    at.values, dz),
                 2 * dz.numel() * 4 + real * 12, 2 * real * n_b,
                 f"{a.batch} matrices x {m} rows, nnz_pad {a.nnz_pad}, n_b "
                 f"{n_b}, {real} real nnz", lambda: torch.bmm(dense, dz),
                 bitwise=True)

    coo_du("batched_spmm_coo[dU, tox21 training]", t_flat, 64, t_m)
    rb = _on(_train_batches(GraphDatasetSpec.reaction100_like(
        TRAIN_R100["batch"] * TRAIN_R100["steps"], seed=0),
        TRAIN_R100["batch"])[0], device)
    coo_du("batched_spmm_coo[dU, reaction100 training]",
           flatten_channels(rb["adj"]), 512, rb["x"].shape[1])

    # -- the hybrid split: the kernel on prepared operands (the prep timed
    # apart), the whole wrapper against the COO product ------------------
    def hybrid_row(tag, a, b, m):
        hp = plan_hybrid(batch=a.batch, m_pad=m, n_b=b.shape[-1],
                         nnz_pad=a.nnz_pad)
        h_ops = hybrid_operands(a.row_ids, a.col_ids, a.values, a.nnz, m,
                                hp)
        nbytes, flops, sparse, hubs, whole = _hybrid_work(h_ops, b, hp.d_pad)
        real = int(a.nnz.sum().item())
        dense = coo_to_dense(a, m)
        key = f"batched_spmm_hybrid[{tag}]"
        _measure(rows, key, "batched_spmm_hybrid",
                 lambda: hybrid_launch(*h_ops, b, plan=hp),
                 lambda: ref.batched_spmm_hybrid_plain(*h_ops, b),
                 nbytes, flops,
                 f"{a.batch} matrices x {m} rows, nnz_pad {a.nnz_pad}, n_b "
                 f"{b.shape[-1]}, {real} real nnz ({sparse} in the CSR "
                 f"remainder), dmin {hp.dmin}, d_pad {hp.d_pad}, "
                 f"{hubs / a.batch:.3f} hub rows per matrix, n_block "
                 f"{hp.spmm.n_block}",
                 lambda: torch.bmm(dense, b), bitwise=True)
        log(f"[bound] {key}: {rows[key]['bound_ms']:.4f} ms over the slab "
            f"rows up to each hub count ({hubs} rows), "
            f"{bound(whole, flops)[0]:.4f} ms by bytes over all "
            f"{a.batch * hp.d_pad} d_pad rows")
        rows[key]["prep_ms"] = cuda_ms(lambda: hybrid_operands(
            a.row_ids, a.col_ids, a.values, a.nnz, m, hp))
        max_err(batched_spmm_hybrid(a.row_ids, a.col_ids, a.values, a.nnz, b,
                                    plan=hp),
                ref.batched_spmm_coo_ref(a, b, m), f"{key} wrapper vs COO")

    pl_adj, pl_m = _powerlaw_channels(device)
    pl_b = torch.randn((POWERLAW["batch"], pl_m, 64), generator=gen).to(
        device)
    hybrid_row("powerlaw", pl_adj[0], pl_b, pl_m)
    # the COO kernel at the powerlaw batch's first channel: hub rows, each
    # summed by one sub-warp
    pl = pl_adj[0]
    pl_real = int(pl.nnz.sum().item())
    pl_dense = coo_to_dense(pl, pl_m)
    pl_deg = row_degrees(pl, pl_m)
    _measure(rows, "batched_spmm_coo[powerlaw]", "batched_spmm_coo",
             lambda: batched_spmm_coo(pl.row_ids, pl.col_ids, pl.values,
                                      pl_b),
             lambda: ref.batched_spmm_coo_plain(pl.row_ids, pl.col_ids,
                                                pl.values, pl_b),
             2 * pl_b.numel() * 4 + pl_real * 12, 2 * pl_real * 64,
             f"{pl.batch} matrices x {pl_m} rows, nnz_pad {pl.nnz_pad}, n_b "
             f"64, {pl_real} real nnz, longest row {int(pl_deg.max())} "
             f"slots, {int((pl_deg >= 64).sum()) / pl.batch:.3f} rows of 64 "
             "or more a matrix", lambda: torch.bmm(pl_dense, pl_b),
             bitwise=True)
    # the CSR kernel there: a sub-warp sums each row, hub rows whole
    pl_csr = coo_to_csr(pl, pl_m)
    _measure(rows, "batched_spmm_csr[powerlaw]", "batched_spmm_csr",
             lambda: batched_spmm_csr(pl_csr.rpt, pl_csr.col_ids,
                                      pl_csr.values, pl_b),
             lambda: ref.batched_spmm_csr_plain(pl_csr.rpt, pl_csr.col_ids,
                                                pl_csr.values, pl_b),
             pl_csr.rpt.numel() * 4 + 2 * pl_b.numel() * 4 + pl_real * 8,
             2 * pl_real * 64, rows["batched_spmm_coo[powerlaw]"]["shape"],
             lambda: torch.bmm(pl_dense, pl_b), bitwise=True)
    hybrid_row("tox21", a_flat, u, m_pad)
    a_dense_c = a_dense.contiguous()
    _measure(rows, "batched_gemm[tox21]", "batched_gemm",
             lambda: batched_gemm(a_dense_c, u),
             lambda: ref.batched_gemm_plain(a_dense_c, u),
             (a_dense_c.numel() + 2 * u.numel()) * 4,
             2 * a_dense_c.numel() * u.shape[-1],
             f"{u.shape[0]} dense {m_pad} x {m_pad} adjacencies x (n_b 64)",
             lambda: torch.bmm(a_dense_c, u), bitwise=True)

    # the fused layer with the hybrid split: the kernel on prepared
    # operands, the prep timed apart, the whole layer against the plain
    # fused layer
    def fused_hybrid_case(tag, adj, x, w, bias, n_nodes):
        rid, cid, val, nnz_sc = stack_channels(adj)
        batch, channels, nnz_pad = rid.shape
        m, n_in, n_out = x.shape[1], x.shape[-1], w.shape[-1]
        hp = plan_hybrid(batch=batch, m_pad=m, n_b=n_out,
                         nnz_pad=channels * nnz_pad)
        ops_ = fused_hybrid_operands(rid, cid, val, m, hp)
        rid_s, cid_s, val_s, chunks, rank, slab, hub_n = ops_
        sparse = int(((val_s != 0) & (rid_s < m)).sum().item())
        real = int(nnz_sc.sum().item())
        # the transform this data needs: real rows of each channel with a
        # non-zero; the head's products where the slab holds a value
        live_rows = int(((nnz_sc > 0) * n_nodes[:, None]).sum().item())
        deg = sum(row_degrees(a, m) for a in adj)
        hubs = int((deg >= hp.dmin).sum().item())
        dense = torch.stack([coo_to_dense(a, m) for a in adj])

        def library():
            uu = torch.einsum("bmn,cnf->cbmf", x, w) + bias[:, None, None, :]
            return torch.matmul(dense, uu).sum(dim=0)

        nbytes = (sparse * 12 + chunks.numel() * 4 + x.numel() * 4
                  + w.numel() * 4 + bias.numel() * 4 + rank.numel() * 4
                  + slab.numel() * 4 + batch * m * n_out * 4)
        flops = (2 * (sparse + int((slab != 0).sum().item())) * n_out
                 + 2 * live_rows * n_in * n_out)
        key = f"fused_hybrid_forward[{tag}]"
        _measure(rows, key, "fused_hybrid_forward",
                 lambda: fused_forward(rid_s, cid_s, val_s, chunks, x, w,
                                       bias, None, rank, slab, hubs=hub_n),
                 lambda: ref.fused_graph_conv_plain(
                     rid_s, cid_s, val_s, chunks, x, w, bias, None, "none",
                     rank, slab),
                 nbytes, flops,
                 f"{batch} samples x {channels} channels, m_pad {m}, n_in "
                 f"{n_in} -> n_out {n_out}, {real} real nnz ({sparse} "
                 f"scattered), dmin {hp.dmin}, d_pad {hp.d_pad}, "
                 f"{hubs / batch:.3f} hub rows per sample", library)
        rows[key]["prep_ms"] = cuda_ms(
            lambda: fused_hybrid_operands(rid, cid, val, m, hp))
        plain = ref.fused_graph_conv_plain(rid, cid, val,
                                           runtime_chunks(nnz_sc), x, w, bias)
        max_err(fused_hybrid_forward(rid, cid, val, nnz_sc, x, w, bias,
                                     hplan=hp), plain, f"{key} layer vs fused")
        # the head bounded by each sample's hub count against the head over
        # all d_pad slab rows: one launch each, the same result
        n0 = fused_hybrid_forward.launches

        def full():
            return fused_forward(rid_s, cid_s, val_s, chunks, x, w, bias,
                                 None, rank, slab)

        bounded = fused_forward(rid_s, cid_s, val_s, chunks, x, w, bias,
                                None, rank, slab, hubs=hub_n)
        whole = full()
        check(fused_hybrid_forward.launches == n0 + 2,
              f"{key}: {fused_hybrid_forward.launches - n0} launches for two "
              "calls")
        max_err(bounded, whole, f"{key} head bounded by hubs vs all d_pad "
                                "rows")
        log(f"[hubs] {key}: head over {int(hub_n.sum().item())} hub rows "
            f"of {batch * hp.d_pad} slab rows: {rows[key]['ms']:.4f} ms, "
            f"over all d_pad rows {graph_ms(full):.4f} ms (same result, one "
            "launch each)")
        _panel_times(key, lambda plan: fused_forward(
            rid_s, cid_s, val_s, chunks, x, w, bias, None, rank, slab,
            plan=plan, hubs=hub_n), plain, F32_TOL, plan_fused_graph_conv(
                batch=batch, m_pad=m, n_in=n_in, n_out=n_out))

    fused_hybrid_case("tox21", wave.adj, wave.x, conv["w"], conv["b"],
                      wave.n_nodes)
    fused_hybrid_case("reaction100", rw.adj, x2, conv2["w"], conv2["b"],
                      rw.n_nodes)
    pl_x = torch.nn.functional.one_hot(
        torch.randint(0, 62, (POWERLAW["batch"], pl_m), generator=gen),
        62).float().to(device)
    fused_hybrid_case("powerlaw", pl_adj, pl_x, conv["w"], conv["b"],
                      torch.full((POWERLAW["batch"],), pl_m, device=device))

    errs = {}
    for r in rows.values():
        errs[r["kernel"]] = max(errs.get(r["kernel"], 0.0), r["max_abs_err"])

    # -- the three regimes, small sizes -----------------------------------
    for rname, coo, mp in _regimes(device):
        k_pad = max(1, int(max_row_degree(coo, mp).max().item()))
        b = torch.randn((coo.batch, mp, 48), generator=gen).to(device)
        e = coo_to_ell(coo, mp, k_pad)
        csr = coo_to_csr(coo, mp)
        csr_t = csr_transpose(csr)
        checks = [
            ("batched_spmm_ell", lambda: batched_spmm_ell(e.col_ids, e.values,
                                                          b),
             lambda: ref.batched_spmm_ell_plain(e.col_ids, e.values, b)),
            ("batched_spmm_coo",
             lambda: batched_spmm_coo(coo.row_ids, coo.col_ids, coo.values,
                                      b),
             lambda: ref.batched_spmm_coo_plain(coo.row_ids, coo.col_ids,
                                                coo.values, b))]
        for c in (csr, csr_t):
            checks.append((
                "batched_spmm_csr",
                lambda c=c: batched_spmm_csr(c.rpt, c.col_ids, c.values, b),
                lambda c=c: ref.batched_spmm_csr_plain(c.rpt, c.col_ids,
                                                       c.values, b)))
        for kname, kern, plain in checks:
            got = kern()
            errs[kname] = max(errs[kname], max_err(got, plain(),
                                                   f"{kname} {rname}"))
            if kname == "batched_spmm_csr":
                check(torch.equal(got, kern()),
                      f"{kname} {rname}: two calls differ")
        perm = torch.randperm(coo.nnz_pad, generator=gen).to(device)
        adj2 = [coo, coo.__class__(coo.row_ids[:, perm], coo.col_ids[:, perm],
                                   coo.values[:, perm], coo.nnz, coo.n_rows)]
        rid, cid, val, nnz_sc = stack_channels(adj2)
        x = torch.randn((coo.batch, mp, 12), generator=gen).to(device)
        w = torch.randn((2, 12, 40), generator=gen).to(device) / 4
        bias = torch.randn((2, 40), generator=gen).to(device)
        res = torch.randn((coo.batch, mp, 40), generator=gen).to(device)
        for epi, r in (("none", None), ("relu", res)):
            got = fused_forward(rid, cid, val, runtime_chunks(nnz_sc), x, w,
                                bias, r, epilogue=epi)
            want = ref.fused_graph_conv_plain(rid, cid, val,
                                              runtime_chunks(nnz_sc), x, w,
                                              bias, r, epi)
            errs["fused_forward"] = max(errs["fused_forward"], max_err(
                got, want, f"fused_forward {rname} {epi}"))
        hp = plan_hybrid(batch=coo.batch, m_pad=mp, n_b=48,
                         nnz_pad=coo.nnz_pad)
        h_args = hybrid_operands(coo.row_ids, coo.col_ids, coo.values,
                                 coo.nnz, mp, hp)
        got = hybrid_launch(*h_args, b, plan=hp)
        errs["batched_spmm_hybrid"] = max(
            errs["batched_spmm_hybrid"],
            max_err(got, ref.batched_spmm_hybrid_plain(*h_args, b),
                    f"batched_spmm_hybrid {rname}"))
        check(torch.equal(got, hybrid_launch(*h_args, b, plan=hp)),
              f"batched_spmm_hybrid {rname}: two calls differ")
        dense = coo_to_dense(coo, mp).contiguous()
        errs["batched_gemm"] = max(errs["batched_gemm"], max_err(
            batched_gemm(dense, b), ref.batched_gemm_plain(dense, b),
            f"batched_gemm {rname}"))
        fh = plan_hybrid(batch=coo.batch, m_pad=mp, n_b=40,
                         nnz_pad=2 * coo.nnz_pad)
        if fh.d_pad:
            f_ops = fused_hybrid_operands(rid, cid, val, mp, fh)
            got = fused_forward(*f_ops[:4], x, w, bias, res, *f_ops[4:6],
                                epilogue="relu", hubs=f_ops[6])
            want = ref.fused_graph_conv_plain(*f_ops[:4], x, w, bias, res,
                                              "relu", *f_ops[4:])
            errs["fused_hybrid_forward"] = max(
                errs["fused_hybrid_forward"],
                max_err(got, want, f"fused_hybrid_forward {rname}"))
        log(f"[kernels] regime {rname}: ELL, COO, CSR (A and its transpose, "
            f"identical bits twice), hybrid (identical bits twice, d_pad "
            f"{hp.d_pad}), GEMM and fused (none, relu + residual; hybrid "
            f"branch with d_pad {fh.d_pad}) match their plain versions")
    # the hybrid kernel without a slab: nnz_pad below the hub threshold
    tri = [(np.array([0, 1, 2], np.int32), np.array([5, 6, 7], np.int32),
            np.array([1.0, -2.0, 0.5], np.float32))] * 2
    small = coo_from_lists(tri, [64, 64]).to(device)
    hp = plan_hybrid(batch=2, m_pad=64, n_b=16, nnz_pad=small.nnz_pad)
    check(hp.d_pad == 0, f"{hp}: expected no slab")
    b = torch.randn((2, 64, 16), generator=gen).to(device)
    h_ops = hybrid_operands(small.row_ids, small.col_ids, small.values,
                            small.nnz, 64, hp)
    check(h_ops[5] is None, "d_pad 0 built a slab")
    errs["batched_spmm_hybrid"] = max(
        errs["batched_spmm_hybrid"],
        max_err(hybrid_launch(*h_ops, b, plan=hp),
                ref.batched_spmm_hybrid_plain(*h_ops, b),
                "batched_spmm_hybrid d_pad 0"))
    log("[kernels] batched_spmm_hybrid with d_pad 0 (nnz_pad "
        f"{small.nnz_pad} < dmin {hp.dmin}, no slab) matches its plain "
        "version")
    _log_rows(rows.values())
    return rows, errs


def _log_rows(rows):
    """One [kernels] line per timed row."""
    for r in rows:
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        prep = ("" if "prep_ms" not in r else
                f", PyTorch prep (back-to-back) {r['prep_ms']:.4f} ms")
        log(f"[kernels] {r['name']}: {r['shape']}: kernel {r['ms']:.4f} ms "
            f"(back-to-back calls {r['stream_ms']:.4f} ms), plain "
            f"{r['plain_ms']:.4f} ms, library {lib}, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}){prep}, max abs err "
            f"{r['max_abs_err']:.3e}")


def _library_gspmm(a, b, values, op, reduce):
    """The PyTorch calls that compute the same g-SpMM as one call of a
    kernel (its library yardstick, never used by the port): ``index_select``
    of every valid slot's B row, the combine, then ``index_add_`` (sum) or
    ``scatter_reduce_`` (amax / mean, rows without an edge left 0) into the
    flattened output rows. The valid slots' flat indices are found before,
    outside the timed calls."""
    import torch

    batch, m, n_b = b.shape
    slot = torch.arange(a.nnz_pad, device=b.device)
    s_idx, i_idx = (slot[None, :] < a.nnz[:, None]).nonzero(as_tuple=True)
    rows = s_idx * m + a.row_ids[s_idx, i_idx].long()
    cols = s_idx * m + a.col_ids[s_idx, i_idx].long()
    e = values[s_idx, i_idx]
    e = e[:, None] if e.dim() == 1 else e
    b_flat = b.reshape(-1, n_b)

    def run():
        msg = b_flat.index_select(0, cols)
        if op == "mul":
            msg = msg * e
        elif op == "add":
            msg = msg + e
        out = torch.zeros((batch * m, n_b), device=b.device)
        if reduce == "sum":
            out.index_add_(0, rows, msg)
        else:
            out.scatter_reduce_(0, rows[:, None].expand_as(msg), msg,
                                "amax" if reduce == "max" else "mean",
                                include_self=False)
        return out.view(batch, m, n_b)

    return run


def phase_gnn_kernels(device, rows, errs):
    """The g-SpMM entries of the ELL, CSR and COO kernels and the grouped
    matmul against their plain versions: at the GAT and R-GCN shapes of the
    main paths (timed, with bounds and library calls), on every (op,
    reduce) corner of the three regimes, max corners bitwise, the ELL and
    CSR entries and the grouped matmul with identical bits twice. Adds to
    ``rows`` and ``errs``."""
    import torch
    from repro_torch.core.formats import coo_to_csr, coo_to_ell, \
        max_row_degree, row_degrees
    from repro_torch.core.gcn import GCNConfig
    from repro_torch.core.graph_conv import flatten_channels
    from repro_torch.data.graphs import GraphDatasetSpec
    from repro_torch.kernels import ref
    from repro_torch.kernels.batched_spmm_coo import batched_spmm_coo
    from repro_torch.kernels.batched_spmm_csr import batched_spmm_csr
    from repro_torch.kernels.batched_spmm_ell import batched_spmm_ell
    from repro_torch.kernels.grouped_matmul import _gmm, _row_groups, \
        _visited_groups, gmm_tile, THREAD_ROWS
    from repro_torch.kernels.segment_softmax import segment_softmax
    from repro_torch.serving.engine import GraphServeEngine

    gen = torch.Generator(device="cpu").manual_seed(2)
    m_pad = TOX21["m_pad"]
    before = set(rows)

    def gspmm_rows(tag, a, b, values, op, reduce, k_pad=8):
        """Times of the three kernels' g-SpMM entries on one workload."""
        batch, m, n_b = b.shape
        real = int(a.nnz.sum().item())
        e_bytes = 0 if op == "copy_lhs" else real * 4 * (
            n_b if values.dim() == 3 else 1)
        io = 2 * b.numel() * 4 + e_bytes
        flops = real * n_b * (1 if op == "copy_lhs" else 2)
        shape = (f"{batch} matrices x {m} rows, nnz_pad {a.nnz_pad}, n_b "
                 f"{n_b}, {real} real nnz, ({op}, {reduce}), "
                 + ("vector" if values.dim() == 3 else "scalar") + " edges")
        kw = dict(op=op, reduce=reduce)
        library = _library_gspmm(a, b, values, op, reduce)
        csr = coo_to_csr(a.with_values(values), m)
        _measure(rows, f"batched_spmm_csr[g-SpMM, {tag}]", "batched_spmm_csr",
                 lambda: batched_spmm_csr(csr.rpt, csr.col_ids, csr.values, b,
                                          **kw),
                 lambda: ref.batched_gspmm_csr_plain(csr.rpt, csr.col_ids,
                                                     csr.values, b, **kw),
                 io + csr.rpt.numel() * 4 + real * 4, flops, shape, library,
                 bitwise=True)
        rlen = row_degrees(a, m)
        ell = coo_to_ell(a.with_values(values), m, k_pad)
        _measure(rows, f"batched_spmm_ell[g-SpMM, {tag}]", "batched_spmm_ell",
                 lambda: batched_spmm_ell(ell.col_ids, ell.values, b,
                                          rlen=rlen, **kw),
                 lambda: ref.batched_gspmm_ell_plain(ell.col_ids, ell.values,
                                                     rlen, b, **kw),
                 io + rlen.numel() * 4 + real * 4, flops,
                 f"{shape}, k_pad {k_pad}", library, bitwise=True)
        _measure(rows, f"batched_spmm_coo[g-SpMM, {tag}]", "batched_spmm_coo",
                 lambda: batched_spmm_coo(a.row_ids, a.col_ids, values, b,
                                          nnz=a.nnz, **kw),
                 lambda: ref.batched_gspmm_coo_plain(a.row_ids, a.col_ids,
                                                     values, a.nnz, b, **kw),
                 io + a.nnz.numel() * 4 + real * 8, flops, shape, library,
                 bitwise=True)

    # R-GCN, Tox21 serving: the first wave's 4 relations x 128 graphs,
    # the (copy_lhs, mean) aggregation of layer 1 (n_b 64)
    cfg = GCNConfig.tox21(layer="rgcn", impl="ref", bn_mode="sample")
    params = _params(cfg, 0, device)
    wave = GraphServeEngine(params, cfg, device=device, **TOX21).assemble(
        _requests(GraphDatasetSpec.tox21_like(TOX21["batch"], seed=0)))
    a_rel = flatten_channels(wave.adj)
    h = torch.randn((a_rel.batch, m_pad, 64), generator=gen).to(device)
    gspmm_rows("rgcn tox21 serving", a_rel, h, a_rel.values, "copy_lhs",
               "mean")
    # GAT, Tox21 serving: channel 0 of the wave under 4 heads (head-major,
    # 512 samples), attention weights over rows repeated over d_head 16
    heads, d_head = 4, 16
    a0 = wave.adj[0]
    logits = torch.randn((a0.batch, a0.nnz_pad, heads), generator=gen).to(
        device)
    alpha = segment_softmax(logits, a0.row_ids, nnz=a0.nnz, m_pad=m_pad)

    def flat(t):
        return t.expand((heads,) + t.shape).reshape((heads * a0.batch,)
                                                    + t.shape[1:])

    e_vec = alpha.permute(2, 0, 1).reshape(heads * a0.batch, a0.nnz_pad, 1) \
        .expand(-1, -1, d_head).contiguous()
    a_gat = a0.__class__(flat(a0.row_ids), flat(a0.col_ids), e_vec,
                         flat(a0.nnz), flat(a0.n_rows))
    hg = torch.randn((heads * a0.batch, m_pad, d_head), generator=gen).to(
        device)
    gspmm_rows("gat tox21 serving", a_gat, hg, e_vec, "mul", "sum")

    # the grouped matmul of R-GCN over relation-major tokens (each node
    # block repeated per relation, as rgcn_layer): Tox21 serving layer 1
    # (4 relations x 7,168 tokens), Tox21 training layer 1 (groups of
    # 2,800 rows: tiles straddle) and its step's dx at layer 2 (dout @
    # W_r^T), Reaction100 layers 1 (62 -> 512) and 2 (512 -> 512)
    def tokens(x, e):
        t = x.shape[0] * x.shape[1]
        return x.reshape(1, t, -1).expand(e, t, x.shape[-1]) \
            .reshape(e * t, -1).contiguous()

    def gmm_row(tag, xt, w):
        e, k, n = w.shape
        m = xt.shape[0]
        size = m // e
        rg = _row_groups(torch.full((e,), size, dtype=torch.int32,
                                    device=device), m, e)
        groups, cols = gmm_tile(m, n)
        bm = THREAD_ROWS * groups
        check(bool((_visited_groups(rg, 128, 4) >= 0).all()),
              f"grouped_matmul {tag}: a 128-row tile holds more than 4 "
              "groups")
        _measure(rows, f"grouped_matmul[{tag}]", "grouped_matmul",
                 lambda: _gmm(xt, w, rg),
                 lambda: ref.grouped_matmul_ref(xt, rg, w),
                 (xt.numel() + w.numel() + m * n + m) * 4, 2 * m * k * n,
                 f"M {m} ({e} groups of {size} rows, {bm} x {16 * cols} "
                 f"tiles {'straddle' if size % bm else 'aligned'}), K {k}, "
                 f"N {n}",
                 lambda: torch.bmm(xt.view(e, size, k), w).view(m, n),
                 bitwise=True)

    def gmm_non_finite(tag, xt, w):
        """An inf in relation 1's W and a NaN in relation 2's, in tiles
        that straddle their boundaries: the kernel's non-finite outputs lie
        where the plain version's do, the rest within the f32 tolerance,
        and every row of the other relations stays finite."""
        e, m = w.shape[0], xt.shape[0]
        rg = _row_groups(torch.full((e,), m // e, dtype=torch.int32,
                                    device=device), m, e)
        wb = w.clone()
        wb[1, 0, 3] = float("inf")
        wb[2, -1, -1] = float("nan")
        key = f"grouped_matmul[{tag}, non-finite W]"
        got, want = _gmm(xt, wb, rg), ref.grouped_matmul_ref(xt, rg, wb)
        fin = torch.isfinite(want)
        check(bool((~fin).any()), f"{key}: the plain version is finite")
        check(torch.equal(torch.isnan(got), torch.isnan(want))
              and torch.equal(torch.isinf(got), torch.isinf(want)),
              f"{key}: non-finite outputs where the plain version has none")
        check(bool(torch.isfinite(got[(rg != 1) & (rg != 2)]).all()),
              f"{key}: a row of another relation is not finite")
        err = max_err(got[fin], want[fin], key)
        log(f"[gmm non-finite W] {key}: {int((~fin).sum())} non-finite "
            f"outputs in relations 1-2 as in the plain version; the other "
            f"{int(fin.sum())} within {err:.3e}")

    w1 = params["convs"][0]["w_rel"]
    gmm_row("rgcn tox21 serving layer 1", tokens(wave.x, 4), w1)
    tb = _on(_train_batches(GraphDatasetSpec.tox21_like(
        TRAIN_TOX21["n_samples"], seed=0), TRAIN_TOX21["batch"])[0], device)
    gmm_row("rgcn tox21 training layer 1", tokens(tb["x"], 4), w1)
    gmm_non_finite("rgcn tox21 training layer 1", tokens(tb["x"], 4), w1)
    t_rows = 4 * tb["x"].shape[0] * tb["x"].shape[1]
    dout = torch.randn((t_rows, 64), generator=gen).to(device)
    w2t = params["convs"][1]["w_rel"].transpose(1, 2).contiguous()
    gmm_row("rgcn tox21 training layer 2 dx", dout, w2t)
    gmm_non_finite("rgcn tox21 training layer 2 dx", dout, w2t)
    r_cfg = GCNConfig.reaction100(layer="rgcn", impl="ref")
    r_params = _params(r_cfg, 0, device)
    rw = GraphServeEngine(r_params, r_cfg, device=device, **TOX21).assemble(
        _requests(GraphDatasetSpec.reaction100_like(TOX21["batch"], seed=0)))
    gmm_row("rgcn reaction100 layer 1", tokens(rw.x, 4),
            r_params["convs"][0]["w_rel"])
    x2 = torch.randn((TOX21["batch"], m_pad, 512), generator=gen).to(device)
    gmm_row("rgcn reaction100 layer 2", tokens(x2, 4),
            r_params["convs"][1]["w_rel"])
    # the CSR kernel's g-SpMM entry at R-GCN Reaction100 serving: the
    # (copy_lhs, mean) of layers 2-3 over the wave's relations, n_b 512
    r_rel = flatten_channels(rw.adj)
    r_h = torch.randn((r_rel.batch, m_pad, 512), generator=gen).to(device)
    r_csr = coo_to_csr(r_rel, m_pad)
    r_real = int(r_rel.nnz.sum().item())
    # the B rows this data reads (a padding row of the wave is never
    # gathered)
    r_read = _b_rows_read(r_rel, m_pad)
    kw = dict(op="copy_lhs", reduce="mean")
    _measure(rows, "batched_spmm_csr[reaction100]", "batched_spmm_csr",
             lambda: batched_spmm_csr(r_csr.rpt, r_csr.col_ids,
                                      r_csr.values, r_h, **kw),
             lambda: ref.batched_gspmm_csr_plain(r_csr.rpt, r_csr.col_ids,
                                                 r_csr.values, r_h, **kw),
             (r_read + r_h.shape[0] * m_pad) * 512 * 4
             + r_csr.rpt.numel() * 4 + r_real * 4, r_real * 512,
             f"R-GCN Reaction100 serving: {r_rel.batch} matrices x {m_pad} "
             f"rows, nnz_pad {r_rel.nnz_pad}, n_b 512, {r_real} real nnz, "
             "(copy_lhs, mean)",
             _library_gspmm(r_rel, r_h, r_rel.values, "copy_lhs", "mean"),
             bitwise=True)
    for k, r in rows.items():
        if k not in before:
            errs[r["kernel"]] = max(errs.get(r["kernel"], 0.0),
                                    r["max_abs_err"])

    # -- every (op, reduce) corner on the three regimes, small sizes ------
    checks = 0
    for rname, coo, mp in _regimes(device):
        k_pad = max(1, int(max_row_degree(coo, mp).max().item()))
        rlen = row_degrees(coo, mp)
        b = torch.randn((coo.batch, mp, 48), generator=gen).to(device)
        slot = torch.arange(coo.nnz_pad, device=device)
        valid = (slot[None, :] < coo.nnz[:, None])[..., None]
        vec = torch.where(valid, torch.randn(
            tuple(coo.values.shape) + (48,), generator=gen).to(device), 0.0)
        for values in (coo.values, vec):
            a = coo.with_values(values)
            e = coo_to_ell(a, mp, k_pad)
            csr = coo_to_csr(a, mp)
            for op, red in GSPMM_CORNERS:
                kw = dict(op=op, reduce=red)
                runs = [
                    ("batched_spmm_ell", lambda: batched_spmm_ell(
                        e.col_ids, e.values, b, rlen=rlen, **kw),
                     lambda: ref.batched_gspmm_ell_plain(
                         e.col_ids, e.values, rlen, b, **kw), True),
                    ("batched_spmm_csr", lambda: batched_spmm_csr(
                        csr.rpt, csr.col_ids, csr.values, b, **kw),
                     lambda: ref.batched_gspmm_csr_plain(
                         csr.rpt, csr.col_ids, csr.values, b, **kw), True),
                    ("batched_spmm_coo", lambda: batched_spmm_coo(
                        a.row_ids, a.col_ids, values, b, nnz=a.nnz, **kw),
                     lambda: ref.batched_gspmm_coo_plain(
                         a.row_ids, a.col_ids, values, a.nnz, b, **kw),
                     False)]
                for kname, kern, plain, repeatable in runs:
                    got, want = kern(), plain()
                    what = (f"{kname} g-SpMM ({op}, {red}) "
                            f"{'vector' if values.dim() == 3 else 'scalar'} "
                            f"{rname}")
                    if red == "max":
                        torch.cuda.synchronize()
                        check(torch.equal(got, want),
                              f"{what}: not bitwise equal to plain")
                    errs[kname] = max(errs[kname], max_err(got, want, what))
                    if repeatable:
                        check(torch.equal(got, kern()),
                              f"{what}: two calls differ")
                    checks += 1
        # the grouped matmul: ragged groups, an empty one, rows past the
        # sum, and 5 groups in the first 128-row tile, whose fifth group's
        # rows there come out 0 (the reference's max_groups_per_tile = 4)
        sizes = torch.tensor([5, 70, 1, 0, 300], dtype=torch.int32,
                             device=device)
        xg = torch.randn((393, 33), generator=gen).to(device)
        wg = torch.randn((5, 33, 20), generator=gen).to(device)
        rg = _row_groups(sizes, 393, 5)
        visited = _visited_groups(rg, 128, 4)
        check(int((visited < 0).sum().item()) == 52,
              "grouped_matmul: expected 52 rows past 4 groups of a tile")
        got = _gmm(xg, wg, rg)
        check(bool((got[visited < 0] == 0).all()),
              f"grouped_matmul {rname}: rows past 4 groups of a tile not 0")
        errs["grouped_matmul"] = max(errs["grouped_matmul"], max_err(
            got, ref.grouped_matmul_ref(xg, visited, wg),
            f"grouped_matmul {rname}"))
        check(torch.equal(got, _gmm(xg, wg, rg)),
              f"grouped_matmul {rname}: two calls differ")
    log(f"[kernels] g-SpMM entries of the ELL, CSR and COO kernels: {checks} "
        "checks of every (op, reduce) corner, scalar and vector edges, on "
        "the uniform / skewed / zero-nnz regimes match their plain versions "
        "(max corners bitwise; ELL and CSR identical bits twice); the "
        "grouped matmul on ragged groups (an empty one, rows past the sum, "
        "the 52 rows of a fifth group in one 128-row tile 0 as in the "
        "reference) matches its plain version with identical bits twice")
    _log_rows(r for k, r in rows.items() if k not in before)


def phase_precision_kernels(device, rows, errs):
    """The seven reduced-precision entries against their plain versions:
    timed at the Tox21 serving shape (the first wave of the serving phase,
    512 matrices x 56 rows, k_pad 8, nnz_pad 256, n_b 64) and, for the
    fused entry, also at Reaction100 layer 2, for the hybrid entry also at
    the powerlaw batch (hub rows), each beside its f32 entry's
    time on the same inputs, its bound at the narrowed widths and its
    library call (``torch.bmm`` on the densified bf16 adjacency; for i8
    the f32 ``torch.bmm`` on the dequantized one); then on the three
    regimes. bf16 within BF16_KERNEL_TOL, i8 within F32_TOL; the CSR and
    hybrid entries give identical bits twice. Adds to ``rows`` and
    ``errs``."""
    import torch
    from repro_torch.core.batching import plan_fused_graph_conv, plan_hybrid
    from repro_torch.core.formats import coo_to_csr, coo_to_dense, \
        coo_to_ell, max_row_degree, narrow_col_ids, quantize_values_i8
    from repro_torch.core.gcn import GCNConfig
    from repro_torch.core.graph_conv import flatten_channels, stack_channels
    from repro_torch.data.graphs import GraphDatasetSpec
    from repro_torch.kernels import ref
    from repro_torch.kernels.batched_spmm_coo import batched_spmm_coo, \
        batched_spmm_coo_bf16
    from repro_torch.kernels.batched_spmm_csr import batched_spmm_csr, \
        batched_spmm_csr_bf16, batched_spmm_csr_i8
    from repro_torch.kernels.batched_spmm_ell import batched_spmm_ell, \
        batched_spmm_ell_bf16, batched_spmm_ell_i8
    from repro_torch.kernels.batched_spmm_hybrid import hybrid_launch, \
        hybrid_operands
    from repro_torch.kernels.fused_graph_conv import fused_forward, \
        fused_forward_bf16, runtime_chunks
    from repro_torch.serving.engine import GraphServeEngine

    gen = torch.Generator(device="cpu").manual_seed(3)
    bf = torch.bfloat16
    m_pad = TOX21["m_pad"]
    before = set(rows)
    cfg = GCNConfig.tox21(impl="fused", bn_mode="sample")
    params = _params(cfg, 0, device)
    wave = GraphServeEngine(params, cfg, device=device, **TOX21).assemble(
        _requests(GraphDatasetSpec.tox21_like(TOX21["batch"], seed=0)))
    conv = params["convs"][0]
    a = flatten_channels(wave.adj)
    u = (torch.einsum("bmn,cnf->cbmf", wave.x, conv["w"])
         + conv["b"][:, None, None, :]).reshape(-1, m_pad, 64).contiguous()
    uh = u.to(bf)
    nnz = int(a.nnz.sum().item())
    batch = a.batch
    io = 2 * u.numel() * 4               # B read once, C written once (f32)
    flops = 2 * nnz * 64
    shape = (f"{batch} matrices x {m_pad} rows, k_pad {cfg.k_pad}, nnz_pad "
             f"{a.nnz_pad}, n_b 64, {nnz} real nnz")
    dense = coo_to_dense(a, m_pad)
    codes, scale = quantize_values_i8(a.values)
    dense_q = coo_to_dense(a.with_values(codes.float()), m_pad) \
        * scale[:, None, None]
    ell, ell_q = (coo_to_ell(x, m_pad, cfg.k_pad)
                  for x in (a, a.with_values(codes)))
    e16 = narrow_col_ids(ell.col_ids, m_pad)
    eh = ell.values.to(bf)
    csr, csr_q = coo_to_csr(a, m_pad), coo_to_csr(a.with_values(codes),
                                                    m_pad)
    c16 = narrow_col_ids(csr.col_ids, m_pad)
    ch = csr.values.to(bf)
    r16, k16 = (narrow_col_ids(t, m_pad) for t in (a.row_ids, a.col_ids))
    vh = a.values.to(bf)
    lib_bf16 = (lambda: torch.bmm(dense.to(bf), uh))
    lib_i8 = (lambda: torch.bmm(dense_q, u))
    rpt_b = csr.rpt.numel() * 4

    def precision_row(key, kernel, kern, plain, f32_kern, nbytes, library,
                      bf16, flop_rate, **kw):
        _measure(rows, key, kernel, kern, plain, nbytes,
                 kw.pop("flops", flops), kw.pop("shape", shape), library,
                 tol=BF16_KERNEL_TOL if bf16 else F32_TOL,
                 flop_rate=flop_rate,
                 library_tol=POLICY_TOLS["bf16"] if bf16 else F32_TOL, **kw)
        rows[key]["f32_ms"] = graph_ms(f32_kern)

    precision_row(
        "batched_spmm_ell_bf16[tox21]", "batched_spmm_ell_bf16",
        lambda: batched_spmm_ell_bf16(e16, eh, uh),
        lambda: ref.batched_spmm_ell_plain(e16, eh, uh),
        lambda: batched_spmm_ell(ell.col_ids, ell.values, u),
        io // 2 + nnz * 4, lib_bf16, True, BF16_FLOP_PER_S)
    precision_row(
        "batched_spmm_ell_i8[tox21]", "batched_spmm_ell_i8",
        lambda: batched_spmm_ell_i8(e16, ell_q.values, scale, u),
        lambda: ref.batched_spmm_ell_plain(e16, ell_q.values, u, scale),
        lambda: batched_spmm_ell(ell.col_ids, ell.values, u),
        io + nnz * 3 + batch * 4, lib_i8, False, F32_FLOP_PER_S)
    precision_row(
        "batched_spmm_csr_bf16[tox21]", "batched_spmm_csr_bf16",
        lambda: batched_spmm_csr_bf16(csr.rpt, c16, ch, uh),
        lambda: ref.batched_spmm_csr_plain(csr.rpt, c16, ch, uh),
        lambda: batched_spmm_csr(csr.rpt, csr.col_ids, csr.values, u),
        rpt_b + io // 2 + nnz * 4, lib_bf16, True, BF16_FLOP_PER_S,
        bitwise=True)
    precision_row(
        "batched_spmm_csr_i8[tox21]", "batched_spmm_csr_i8",
        lambda: batched_spmm_csr_i8(csr.rpt, c16, csr_q.values, scale, u),
        lambda: ref.batched_spmm_csr_plain(csr.rpt, c16, csr_q.values, u,
                                           scale),
        lambda: batched_spmm_csr(csr.rpt, csr.col_ids, csr.values, u),
        rpt_b + io + nnz * 3 + batch * 4, lib_i8, False, F32_FLOP_PER_S,
        bitwise=True)
    precision_row(
        "batched_spmm_coo_bf16[tox21]", "batched_spmm_coo_bf16",
        lambda: batched_spmm_coo_bf16(r16, k16, vh, uh),
        lambda: ref.batched_spmm_coo_plain(r16, k16, vh, uh),
        lambda: batched_spmm_coo(a.row_ids, a.col_ids, a.values, u),
        io // 2 + nnz * 6, lib_bf16, True, BF16_FLOP_PER_S, bitwise=True)
    # the bf16 hybrid entry at Tox21 (no hub) and at the powerlaw batch (its
    # first channel: 40 x 256, about 5 hub rows a matrix), beside the f32
    # entry on the same inputs
    def hybrid_bf16_row(tag, coo, b, mp, library):
        hp = plan_hybrid(batch=coo.batch, m_pad=mp, n_b=b.shape[-1],
                         nnz_pad=coo.nnz_pad, itemsize=2)
        hp32 = plan_hybrid(batch=coo.batch, m_pad=mp, n_b=b.shape[-1],
                           nnz_pad=coo.nnz_pad)
        h32 = hybrid_operands(coo.row_ids, coo.col_ids, coo.values, coo.nnz,
                              mp, hp32)
        hh = hybrid_operands(coo.row_ids, coo.col_ids, coo.values.to(bf),
                             coo.nnz, mp, hp)
        hh = hh[:3] + (narrow_col_ids(hh[3], mp),) + hh[4:]
        bh = b.to(bf)
        nbytes, h_flops, sparse, hubs, _ = _hybrid_work(hh, bh, hp.d_pad)
        precision_row(
            f"batched_spmm_hybrid_bf16[{tag}]", "batched_spmm_hybrid_bf16",
            lambda: hybrid_launch(*hh, bh, plan=hp),
            lambda: ref.batched_spmm_hybrid_plain(*hh, bh),
            lambda: hybrid_launch(*h32, b, plan=hp32),
            nbytes, library, True, BF16_FLOP_PER_S, bitwise=True,
            flops=h_flops,
            shape=f"{coo.batch} matrices x {mp} rows, nnz_pad "
                  f"{coo.nnz_pad}, n_b {b.shape[-1]} ({sparse} in the CSR "
                  f"remainder), dmin {hp.dmin}, d_pad {hp.d_pad}, "
                  f"{hubs / coo.batch:.3f} hub rows per matrix, n_block "
                  f"{hp.spmm.n_block}")

    hybrid_bf16_row("tox21", a, u, m_pad, lib_bf16)
    pl_adj, pl_m = _powerlaw_channels(device)
    pl = pl_adj[0]
    pl_b = torch.randn((pl.batch, pl_m, 64), generator=gen).to(device)
    pl_dense = coo_to_dense(pl, pl_m).to(bf)
    hybrid_bf16_row("powerlaw", pl, pl_b, pl_m,
                    lambda: torch.bmm(pl_dense, pl_b.to(bf)))
    del pl_adj

    # the fused entry: Tox21 layer 1, and Reaction100 layer 2 (n_in 512)
    def fused_row(tag, adj, x, w, bias, n_nodes):
        rid, cid, val, nnz_sc = stack_channels(adj)
        chunks = runtime_chunks(nnz_sc)
        rid16, cid16 = (narrow_col_ids(t, m_pad) for t in (rid, cid))
        valh, xh, wh, bh = (t.to(bf) for t in (val, x, w, bias))
        live_rows = int(((chunks > 0) * n_nodes[:, None]).sum().item())
        real = int(nnz_sc.sum().item())
        n_in, n_out = x.shape[-1], w.shape[-1]
        dense_c = torch.stack([coo_to_dense(c, m_pad) for c in adj]).to(bf)

        def library():
            uu = (torch.einsum("bmn,cnf->cbmf", xh, wh)
                  + bh[:, None, None, :])
            return torch.matmul(dense_c, uu).sum(dim=0)

        precision_row(
            f"fused_forward_bf16[{tag}]", "fused_forward_bf16",
            lambda: fused_forward_bf16(rid16, cid16, valh, chunks, xh, wh,
                                       bh),
            lambda: ref.fused_graph_conv_plain(rid16, cid16, valh, chunks,
                                               xh, wh, bh),
            lambda: fused_forward(rid, cid, val, chunks, x, w, bias),
            real * 6 + chunks.numel() * 4 + (x.numel() + w.numel()
                                             + bias.numel()) * 2
            + x.shape[0] * m_pad * n_out * 2, library, True,
            BF16_FLOP_PER_S,
            flops=2 * real * n_out + 2 * live_rows * n_in * n_out,
            shape=f"{x.shape[0]} samples x {w.shape[0]} channels, m_pad "
                  f"{m_pad}, n_in {n_in} -> n_out {n_out}, {real} real nnz")
        _panel_times(f"fused_forward_bf16[{tag}]",
                     lambda plan: fused_forward_bf16(
                         rid16, cid16, valh, chunks, xh, wh, bh, plan=plan),
                     ref.fused_graph_conv_plain(rid16, cid16, valh, chunks,
                                                xh, wh, bh), BF16_KERNEL_TOL,
                     plan_fused_graph_conv(batch=x.shape[0], m_pad=m_pad,
                                           n_in=n_in, n_out=n_out,
                                           itemsize=2))

    fused_row("tox21", wave.adj, wave.x, conv["w"], conv["b"], wave.n_nodes)
    r_cfg = GCNConfig.reaction100(impl="fused", bn_mode="sample")
    r_params = _params(r_cfg, 0, device)
    rw = GraphServeEngine(r_params, r_cfg, device=device, **TOX21).assemble(
        _requests(GraphDatasetSpec.reaction100_like(TOX21["batch"], seed=0)))
    x2 = torch.randn((TOX21["batch"], m_pad, 512), generator=gen).to(device)
    x2 *= (torch.arange(m_pad, device=device)[None, :, None]
           < rw.n_nodes[:, None, None])
    conv2 = r_params["convs"][1]
    fused_row("reaction100", rw.adj, x2, conv2["w"], conv2["b"], rw.n_nodes)
    hmma = _fused_hmma()
    check(all(n > 0 for k, n in hmma.items() if k[0] == "bf16")
          and not any(n for k, n in hmma.items() if k[0] != "bf16")
          and len(hmma) == 20,
          f"fused_graph_conv: HMMA per instance {hmma}")
    log("[kernels] fused_graph_conv: HMMA (mma.sync) instructions per "
        "(entry, tile columns, tile rows, large) instance (cuobjdump "
        "-sass): "
        + ", ".join(f"{k}: {n}" for k, n in sorted(hmma.items()))
        + " (the f32 entries: none, so no TF32)")
    for r in rows.values():
        if r["name"] not in before:
            errs[r["kernel"]] = max(errs.get(r["kernel"], 0.0),
                                    r["max_abs_err"])

    # -- the three regimes, small sizes, N(0, 1) values --------------------
    for rname, coo, mp in _regimes(device):
        k_pad = max(1, int(max_row_degree(coo, mp).max().item()))
        b = torch.randn((coo.batch, mp, 48), generator=gen).to(device)
        bh = b.to(bf)
        h = coo.with_values(coo.values.to(bf))
        q_codes, q_scale = quantize_values_i8(coo.values)
        q = coo.with_values(q_codes)
        e, eq = coo_to_ell(h, mp, k_pad), coo_to_ell(q, mp, k_pad)
        c, cq = coo_to_csr(h, mp), coo_to_csr(q, mp)
        ce, cc = narrow_col_ids(e.col_ids, mp), narrow_col_ids(c.col_ids, mp)
        rr, kk = (narrow_col_ids(t, mp) for t in (h.row_ids, h.col_ids))
        hpl = plan_hybrid(batch=coo.batch, m_pad=mp, n_b=48,
                          nnz_pad=coo.nnz_pad, itemsize=2)
        hop = hybrid_operands(h.row_ids, h.col_ids, h.values, h.nnz, mp, hpl)
        hop = hop[:3] + (narrow_col_ids(hop[3], mp),) + hop[4:]
        perm = torch.randperm(coo.nnz_pad, generator=gen).to(device)
        adj2 = [h, h.__class__(h.row_ids[:, perm], h.col_ids[:, perm],
                               h.values[:, perm], h.nnz, h.n_rows)]
        rid, cid, val, nnz_sc = stack_channels(adj2)
        rid, cid = narrow_col_ids(rid, mp), narrow_col_ids(cid, mp)
        chunks = runtime_chunks(nnz_sc)
        x = torch.randn((coo.batch, mp, 12), generator=gen).to(device).to(bf)
        w = (torch.randn((2, 12, 40), generator=gen) / 4).to(device).to(bf)
        bias = torch.randn((2, 40), generator=gen).to(device).to(bf)
        res = torch.randn((coo.batch, mp, 40), generator=gen).to(device) \
            .to(bf)
        checks = [
            ("batched_spmm_ell_bf16", lambda: batched_spmm_ell_bf16(
                ce, e.values, bh),
             lambda: ref.batched_spmm_ell_plain(ce, e.values, bh), False),
            ("batched_spmm_ell_i8", lambda: batched_spmm_ell_i8(
                narrow_col_ids(eq.col_ids, mp), eq.values, q_scale, b),
             lambda: ref.batched_spmm_ell_plain(
                 narrow_col_ids(eq.col_ids, mp), eq.values, b, q_scale),
             False),
            ("batched_spmm_csr_bf16", lambda: batched_spmm_csr_bf16(
                c.rpt, cc, c.values, bh),
             lambda: ref.batched_spmm_csr_plain(c.rpt, cc, c.values, bh),
             True),
            ("batched_spmm_csr_i8", lambda: batched_spmm_csr_i8(
                cq.rpt, narrow_col_ids(cq.col_ids, mp), cq.values, q_scale,
                b),
             lambda: ref.batched_spmm_csr_plain(
                 cq.rpt, narrow_col_ids(cq.col_ids, mp), cq.values, b,
                 q_scale), True),
            ("batched_spmm_coo_bf16", lambda: batched_spmm_coo_bf16(
                rr, kk, h.values, bh),
             lambda: ref.batched_spmm_coo_plain(rr, kk, h.values, bh),
             False),
            ("batched_spmm_hybrid_bf16", lambda: hybrid_launch(
                *hop, bh, plan=hpl),
             lambda: ref.batched_spmm_hybrid_plain(*hop, bh), True),
            ("fused_forward_bf16", lambda: fused_forward_bf16(
                rid, cid, val, chunks, x, w, bias),
             lambda: ref.fused_graph_conv_plain(rid, cid, val, chunks, x, w,
                                                bias), False),
            ("fused_forward_bf16", lambda: fused_forward_bf16(
                rid, cid, val, chunks, x, w, bias, res, epilogue="relu"),
             lambda: ref.fused_graph_conv_plain(rid, cid, val, chunks, x, w,
                                                bias, res, "relu"), False)]
        for kname, kern, plain, bitwise in checks:
            tol = F32_TOL if kname.endswith("i8") else BF16_KERNEL_TOL
            got = kern()
            errs[kname] = max(errs[kname], max_err(got, plain(),
                                                   f"{kname} {rname}", tol))
            if bitwise:
                check(torch.equal(got, kern()),
                      f"{kname} {rname}: two calls differ")
        log(f"[kernels] regime {rname}: the bf16 ELL, CSR, COO, hybrid "
            f"(d_pad {hpl.d_pad}) and fused (none, relu + residual) entries "
            f"within {BF16_KERNEL_TOL}, the i8 ELL and CSR entries within "
            f"{F32_TOL} of their plain versions; CSR and hybrid identical "
            "bits twice")
    _log_rows(r for k, r in rows.items() if k not in before)
    for k, r in rows.items():
        if k not in before:
            log(f"[kernels] {k}: f32 entry on the same inputs "
                f"{r['f32_ms']:.4f} ms, the variant {r['ms']:.4f} ms")


def _large_coo(m_pad: int, batch: int, seed: int):
    """``batch`` random matrices of ``m_pad`` rows for planner case 3, on
    the CPU: each row 0-11 N(0, 1) edges (so some rows are empty) at
    uniform columns, and row 7 of every matrix 64 more."""
    import numpy as np
    from repro_torch.core.formats import coo_from_lists

    rng = np.random.default_rng(seed)
    lists = []
    for _ in range(batch):
        deg = rng.integers(0, 12, m_pad)
        deg[7] += 64
        r = np.repeat(np.arange(m_pad, dtype=np.int32), deg)
        lists.append((r, rng.integers(0, m_pad, r.size).astype(np.int32),
                      rng.normal(size=r.size).astype(np.float32)))
    return coo_from_lists(lists, [m_pad] * batch)


def _b_rows_read(a, m_pad: int) -> int:
    """The B rows a sparse product over the matrices ``a`` gathers, for a
    bytes bound: each matrix's distinct column ids inside ``[0, m_pad)``
    among its slots below ``nnz[s]`` (a row that no slot names is never
    read)."""
    import torch

    slot = torch.arange(a.nnz_pad, device=a.col_ids.device)
    cid = a.col_ids.long()
    valid = (slot[None, :] < a.nnz[:, None]) & (cid >= 0) & (cid < m_pad)
    mat = torch.arange(a.batch, device=cid.device)[:, None] * m_pad
    return int(torch.unique((mat + cid)[valid]).numel())


def _tier_block(m_pad: int, live: int, fanout: int, seed: int):
    """A sampled block of the giant-graph tier as one matrix, on the CPU:
    its first ``live`` rows (the destinations) ``fanout`` N(0, 1) slots
    each, in row order, at columns drawn over all ``m_pad`` rows."""
    import numpy as np
    from repro_torch.core.formats import coo_from_lists

    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(live, dtype=np.int32), fanout)
    return coo_from_lists([(r, rng.integers(0, m_pad, r.size).astype(
        np.int32), rng.normal(size=r.size).astype(np.float32))], [m_pad])


def phase_large_kernels(device, rows, errs):
    """The large-matrix entries (planner case 3) against their plain
    versions at LARGE_SHAPES (n_b 64, ``_large_coo`` matrices), timed beside
    their bytes bound, the plain versions and ``torch.bmm`` on the densified
    adjacency, each also for identical bits twice (f32 and i8 within
    F32_TOL, bf16 within one bf16 ulp); then :func:`_coo_large_kernels`.
    Adds to ``rows`` and ``errs``."""
    import torch
    from repro_torch.core.batching import plan_batched_gemm, \
        plan_batched_spmm
    from repro_torch.core.formats import coo_to_csr, coo_to_dense, \
        coo_to_ell, max_row_degree, narrow_col_ids, quantize_values_i8
    from repro_torch.kernels import ref
    from repro_torch.kernels.batched_gemm import batched_gemm_large
    from repro_torch.kernels.batched_spmm_coo import \
        batched_spmm_coo_large, batched_spmm_coo_large_bf16
    from repro_torch.kernels.batched_spmm_csr import \
        batched_spmm_csr_large, batched_spmm_csr_large_bf16, \
        batched_spmm_csr_large_i8
    from repro_torch.kernels.batched_spmm_ell import \
        batched_spmm_ell_large, batched_spmm_ell_large_bf16, \
        batched_spmm_ell_large_i8

    gen = torch.Generator(device="cpu").manual_seed(9)
    bf = torch.bfloat16
    before = set(rows)
    n_b = 64
    for tag, m_pad, batch in LARGE_SHAPES:
        coo = _large_coo(m_pad, batch, seed=m_pad).to(device)
        check(plan_batched_spmm(batch=batch, m_pad=m_pad, n_b=n_b).case == 3
              and plan_batched_gemm(batch=batch, m=m_pad, n=n_b,
                                    k=m_pad).case == 3,
              f"{tag}: not planner case 3")
        b = torch.randn((batch, m_pad, n_b), generator=gen).to(device)
        bh = b.to(bf)
        nnz = int(coo.nnz.sum().item())
        k_pad = int(max_row_degree(coo, m_pad).max().item())
        codes, scale = quantize_values_i8(coo.values)
        q = coo.with_values(codes)
        e, eq = coo_to_ell(coo, m_pad, k_pad), coo_to_ell(q, m_pad, k_pad)
        c, cq = coo_to_csr(coo, m_pad), coo_to_csr(q, m_pad)
        e16, eq16, c16, cq16 = (narrow_col_ids(t, m_pad) for t in (
            e.col_ids, eq.col_ids, c.col_ids, cq.col_ids))
        r16, k16 = (narrow_col_ids(t, m_pad) for t in (coo.row_ids,
                                                        coo.col_ids))
        eh, ch, vh = e.values.to(bf), c.values.to(bf), coo.values.to(bf)
        dense = coo_to_dense(coo, m_pad).contiguous()
        dense_h = dense.to(bf)
        dense_q = coo_to_dense(q.with_values(codes.float()), m_pad) \
            * scale[:, None, None]
        # the B rows the slots read, once, and C written once (f32)
        io = (_b_rows_read(coo, m_pad) + batch * m_pad) * n_b * 4
        rpt = c.rpt.numel() * 4
        flops = 2 * nnz * n_b
        shape = (f"{batch} matrices x {m_pad} rows, {nnz} real nnz (k_pad "
                 f"{k_pad}), n_b 64")
        # (name, kernel, plain, bytes, library, bitwise, bf16)
        checks = [
            ("batched_spmm_ell_large",
             lambda: batched_spmm_ell_large(e.col_ids, e.values, b),
             lambda: ref.batched_spmm_ell_plain(e.col_ids, e.values, b),
             io + nnz * 8, lambda: torch.bmm(dense, b), True, False),
            ("batched_spmm_ell_large_bf16",
             lambda: batched_spmm_ell_large_bf16(e16, eh, bh),
             lambda: ref.batched_spmm_ell_plain(e16, eh, bh),
             io // 2 + nnz * 4, lambda: torch.bmm(dense_h, bh), True, True),
            ("batched_spmm_ell_large_i8",
             lambda: batched_spmm_ell_large_i8(eq16, eq.values, scale, b),
             lambda: ref.batched_spmm_ell_plain(eq16, eq.values, b, scale),
             io + nnz * 3 + batch * 4, lambda: torch.bmm(dense_q, b), True,
             False),
            ("batched_spmm_csr_large",
             lambda: batched_spmm_csr_large(c.rpt, c.col_ids, c.values, b),
             lambda: ref.batched_spmm_csr_plain(c.rpt, c.col_ids, c.values,
                                                b),
             rpt + io + nnz * 8, lambda: torch.bmm(dense, b), True, False),
            ("batched_spmm_csr_large_bf16",
             lambda: batched_spmm_csr_large_bf16(c.rpt, c16, ch, bh),
             lambda: ref.batched_spmm_csr_plain(c.rpt, c16, ch, bh),
             rpt + io // 2 + nnz * 4, lambda: torch.bmm(dense_h, bh), True,
             True),
            ("batched_spmm_csr_large_i8",
             lambda: batched_spmm_csr_large_i8(cq.rpt, cq16, cq.values,
                                               scale, b),
             lambda: ref.batched_spmm_csr_plain(cq.rpt, cq16, cq.values, b,
                                                scale),
             rpt + io + nnz * 3 + batch * 4, lambda: torch.bmm(dense_q, b),
             True, False),
            ("batched_spmm_coo_large",
             lambda: batched_spmm_coo_large(coo.row_ids, coo.col_ids,
                                            coo.values, b),
             lambda: ref.batched_spmm_coo_plain(coo.row_ids, coo.col_ids,
                                                coo.values, b),
             io + nnz * 12, lambda: torch.bmm(dense, b), True, False),
            ("batched_spmm_coo_large_bf16",
             lambda: batched_spmm_coo_large_bf16(r16, k16, vh, bh),
             lambda: ref.batched_spmm_coo_plain(r16, k16, vh, bh),
             io // 2 + nnz * 6, lambda: torch.bmm(dense_h, bh), True, True),
            ("batched_gemm_large", lambda: batched_gemm_large(dense, b),
             lambda: ref.batched_gemm_plain(dense, b),
             (dense.numel() + 2 * b.numel()) * 4,
             lambda: torch.bmm(dense, b), True, False)]
        for name, kern, plain, nbytes, library, bitwise, bf16 in checks:
            gemm = name == "batched_gemm_large"
            _measure(rows, f"{name}[{tag}]", name, kern, plain, nbytes,
                     2 * dense.numel() * n_b if gemm else flops,
                     f"{shape}{', dense A' if gemm else ''}", library,
                     bitwise=bitwise,
                     tol=BF16_KERNEL_TOL if bf16 else F32_TOL,
                     flop_rate=BF16_FLOP_PER_S if bf16 else F32_FLOP_PER_S,
                     library_tol=POLICY_TOLS["bf16"] if bf16 else F32_TOL,
                     iters=10, replays=3)
            errs[name] = max(errs.get(name, 0.0),
                             rows[f"{name}[{tag}]"]["max_abs_err"])
        del dense, dense_h, dense_q
        torch.cuda.empty_cache()
    log("[kernels] the nine large-matrix entries (planner case 3: ELL, CSR "
        "f32 / bf16 / i8, COO f32 / bf16, the K-tiled GEMM) at m_pad 2048 "
        "(8 matrices) and 9000 (2) match their plain versions, identical "
        f"bits twice, within {F32_TOL} (f32, i8) or {BF16_KERNEL_TOL} "
        "(bf16)")
    _coo_large_kernels(device, rows, errs)
    _log_rows(r for k, r in rows.items() if k not in before)


def _coo_large_kernels(device, rows, errs):
    """The COO large-matrix entries beyond phase_large_kernels' rows: at
    LARGE_SHAPES bf16 on int32 ids and g-SpMM (copy_lhs, mean) and (mul,
    max), at TIER_BLOCKS also f32 (n_b 64), each against its plain version
    (max bitwise), identical bits twice, and timed beside its bytes bound,
    plain version and library call (``torch.bmm`` on the dense adjacency;
    g-SpMM: ``_library_gspmm``); then, at a Tox21-like shape both branches
    take (64 matrices x 56 rows), every large entry (f32, bf16 on int16 and
    int32 ids, each g-SpMM corner with scalar and vector edges) gives its
    batched entry's bits. Adds to ``rows`` and ``errs``."""
    import numpy as np
    import torch
    from repro_torch.core.batching import plan_batched_spmm
    from repro_torch.core.formats import coo_to_dense, narrow_col_ids, \
        random_batch
    from repro_torch.kernels import ref
    from repro_torch.kernels.batched_spmm_coo import batched_spmm_coo, \
        batched_spmm_coo_bf16, batched_spmm_coo_large, \
        batched_spmm_coo_large_bf16

    gen = torch.Generator(device="cpu").manual_seed(25)
    bf = torch.bfloat16
    shapes = [(tag, _large_coo(m_pad, batch, seed=m_pad))
              for tag, m_pad, batch in LARGE_SHAPES]
    shapes += [(tag, _tier_block(m_pad, live, fanout, seed=m_pad))
               for tag, m_pad, live, fanout in TIER_BLOCKS]
    for tag, a in shapes:
        a = a.to(device)
        batch, m = a.batch, int(a.n_rows.max())
        check(plan_batched_spmm(batch=batch, m_pad=m, n_b=64).case == 3,
              f"COO {tag}: not planner case 3")
        b = torch.randn((batch, m, 64), generator=gen).to(device)
        bh, vh = b.to(bf), a.values.to(bf)
        rid, cid, val = a.row_ids, a.col_ids, a.values
        nnz = int(a.nnz.sum().item())
        # the B rows the slots read, once, and C written once (f32)
        io = (_b_rows_read(a, m) + batch * m) * 64 * 4
        dense = coo_to_dense(a, m).contiguous()
        dense_h = dense.to(bf)
        shape = f"{batch} x {m} rows, {nnz} real nnz, n_b 64"
        # (key, kernel, plain, bytes, operations, library, bf16, exact)
        cases = [(f"batched_spmm_coo_large_bf16[{tag}, int32 ids]",
                  lambda: batched_spmm_coo_large_bf16(rid, cid, vh, bh),
                  lambda: ref.batched_spmm_coo_plain(rid, cid, vh, bh),
                  io // 2 + nnz * 10, 2 * nnz * 64,
                  lambda: torch.bmm(dense_h, bh), True, False)]
        if tag.startswith("tier"):
            cases.append((
                f"batched_spmm_coo_large[{tag}]",
                lambda: batched_spmm_coo_large(rid, cid, val, b),
                lambda: ref.batched_spmm_coo_plain(rid, cid, val, b),
                io + nnz * 12, 2 * nnz * 64, lambda: torch.bmm(dense, b),
                False, False))
        for op, red in (("copy_lhs", "mean"), ("mul", "max")):
            cases.append((
                f"batched_spmm_coo_large[g-SpMM ({op}, {red}), {tag}]",
                lambda op=op, red=red: batched_spmm_coo_large(
                    rid, cid, val, b, nnz=a.nnz, op=op, reduce=red),
                lambda op=op, red=red: ref.batched_gspmm_coo_plain(
                    rid, cid, val, a.nnz, b, op=op, reduce=red),
                io + nnz * (8 if op == "copy_lhs" else 12) + batch * 4,
                nnz * 64 * (1 if op == "copy_lhs" else 2),
                _library_gspmm(a, b, val, op, red), False, red == "max"))
        for key, kern, plain, nbytes, flops, library, bf16, exact in cases:
            _measure(rows, key, key.split("[")[0], kern, plain, nbytes, flops,
                     shape, library, bitwise=True,
                     tol=BF16_KERNEL_TOL if bf16 else F32_TOL,
                     flop_rate=BF16_FLOP_PER_S if bf16 else F32_FLOP_PER_S,
                     library_tol=POLICY_TOLS["bf16"] if bf16 else F32_TOL,
                     iters=10, replays=3)
            if exact:
                check(torch.equal(kern(), plain()),
                      f"{key}: differs from its plain version")
            name = rows[key]["kernel"]
            errs[name] = max(errs.get(name, 0.0), rows[key]["max_abs_err"])
        del dense, dense_h, a, b, bh
        torch.cuda.empty_cache()
    # the batched entries' bits, at a shape both branches take
    a, m = random_batch(np.random.default_rng(25), batch=64, dim=56,
                        nnz_per_row=3)
    a = a.with_values(torch.randn(a.values.shape, generator=gen)).to(device)
    rid, cid, val = a.row_ids, a.col_ids, a.values
    b = torch.randn((a.batch, m, 64), generator=gen).to(device)
    r16, c16 = narrow_col_ids(rid, m), narrow_col_ids(cid, m)
    vh, bh = val.to(bf), b.to(bf)
    same = [("f32", batched_spmm_coo_large(rid, cid, val, b),
             batched_spmm_coo(rid, cid, val, b))]
    want16 = batched_spmm_coo_bf16(r16, c16, vh, bh)
    same += [(f"bf16, {ids[0].dtype} ids",
              batched_spmm_coo_large_bf16(*ids, vh, bh), want16)
             for ids in ((r16, c16), (rid, cid))]
    vec = torch.randn(tuple(rid.shape) + (64,), generator=gen).to(device)
    for values in (val, vec):
        for op, red in GSPMM_CORNERS:
            kw = dict(nnz=a.nnz, op=op, reduce=red)
            same.append((f"({op}, {red}) {values.dim()}-D edges",
                         batched_spmm_coo_large(rid, cid, values, b, **kw),
                         batched_spmm_coo(rid, cid, values, b, **kw)))
    for what, got, want in same:
        check(torch.equal(got, want),
              f"COO large entry, {what}: not its batched entry's bits")
    tags = ", ".join(t for t, _ in shapes)
    log(f"[kernels] COO large-matrix entries at {tags}: f32, bf16 on int32 "
        "ids, g-SpMM (copy_lhs, mean) and (mul, max) match their plain "
        "versions (max bitwise), identical bits twice; "
        f"at 64 x 56 the {len(same)} large entries (f32, bf16 on int16 / "
        "int32 ids, 9 g-SpMM corners x scalar / vector edges) give their "
        "batched entries' bits")


def phase_fused_large(device, rows, errs):
    """The fused layer's large-matrix branch (``plan.large``: U of every
    channel in a global scratch, then the rows aggregated a block of rows
    at a time) at FUSED_LARGE, four channels of ``_large_coo`` matrices:
    the f32, hybrid (its head bounded by each sample's hub count) and bf16
    entries against their plain versions, each twice for identical bits,
    and timed beside its bound, the plain version and the library's
    einsum + matmul on the dense adjacency (bf16 in bf16, the channels'
    adjacencies side by side in one bmm): the rows
    fused_forward[large], fused_hybrid_forward[large] and
    fused_forward_bf16[large] at m_pad 1024, the same with ", m_pad 3072"
    at 3072. Adds to ``rows`` and ``errs``."""
    import torch
    from repro_torch.core.batching import plan_fused_graph_conv, plan_hybrid
    from repro_torch.core.formats import coo_to_dense, narrow_col_ids
    from repro_torch.core.graph_conv import stack_channels
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_graph_conv import fused_forward, \
        fused_forward_bf16, fused_hybrid_operands, runtime_chunks

    gen = torch.Generator().manual_seed(4)
    before = set(rows)
    bf = torch.bfloat16
    for tag, m_pad, batch, n_in, n_out in FUSED_LARGE:
        adj = [_large_coo(m_pad, batch, 20 + c).to(device) for c in range(4)]
        rid, cid, val, nnz = stack_channels(adj)
        chunks = runtime_chunks(nnz)
        x = torch.randn((batch, m_pad, n_in), generator=gen).to(device)
        w = (torch.randn((4, n_in, n_out), generator=gen)
             / n_in ** 0.5).to(device)
        bias = torch.randn((4, n_out), generator=gen).to(device)
        plan = plan_fused_graph_conv(batch=batch, m_pad=m_pad, n_in=n_in,
                                     n_out=n_out)
        check(plan.large and plan.case != 3,
              f"fused layer {tag}: {plan} is not the large-matrix branch")
        hp = plan_hybrid(batch=batch, m_pad=m_pad, n_b=n_out,
                         nnz_pad=4 * rid.shape[2])
        h_ops = fused_hybrid_operands(rid, cid, val, m_pad, hp)
        a16 = (narrow_col_ids(rid, m_pad), narrow_col_ids(cid, m_pad),
               val.to(bf), chunks, x.to(bf), w.to(bf), bias.to(bf))
        real = int(nnz.sum().item())
        live_rows = int((chunks > 0).sum().item()) * m_pad
        sparse = int(((h_ops[2] != 0) & (h_ops[0] < m_pad)).sum().item())
        slab_nz = int((h_ops[5] != 0).sum().item())
        hub_rows = h_ops[6].tolist()
        dense = torch.stack([coo_to_dense(a, m_pad) for a in adj])
        # bf16: the channels' adjacencies side by side (K = 4 m_pad), one
        # bmm that rounds once, where four bf16 products summed in bf16
        # would round four times
        dense_h = dense.permute(1, 2, 0, 3).reshape(
            batch, m_pad, 4 * m_pad).to(bf)

        def library():
            uu = torch.einsum("bmn,cnf->cbmf", x, w) + bias[:, None, None, :]
            return torch.matmul(dense, uu).sum(dim=0)

        def library_bf16():
            uu = (torch.einsum("bmn,cnf->bcmf", x.to(bf), w.to(bf))
                  + bias.to(bf)[None, :, None, :])
            return torch.bmm(dense_h, uu.reshape(batch, 4 * m_pad, n_out))

        # the bf16 library rounds U to bf16 before products of up to ~280
        # terms (the hub row), where the plain version and the kernel keep
        # U in f32: where a row's terms cancel it strays by ~0.25 from a
        # small output, so it is held to 4 bf16 ulps of the largest output
        # (a library computing another function misses by the outputs'
        # own size)
        lib_bf16_tol = (4 * 2.0 ** -8 * float(ref.fused_graph_conv_plain(
            *a16).float().abs().max()), POLICY_TOLS["bf16"][1])
        io = (x.numel() + w.numel() + bias.numel() + batch * m_pad * n_out) * 4
        transform = 2 * live_rows * n_in * n_out
        suffix = "" if tag == "m_pad 1024" else f", {tag}"
        shape = (f"{batch} samples x 4 channels, m_pad {m_pad}, n_in {n_in} "
                 f"-> n_out {n_out}, {real} real nnz")
        cases = (
            ("fused_forward",
             lambda: fused_forward(rid, cid, val, chunks, x, w, bias),
             lambda: ref.fused_graph_conv_plain(rid, cid, val, chunks, x, w,
                                                bias),
             real * 12 + chunks.numel() * 4 + io,
             2 * real * n_out + transform, shape, library, F32_TOL,
             F32_FLOP_PER_S, None),
            ("fused_hybrid_forward",
             lambda: fused_forward(*h_ops[:4], x, w, bias, None,
                                   *h_ops[4:6], hubs=h_ops[6]),
             lambda: ref.fused_graph_conv_plain(*h_ops[:4], x, w, bias, None,
                                                "none", *h_ops[4:]),
             sparse * 12 + chunks.numel() * 4 + io + h_ops[4].numel() * 4
             + sum(hub_rows) * 4 * m_pad * 4,
             2 * (sparse + slab_nz) * n_out + transform,
             f"{shape} ({sparse} scattered), d_pad {hp.d_pad}, hub rows "
             f"{hub_rows}", library, F32_TOL, F32_FLOP_PER_S, None),
            ("fused_forward_bf16", lambda: fused_forward_bf16(*a16),
             lambda: ref.fused_graph_conv_plain(*a16),
             real * 6 + chunks.numel() * 4 + io // 2,
             2 * real * n_out + transform, shape, library_bf16,
             BF16_KERNEL_TOL, BF16_FLOP_PER_S, lib_bf16_tol))
        for (name, kern, plain, nbytes, flops, shp, lib, tol, rate,
             lib_tol) in cases:
            key = f"{name}[large{suffix}]"
            _measure(rows, key, name, kern, plain, nbytes, flops, shp, lib,
                     bitwise=True, tol=tol, flop_rate=rate,
                     library_tol=lib_tol, iters=10, replays=3)
            errs[name] = max(errs[name], rows[key]["max_abs_err"])
        log(f"[kernels] fused layer {tag} ({batch} x {m_pad} rows, n_in "
            f"{n_in} -> {n_out}, the large-matrix branch): the f32, hybrid "
            f"(d_pad {hp.d_pad}, hub rows {hub_rows}) and bf16 entries match "
            "their plain versions, identical bits twice")
        del dense, dense_h, adj, h_ops, a16
        torch.cuda.empty_cache()
    _log_rows(r for k, r in rows.items() if k not in before)


def phase_large_path(device):
    """The case-3 path: ``ops.batched_spmm`` forward and first-step
    gradients (of sum(tanh(C))) with every kernel impl and precision
    variant (CASE3_IMPLS), and ``ops.batched_gspmm`` (copy_lhs, mean) with
    pallas_coo, pallas_csr and pallas_ell, at m_pad 9000 (2 matrices, n_b
    64), where every one is planner case 3. On the card the reference's
    plain per-sample paths (``ref.batched_spmm_coo_ref``, ``_csr_ref``,
    ``batched_gspmm_ref``, ``batched_gemm_plain``) are replaced by a trap;
    results against the same impl on the CPU, which takes them: f32 and i8
    within F32_TOL (gradients GRAD_TOL), bf16 within one bf16 ulp
    (gradients POLICY_TOLS["bf16"]).
    Returns the launches of each kernel wrapper on the card."""
    import torch
    from repro_torch.kernels import ops, ref

    tag, m_pad, batch = LARGE_SHAPES[-1]
    coo = _large_coo(m_pad, batch, seed=21)
    k_pad = 76                      # row 7's 64 + at most 11 more, and 1
    b0 = torch.randn((batch, m_pad, 64),
                     generator=torch.Generator().manual_seed(21))

    def run(impl, where):
        v = coo.values.to(where, copy=True).requires_grad_()
        b = b0.to(where, copy=True).requires_grad_()
        c = ops.batched_spmm(coo.to(where).with_values(v), b, impl=impl,
                             k_pad=k_pad)
        torch.tanh(c).sum().backward()
        return [t.detach().float().cpu() for t in (c, v.grad, b.grad)]

    def run_g(impl, where):
        return ops.batched_gspmm(coo.to(where), b0.to(where), op="copy_lhs",
                                 reduce="mean", impl=impl,
                                 k_pad=k_pad).float().cpu()

    def trap(*a, **k):
        raise SmokeFailure("case 3 on the card reached a plain path")

    plain = ("batched_spmm_coo_ref", "batched_spmm_csr_ref",
             "batched_gspmm_ref", "batched_gemm_plain")
    saved = {n: getattr(ref, n) for n in plain}
    wrappers = _reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        for n in plain:
            setattr(ref, n, trap)
        got = {impl: run(impl, device) for impl in CASE3_IMPLS}
        got_g = {impl: run_g(impl, device) for impl in (
            "pallas_coo", "pallas_csr", "pallas_ell")}
    finally:
        for n, fn in saved.items():
            setattr(ref, n, fn)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: fn.launches for k, fn in wrappers.items()}
    batched = [k for k in counts if k not in LARGE and counts[k]]
    check(not batched, f"case-3 path launched batched entries {batched}")
    worst = {}
    for impl, outs in got.items():
        bf16 = impl.endswith("bf16")
        want = run(impl, "cpu")
        for i, (g, w) in enumerate(zip(outs, want)):
            tol = ((BF16_KERNEL_TOL, POLICY_TOLS["bf16"]) if bf16
                   else (F32_TOL, GRAD_TOL))[min(i, 1)]
            worst[impl] = max(worst.get(impl, 0.0), max_err(
                g, w, f"case-3 path {impl} output/grad {i}", tol))
    for impl, out in got_g.items():
        worst[f"{impl} (copy_lhs, mean)"] = max_err(
            out, run_g(impl, "cpu"), f"case-3 path {impl} g-SpMM", F32_TOL)
    log(f"[case 3] {batch} matrices x {m_pad} rows, n_b 64: forward and "
        f"first-step gradients of {len(CASE3_IMPLS)} impls and 3 g-SpMM "
        f"(copy_lhs, mean) calls on the card in {wall:.2f} s, no plain "
        f"path reached, against the CPU: max abs err {worst}")
    log(f"[case 3] launches {counts}")
    return {"case-3 path": counts}


def _reset_counters():
    from repro_torch.kernels import batched_gemm as gemm_mod, \
        batched_spmm_coo as coo_mod, batched_spmm_csr as csr_mod, \
        batched_spmm_ell as ell_mod
    from repro_torch.kernels.batched_spmm_coo import batched_spmm_coo, \
        batched_spmm_coo_bf16
    from repro_torch.kernels.batched_spmm_csr import batched_spmm_csr, \
        batched_spmm_csr_bf16, batched_spmm_csr_i8
    from repro_torch.kernels.batched_gemm import batched_gemm
    from repro_torch.kernels.batched_spmm_ell import batched_spmm_ell, \
        batched_spmm_ell_bf16, batched_spmm_ell_i8
    from repro_torch.kernels.batched_spmm_hybrid import \
        batched_spmm_hybrid, batched_spmm_hybrid_bf16
    from repro_torch.kernels.fused_graph_conv import fused_forward, \
        fused_forward_bf16, fused_hybrid_forward
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.grouped_matmul import _gmm

    wrappers = {"batched_spmm_ell": batched_spmm_ell,
                "batched_spmm_coo": batched_spmm_coo,
                "batched_spmm_csr": batched_spmm_csr,
                "fused_forward": fused_forward,
                "batched_spmm_hybrid": batched_spmm_hybrid,
                "batched_gemm": batched_gemm,
                "fused_hybrid_forward": fused_hybrid_forward,
                "grouped_matmul": _gmm,
                "flash_attention": flash_attention,
                "batched_spmm_ell_bf16": batched_spmm_ell_bf16,
                "batched_spmm_ell_i8": batched_spmm_ell_i8,
                "batched_spmm_csr_bf16": batched_spmm_csr_bf16,
                "batched_spmm_csr_i8": batched_spmm_csr_i8,
                "batched_spmm_coo_bf16": batched_spmm_coo_bf16,
                "fused_forward_bf16": fused_forward_bf16,
                "batched_spmm_hybrid_bf16": batched_spmm_hybrid_bf16}
    for name in LARGE:
        mod = next(m for m in (ell_mod, csr_mod, coo_mod, gemm_mod)
                   if hasattr(m, name))
        wrappers[name] = getattr(mod, name)
    for fn in wrappers.values():
        fn.launches = 0
    return wrappers


def _serve(eng, requests, passes: int = 2):
    """Serve ``requests`` ``passes`` times through ``eng.run_wave``, timing
    each wave's host assembly and device forward apart through its timing
    hook; returns (logits of the last pass, host ms per wave, device ms per
    wave)."""
    import torch

    host, dev = [], []
    for _ in range(passes):
        for r in requests:
            r.logits, r.done = None, False
        for i in range(0, len(requests), eng.batch):
            marks = []

            def mark(_phase):
                torch.cuda.synchronize()
                marks.append(time.perf_counter())

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.run_wave(requests[i:i + eng.batch], on_phase=mark)
            host.append((marks[0] - t0) * 1e3)
            dev.append((marks[1] - marks[0]) * 1e3)
    check(all(r.done and not r.failed for r in requests),
          f"{sum(not r.done for r in requests)} requests not done")
    return [r.logits for r in requests], host, dev


def phase_serve(tag, cfg_fn, spec, impls, expect_per_wave, device, tol,
                impl_tol=None):
    """Serve ``spec``'s requests once per impl; returns launches per kernel
    and a summary line per impl. Logits are held against ``ref``'s within
    ``tol``, or within ``impl_tol[impl]`` where that is given; ``None``
    there prints the gap and holds nothing."""
    import numpy as np
    from repro_torch.autotune.cost_model import precision_of
    from repro_torch.serving.engine import GraphServeEngine

    def tol_of(impl):
        return (impl_tol or {}).get(impl, tol)

    requests = _requests(spec)
    params = _params(cfg_fn(impl="ref"), 0, device)
    results, launches = {}, {}
    for impl in impls:
        eng = GraphServeEngine(params, cfg_fn(impl=impl, bn_mode="sample"),
                               device=device, **TOX21)
        wrappers = _reset_counters()
        logits, host, dev = _serve(eng, requests)
        counts = {k: fn.launches for k, fn in wrappers.items()}
        waves = len(host)
        want = {k: expect_per_wave.get(impl, {}).get(k, 0) * waves
                for k in counts}
        check(counts == want, f"{tag} {impl}: launches {counts}, expected "
                              f"{want} ({waves} waves)")
        for kname, n in counts.items():
            launches[kname] = launches.get(kname, 0) + n
        results[impl] = np.stack(logits)
        check(bool(np.isfinite(results[impl]).all()),
              f"{tag} {impl}: non-finite logits")
        log(f"[serve {tag}] impl={impl}: {len(requests)} requests x 2 passes"
            f" in {waves} waves of {eng.batch}; median wave host assembly "
            f"{statistics.median(host):.3f} ms, device forward "
            f"{statistics.median(dev):.3f} ms (first wave "
            f"{host[0] + dev[0]:.3f} ms); launches {counts}")
        if impl != "ref":
            # wave-composition invariance: request 0 alone vs in its wave
            alone = _requests(spec)[:1]
            eng.run_wave(alone)
            d = float(np.abs(alone[0].logits - results[impl][0]).max())
            atol = (tol_of(impl)
                    or POLICY_TOLS[precision_of(impl)[1]])[0]
            check(d <= atol, f"{tag} {impl}: request alone vs in a full "
                             f"wave differs by {d:.3e}")
            log(f"[serve {tag}] impl={impl}: alone vs in a full wave: max "
                f"abs diff {d:.3e}")
    want = results["ref"]
    for impl in impls:
        if impl == "ref":
            continue
        err = np.abs(results[impl] - want)
        t = tol_of(impl)
        if t is not None:
            ok = bool((err <= t[0] + t[1] * np.abs(want)).all())
            check(ok, f"{tag} {impl} vs ref: max abs logit error "
                      f"{err.max():.3e} above {t}")
        rel = float((err / np.maximum(np.abs(want), 1e-6)).max())
        log(f"[serve {tag}] impl={impl} vs ref: max abs logit error "
            f"{err.max():.3e}, max relative {rel:.3e} (|logit| max "
            f"{np.abs(want).max():.3f}; "
            + (f"held within {t})" if t is not None else "not held)"))
    return launches


def _first_grads(cfg, params, batch, relu_masks=None):
    """gcn_loss's gradients at ``params`` on a placed batch (the first
    step's, computed apart from the counted run), and the input of each
    ReLU of the forward. With ``relu_masks`` (one boolean tensor per ReLU,
    in call order) each ReLU passes exactly where its mask holds: the
    gradients at another run's activation pattern."""
    import torch
    from repro_torch import tree
    from repro_torch.core.gcn import gcn_loss

    pre = []

    class Relu(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is not torch.relu:
                return func(*args, **(kwargs or {}))
            h = args[0]
            pre.append(h.detach())
            if relu_masks is None:
                return func(h)
            return h * relu_masks[len(pre) - 1]

    live = [p.detach().clone().requires_grad_() for p in tree.leaves(params)]
    with Relu():
        loss, _ = gcn_loss(tree.unflatten(params, live), cfg, batch["adj"],
                           batch["x"], batch["n_nodes"], batch["labels"])
    return torch.autograd.grad(loss, live), pre


def _grads_vs_ref(what, got, ref_cfg, params, batch):
    """Hold an impl's first-step gradients ``got = (grads, relu inputs)``
    against ref's at the same activation pattern, to GRAD_TOL. A ReLU input
    within f32 noise of 0 may land on either side in two impls whose sums
    run in another order, and then one ReLU's gradient passes where the
    other's does not, whatever the kernels; so ref's gradients are taken
    with the impl's ReLU masks; at most MAX_FLIPS ReLU inputs may differ
    in sign, each within FLIP_ATOL of 0. Returns (max abs error, sign
    differences, their largest |input|, max abs error without the
    masks)."""
    import torch

    grads, pre = got
    free, ref_pre = _first_grads(ref_cfg, params, batch)
    pinned, _ = _first_grads(ref_cfg, params, batch,
                             [p > 0 for p in pre])
    flips, flip_max = 0, 0.0
    for a, b in zip(pre, ref_pre):
        d = (a > 0) != (b > 0)
        flips += int(d.sum().item())
        if bool(d.any()):
            flip_max = max(flip_max, float(torch.maximum(
                a[d].abs(), b[d].abs()).max().item()))
    check(flips <= MAX_FLIPS,
          f"{what}: {flips} ReLU inputs differ in sign from ref's, more "
          f"than {MAX_FLIPS}")
    check(flip_max <= FLIP_ATOL,
          f"{what}: a ReLU input differs in sign from ref's at "
          f"|x| = {flip_max:.3e}, above {FLIP_ATOL}")
    err = max(max_err(g, r, what, GRAD_TOL) for g, r in zip(grads, pinned))
    free_err = max(float((g - r).abs().max().item())
                   for g, r in zip(grads, free))
    return err, flips, flip_max, free_err


def _grads_vs_plain(what, got, cfg, params, batch, tol, flip_atol):
    """Hold a variant's first-step gradients on the card ``got = (grads,
    relu inputs)`` against the same variant's plain versions on the CPU,
    taken at the card run's ReLU pattern, within ``tol``; at most MAX_FLIPS
    ReLU inputs may differ in sign, each within ``flip_atol`` of 0 (as in
    :func:`_grads_vs_ref`). Returns (max abs error, sign differences, their
    largest |input|)."""
    import torch
    from repro_torch import tree

    grads, pre = got
    cpu = tree.tree_map(lambda t: t.detach().cpu(), params)
    b_cpu = {"adj": [a.to("cpu") for a in batch["adj"]],
             **{k: batch[k].cpu() for k in ("x", "n_nodes", "labels")}}
    _, plain_pre = _first_grads(cfg, cpu, b_cpu)
    pinned, _ = _first_grads(cfg, cpu, b_cpu, [p.cpu() > 0 for p in pre])
    flips, flip_max = 0, 0.0
    for a, b in zip(pre, plain_pre):
        d = (a.cpu() > 0) != (b > 0)
        flips += int(d.sum().item())
        if bool(d.any()):
            flip_max = max(flip_max, float(torch.maximum(
                a.cpu()[d].abs(), b[d].abs()).max().item()))
    check(flips <= MAX_FLIPS,
          f"{what}: {flips} ReLU inputs differ in sign from the plain "
          f"versions', more than {MAX_FLIPS}")
    check(flip_max <= flip_atol,
          f"{what}: a ReLU input differs in sign from the plain versions' "
          f"at |x| = {flip_max:.3e}, above {flip_atol}")
    err = max(max_err(g.cpu(), r, what, tol) for g, r in zip(grads, pinned))
    return err, flips, flip_max


def phase_powerlaw(device):
    """ChemGCN at Tox21 widths on degree-skewed graphs, where the hybrid
    split has hub rows to take: logits and first-step gradients of the
    hybrid impls against ``ref``; returns launches per kernel."""
    import numpy as np
    import torch
    from repro_torch.core.batching import plan_hybrid
    from repro_torch.core.formats import row_degrees
    from repro_torch.core.gcn import GCNConfig, apply_gcn

    adj, m_pad = _powerlaw_channels(device)
    batch = POWERLAW["batch"]
    rng = np.random.default_rng(1)
    data = {"adj": adj,
            "x": torch.from_numpy(np.eye(62, dtype=np.float32)[
                rng.integers(0, 62, (batch, m_pad))]).to(device),
            "n_nodes": torch.full((batch,), m_pad, dtype=torch.int32,
                                  device=device),
            "labels": torch.from_numpy(rng.integers(0, 2, (batch, 12)).astype(
                np.float32)).to(device)}
    hp = plan_hybrid(batch=len(adj) * batch, m_pad=m_pad, n_b=64,
                     nnz_pad=adj[0].nnz_pad)
    fh = plan_hybrid(batch=batch, m_pad=m_pad, n_b=64,
                     nnz_pad=len(adj) * adj[0].nnz_pad)
    hubs = [int((row_degrees(a, m_pad) >= hp.dmin).sum().item()) / batch
            for a in adj]
    layer_hubs = int((sum(row_degrees(a, m_pad) for a in adj)
                      >= fh.dmin).sum().item()) / batch
    check(min(hubs) > 0 and layer_hubs > 0,
          f"powerlaw: no hub rows ({hubs}, layer {layer_hubs})")
    log(f"[powerlaw] {len(adj)} channels x {batch} matrices x {m_pad} rows, "
        f"nnz_pad {adj[0].nnz_pad}: hub rows per matrix {hubs} (dmin "
        f"{hp.dmin}, d_pad {hp.d_pad}); per sample over the channels "
        f"{layer_hubs:.3f} (fused_hybrid dmin {fh.dmin}, d_pad {fh.d_pad})")
    params = _params(GCNConfig.tox21(impl="ref"), 0, device)
    expect = {"ref": {},
              "pallas_hybrid": {"batched_spmm_hybrid": 4,
                                "batched_spmm_csr": 2},
              "fused_hybrid": {"fused_hybrid_forward": 4,
                               "batched_spmm_coo": 2}}
    logits, grads, launches = {}, {}, {}
    for impl, want in expect.items():
        cfg = GCNConfig.tox21(impl=impl)
        wrappers = _reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits[impl] = apply_gcn(params, cfg, adj, data["x"],
                                 data["n_nodes"])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads[impl] = _first_grads(cfg, params, data)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts = {k: fn.launches for k, fn in wrappers.items()}
        check(counts == {k: want.get(k, 0) for k in counts},
              f"powerlaw {impl}: launches {counts}, expected {want}")
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        check(bool(torch.isfinite(logits[impl]).all()),
              f"powerlaw {impl}: non-finite logits")
        log(f"[powerlaw] impl={impl}: apply_gcn {(t1 - t0) * 1e3:.3f} ms, "
            f"loss and gradients {(t2 - t1) * 1e3:.3f} ms (first calls); "
            f"launches {want}")
    for impl in ("pallas_hybrid", "fused_hybrid"):
        err = max_err(logits[impl], logits["ref"], f"powerlaw {impl} logits")
        g_err, flips, flip_max, free_err = _grads_vs_ref(
            f"powerlaw {impl} first-step grad", grads[impl],
            GCNConfig.tox21(impl="ref"), params, data)
        log(f"[powerlaw] impl={impl} vs ref: max abs logit error {err:.3e} "
            f"(|logit| max {logits['ref'].abs().max().item():.3f}); "
            f"first-step gradients max abs error {g_err:.3e} at the same "
            f"ReLU pattern ({flips} ReLU inputs of other sign, |x| <= "
            f"{flip_max:.1e}; {free_err:.3e} without it)")
    return launches


def _fit(trainer, data, on_phase=None):
    """``trainer.fit`` over ``data``, one batch per epoch so that
    ``on_metrics`` hands over every step's loss; returns the losses of the
    steps it trained."""
    losses = []
    trainer.fit(lambda e: [data[e]], epochs=len(data),
                on_metrics=lambda _, rec: losses.append(rec["loss"]),
                on_phase=on_phase)
    return losses


def phase_train(tag, cfg_fn, spec, run, impls, expect_per_step, device,
                resume_impl=None, curves_out=None):
    """Train ``run["steps"]`` Adam steps per impl from one set of seed-0
    parameters through ``GCNTrainer.fit``; returns launches per kernel.
    ``curves_out``, a dict, receives each impl's loss curve (``ref``'s the
    mean of its runs)."""
    import shutil

    import numpy as np
    import torch
    from repro_torch.autotune.cost_model import precision_of
    from repro_torch.optim.adam import AdamConfig
    from repro_torch.training.trainer import GCNTrainer, TrainerConfig

    steps = run["steps"]
    data = _train_batches(spec, run["batch"])[:steps]
    check(len(data) == steps, f"{tag}: {len(data)} batches for {steps} steps")
    first = _on(data[0], device)
    grads, curves, launches = {}, {}, {}

    def trainer(impl, ck):
        return GCNTrainer(cfg_fn(impl=impl), AdamConfig(lr=run["lr"]),
                          TrainerConfig(str(ck), checkpoint_every=10),
                          device=device)

    params0 = None
    for impl in impls:
        ck = CKPT_DIR / tag / impl
        shutil.rmtree(ck, ignore_errors=True)
        tr = trainer(impl, ck)
        params0 = tr.init_state()[0]     # seed 0: the same for every impl
        grads[impl] = _first_grads(tr.cfg, params0, first)
        marks = []

        def mark(phase):
            torch.cuda.synchronize()
            marks.append((phase, time.perf_counter()))

        wrappers = _reset_counters()
        mark("start")
        curves[impl] = np.asarray(_fit(tr, data, on_phase=mark))
        counts = {k: fn.launches for k, fn in wrappers.items()}
        want = {k: expect_per_step.get(impl, {}).get(k, 0) * steps
                for k in counts}
        check(counts == want, f"train {tag} {impl}: launches {counts}, "
                              f"expected {want}")
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        check(len(curves[impl]) == steps
              and bool(np.isfinite(curves[impl]).all()),
              f"train {tag} {impl}: loss curve {curves[impl]}")
        if impl == "ref":
            more = []
            for k in range(1, REF_RUNS):
                ck_k = CKPT_DIR / tag / f"ref-{k}"
                shutil.rmtree(ck_k, ignore_errors=True)
                more.append(np.asarray(_fit(trainer("ref", ck_k), data)))
            runs = np.stack([curves["ref"], *more])
            curves["ref"] = runs.mean(axis=0)
            ref_spread = float(np.max(np.abs(runs - curves["ref"])
                                      / np.abs(curves["ref"])))
            log(f"[train {tag}] impl=ref: {REF_RUNS} runs, the impls are "
                f"held against their mean curve; largest relative gap of "
                f"a run to the mean {ref_spread:.3e}")
        split = {p: [] for p in ("batch", "forward", "backward",
                                 "optimizer")}
        for (_, t0), (phase, t1) in zip(marks, marks[1:]):
            split[phase].append((t1 - t0) * 1e3)
        total = [sum(x) for x in zip(*split.values())]
        per_step = {k: n // steps for k, n in counts.items() if n}
        log(f"[train {tag}] impl={impl}: {steps} steps of {run['batch']}; "
            f"median ms per step: batch placement "
            f"{statistics.median(split['batch']):.3f}, forward "
            f"{statistics.median(split['forward']):.3f}, backward "
            f"{statistics.median(split['backward']):.3f}, optimizer "
            f"{statistics.median(split['optimizer']):.3f}, total "
            f"{statistics.median(total):.3f} (first step {total[0]:.3f}); "
            f"launches per step {per_step}; loss {curves[impl][0]:.5f} -> "
            f"{curves[impl][-1]:.5f}")
    for impl in impls:
        if impl == "ref":
            continue
        gap = float(np.max(np.abs(curves[impl] - curves["ref"])
                           / np.abs(curves["ref"])))
        policy = precision_of(impl)[1]
        if policy != "f32":
            # a variant: its gradients against its own plain versions (the
            # layer-gradient rule, 3x its policy's tolerance for bf16, 3x
            # f32 for i8 whose codes are shared), its curve within its
            # policy's rtol of the mean f32 ref curve
            g_tol = (tuple(3 * t for t in POLICY_TOLS[policy])
                     if policy == "bf16" else GRAD_TOL)
            g_err, flips, flip_max = _grads_vs_plain(
                f"train {tag} {impl} first-step grad", grads[impl],
                cfg_fn(impl=impl), params0, first, g_tol,
                FLIP_ATOL_BF16 if policy == "bf16" else FLIP_ATOL)
            rtol = POLICY_TOLS[policy][1]
            check(bool(np.isfinite(curves[impl]).all()) and gap <= rtol,
                  f"train {tag} {impl}: loss curve differs from ref by "
                  f"{gap:.3e} relative, above {rtol}")
            log(f"[train {tag}] impl={impl}: first-step gradients on the "
                f"card vs its plain versions on the CPU: max abs error "
                f"{g_err:.3e} at the same ReLU pattern (tolerance {g_tol}; "
                f"{flips} ReLU inputs of other sign, |x| <= {flip_max:.1e});"
                f" loss curve vs the f32 ref curve: max relative gap "
                f"{gap:.3e} (tolerance {rtol})")
            continue
        g_err, flips, flip_max, free_err = _grads_vs_ref(
            f"train {tag} {impl} first-step grad", grads[impl],
            cfg_fn(impl="ref"), params0, first)
        check(gap <= CURVE_RTOL, f"train {tag} {impl}: loss curve differs "
                                 f"from ref by {gap:.3e} relative")
        log(f"[train {tag}] impl={impl} vs ref: first-step gradients max abs"
            f" error {g_err:.3e} at the same ReLU pattern (tolerance "
            f"{GRAD_TOL}; {flips} ReLU inputs of other sign, |x| <= "
            f"{flip_max:.1e}; {free_err:.3e} without it); loss curve max "
            f"relative gap {gap:.3e}")
    if resume_impl is not None:
        # a fresh trainer over a directory that holds only the step-10
        # checkpoint resumes there and continues the same curve
        src = CKPT_DIR / tag / resume_impl
        dst = CKPT_DIR / tag / f"{resume_impl}-resume"
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(src / "step_0000000010", dst / "step_0000000010")
        tail = np.asarray(_fit(trainer(resume_impl, dst), data))
        check(len(tail) == steps - 10, f"resume trained {len(tail)} steps")
        gap = float(np.max(np.abs(tail - curves[resume_impl][10:])
                           / np.abs(curves[resume_impl][10:])))
        check(gap <= CURVE_RTOL, f"train {tag} {resume_impl}: the resumed "
                                 f"curve differs by {gap:.3e} relative")
        log(f"[train {tag}] impl={resume_impl}: resumed from the step-10 "
            f"checkpoint, steps 11-{steps} max relative gap {gap:.3e}")
    shutil.rmtree(CKPT_DIR / tag, ignore_errors=True)
    if curves_out is not None:
        curves_out.update(curves)
    return launches


def _auto_expect(decisions, per_impl):
    """Launches per wave or step of an ``impl="auto"`` model whose conv
    layers resolved to ``decisions``: each layer takes its impl's share of
    ``per_impl[impl]`` (the pinned expectation of a model whose every layer
    runs that impl)."""
    out = {}
    for d in decisions:
        for k, n in per_impl.get(d.impl, {}).items():
            out[k] = out.get(k, 0) + n // len(decisions)
    return out


def _serving_launches(layers):
    """Launches per wave of a served model whose ``layers`` conv layers
    all run one kernel impl, for every kernel impl."""
    return {impl: {kernel: layers} for impl, kernel in KERNEL_OF.items()}


def _log_decision(tag, d):
    top = ", ".join(f"{i} {t * 1e3:.3f}" for i, t in d.scores[:3])
    log(f"[autotune] {tag}: impl={d.impl} kind={d.kind} case={d.case} "
        f"source={d.source}; model ms: {top}")


def phase_autotune(device):
    """``impl="auto"`` on the card. (a) The cost model's decision for every
    conv layer of Tox21 and Reaction100 serving (waves of 128) and training
    (batches of 50 and 100), then ``autotune`` times every candidate of
    ``rank_layer`` into a fresh tuning cache: the model's pick within
    AUTO_MODEL_RATIO of the measured best. (b) With that cache as the
    process's (``$REPRO_TORCH_TUNE_CACHE``): every layer resolves to the
    record's best from the cache, re-timed beside the record's next two
    (within AUTO_CACHE_RATIO of the fastest); ``GCNConfig.tox21()`` (the
    default impl) serves the Tox21 requests beside ``ref`` and the pinned
    impl, and trains 5 Tox21 steps beside the pinned impl (loss within
    F32_TOL of it), launching the chosen impl's kernels. (c) GAT and R-GCN
    serve Tox21 with ``auto``; (d) Tox21 serving under the bf16 policy;
    (e) the case-3 decision at 2 x 9000 (the forced ``ref``, timed beside
    the CSR kernel's large entry). Returns launches per kernel of each
    ``auto`` path."""
    import os
    import shutil

    import numpy as np
    import torch
    from repro_torch import autotune
    from repro_torch.core.gcn import GCNConfig, resolve_conv_impls
    from repro_torch.data.graphs import GraphDatasetSpec
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    tox_spec = GraphDatasetSpec.tox21_like(TRAIN_TOX21["n_samples"], seed=0)
    r_spec = GraphDatasetSpec.reaction100_like(
        TRAIN_R100["batch"] * TRAIN_R100["steps"], seed=0)

    def train_geometry(spec, batch):
        b = _train_batches(spec, batch)[0]
        return (b["x"].shape[0], b["x"].shape[1],
                max(a.nnz_pad for a in b["adj"]))

    serve = (TOX21["batch"], TOX21["m_pad"], TOX21["nnz_pad"])
    paths = (("serve tox21", GCNConfig.tox21(), serve),
             ("train tox21", GCNConfig.tox21(),
              train_geometry(tox_spec, TRAIN_TOX21["batch"])),
             ("serve reaction100", GCNConfig.reaction100(), serve),
             ("train reaction100", GCNConfig.reaction100(),
              train_geometry(r_spec, TRAIN_R100["batch"])))
    cache_dir = ROOT / "build" / "chip_smoke_tune"
    shutil.rmtree(cache_dir, ignore_errors=True)
    cache = autotune.TuningCache(str(cache_dir / "tune.json"))
    check(os.environ.get(autotune.ENV_VAR) is None,
          f"${autotune.ENV_VAR} is set: the model's decisions need none")
    # (a) the model's decisions, then every candidate timed
    layers = []
    for tag, cfg, geo in paths:
        for i, d in enumerate(resolve_conv_impls(cfg, *geo, device=device)):
            check(d.source == "model" and d.case != 3,
                  f"{tag} layer {i + 1}: {d}")
            _log_decision(f"{tag} layer {i + 1} {d.workload.key()}", d)
            best = autotune.autotune(d.workload, cache=cache, device=device)
            times = cache.times(d.workload.key())
            w = d.workload
            ranked = {c for c, _ in d.scores
                      if w.nnz_pad <= w.m_pad * w.k_pad
                      or autotune.precision_of(c)[0] not in ("ell",
                                                             "pallas_ell")}
            check(set(times) == ranked,
                  f"{tag} layer {i + 1}: timed {sorted(times)}, ranked "
                  f"{sorted(ranked)}")
            ratio = times[d.impl] / times[best]
            log(f"[autotune] {tag} layer {i + 1}: measured ms "
                + ", ".join(f"{k} {v * 1e3:.3f}" for k, v in
                            sorted(times.items(), key=lambda kv: kv[1]))
                + f"; model's pick {d.impl} / best {best} = {ratio:.3f}")
            check(ratio <= AUTO_MODEL_RATIO,
                  f"{tag} layer {i + 1}: the model's pick {d.impl} measured "
                  f"{ratio:.3f}x the best ({best})")
            layers.append((tag, i, cfg, geo, d.workload))
    os.environ[autotune.ENV_VAR] = cache.path
    launches = {}
    try:
        # (b) the cache decides, the pick re-timed beside the next two
        tox_decisions = {}
        for tag, i, cfg, geo, w in layers:
            d = resolve_conv_impls(cfg, *geo, device=device)[i]
            times = cache.times(w.key())
            check(d.source == "cache" and d.impl == cache.best(w.key()),
                  f"{tag} layer {i + 1} with the cache: {d}")
            if tag.endswith("tox21"):
                tox_decisions.setdefault(tag, []).append(d)
            rivals = sorted(times, key=times.get)[:3]
            again = autotune.measure_workload(w, tuple(rivals),
                                              device=device, iters=60)
            ratio = again[d.impl] / min(again.values())
            log(f"[autotune] {tag} layer {i + 1} with the cache: "
                f"impl={d.impl} source={d.source}; re-timed ms "
                + ", ".join(f"{k} {v * 1e3:.3f}" for k, v in again.items())
                + f"; pick / fastest {ratio:.3f}")
            check(ratio <= AUTO_CACHE_RATIO,
                  f"{tag} layer {i + 1}: the cache's pick {d.impl} re-timed "
                  f"{ratio:.3f}x the fastest of {again}")
        serve_d = tox_decisions["serve tox21"]
        pinned = serve_d[0].impl
        exp = {"auto": _auto_expect(serve_d, SERVE_TOX21_LAUNCHES),
               pinned: SERVE_TOX21_LAUNCHES.get(pinned, {})}
        launches["serve tox21 auto"] = phase_serve(
            "tox21 auto", GCNConfig.tox21,
            GraphDatasetSpec.tox21_like(N_REQUESTS, seed=0),
            tuple(dict.fromkeys(("ref", "auto", pinned))), exp, device,
            F32_TOL)
        train_d = tox_decisions["train tox21"]
        pinned = train_d[0].impl
        curves = {}
        exp = {"auto": _auto_expect(train_d, TRAIN_TOX21_LAUNCHES),
               pinned: TRAIN_TOX21_LAUNCHES.get(pinned, {})}
        launches["train tox21 auto"] = phase_train(
            "tox21-auto", GCNConfig.tox21, tox_spec,
            dict(TRAIN_TOX21, steps=AUTO_TRAIN_STEPS),
            tuple(dict.fromkeys(("ref", "auto", pinned))), exp, device,
            curves_out=curves)
        if all(d.impl == pinned for d in train_d):
            gap = np.abs(curves["auto"] - curves[pinned])
            ok = bool((gap <= F32_TOL[0]
                       + F32_TOL[1] * np.abs(curves[pinned])).all())
            check(ok, f"train tox21 auto vs pinned {pinned}: losses "
                      f"{curves['auto']} vs {curves[pinned]}")
            log(f"[autotune] train tox21: auto vs pinned {pinned}: max abs "
                f"loss gap {gap.max():.3e} over {AUTO_TRAIN_STEPS} steps "
                f"(tolerance {F32_TOL})")
        # (c) GAT and R-GCN over the g-SpMM ladder, model decisions
        for layer in ("gat", "rgcn"):
            cfg = GCNConfig.tox21(layer=layer)
            decisions = resolve_conv_impls(cfg, *serve, device=device)
            for i, d in enumerate(decisions):
                _log_decision(f"serve tox21 {layer} layer {i + 1}", d)
            gmm = {"grouped_matmul": len(decisions)} if layer == "rgcn" \
                else {}
            exp = {"ref": gmm, "auto": {**gmm, **_auto_expect(
                decisions, _serving_launches(len(decisions)))}}
            launches[f"serve tox21 {layer} auto"] = phase_serve(
                f"tox21 {layer} auto",
                lambda layer=layer, **kw: GCNConfig.tox21(layer=layer, **kw),
                GraphDatasetSpec.tox21_like(N_REQUESTS, seed=0),
                ("ref", "auto"), exp, device, F32_TOL)
        # (d) the bf16 policy's ladder
        cfg = GCNConfig.tox21(precision="bf16")
        decisions = resolve_conv_impls(cfg, *serve, device=device)
        for i, d in enumerate(decisions):
            _log_decision(f"serve tox21 bf16 layer {i + 1}", d)
        policy = max((autotune.precision_of(d.impl)[1] for d in decisions),
                     key=("f32", "i8", "bf16").index)
        launches["serve tox21 bf16 auto"] = phase_serve(
            "tox21 bf16 auto",
            lambda **kw: GCNConfig.tox21(precision="bf16", **kw),
            GraphDatasetSpec.tox21_like(N_REQUESTS, seed=0), ("ref", "auto"),
            {"auto": _auto_expect(decisions,
                                  _serving_launches(len(decisions)))},
            device, F32_TOL,
            impl_tol={"auto": POLICY_TOLS[policy]})
    finally:
        del os.environ[autotune.ENV_VAR]
        shutil.rmtree(cache_dir, ignore_errors=True)
    # (e) planner case 3: forced to ref, priced beside the CSR large entry
    _, m_pad, batch = LARGE_SHAPES[-1]
    coo = _large_coo(m_pad, batch, seed=21).to(device)
    b = torch.zeros((batch, m_pad, 64), device=device)
    d = ops.resolve_impl(coo, b, k_pad=76)
    check((d.impl, d.source, d.case) == ("ref", "forced", 3),
          f"case 3 at {batch} x {m_pad}: {d}")
    times = autotune.measure_workload(d.workload, ("ref", "pallas_csr"),
                                      device=device)
    log(f"[autotune] case 3 ({batch} x {m_pad}, nnz_pad {coo.nnz_pad}, n_b "
        f"64): impl={d.impl} source={d.source}; wall ms per call: ref "
        f"{times['ref'] * 1e3:.3f}, pallas_csr (the CSR large entry) "
        f"{times['pallas_csr'] * 1e3:.3f}")
    log(f"[autotune] phase done in {time.perf_counter() - t0:.1f} s")
    return launches


def phase_gnn_paths(device):
    """ChemGCN with GAT and R-GCN conv layers: serve Tox21 (both) and
    Reaction100 (R-GCN, the grouped matmul at 512 width), train Tox21
    (both, with a resume); returns launches per kernel of each path."""
    from repro_torch.core.gcn import GCNConfig
    from repro_torch.data.graphs import GraphDatasetSpec

    impls = ("ref", "pallas_coo", "pallas_csr", "pallas_ell")
    kernel = {"pallas_coo": "batched_spmm_coo",
              "pallas_csr": "batched_spmm_csr",
              "pallas_ell": "batched_spmm_ell"}
    paths = {}
    for layer in ("rgcn", "gat"):
        def cfg_fn(layer=layer, **kw):
            return GCNConfig.tox21(layer=layer, **kw)

        # per layer: R-GCN one grouped matmul (every impl, ref too: the
        # reference's R-GCN always runs its _gmm) and one g-SpMM; GAT one
        # g-SpMM. A training step adds the grouped matmul of layer 2's dx
        # (layer 1's input takes no gradient); the g-SpMM backward is plain.
        wave = {"grouped_matmul": 2} if layer == "rgcn" else {}
        step = {"grouped_matmul": 3} if layer == "rgcn" else {}
        serve = {"ref": wave, **{i: {**wave, k: 2} for i, k in kernel.items()}}
        train = {"ref": step, **{i: {**step, k: 2} for i, k in kernel.items()}}
        paths[f"serve tox21 {layer}"] = phase_serve(
            f"tox21 {layer}", cfg_fn,
            GraphDatasetSpec.tox21_like(N_REQUESTS, seed=0), impls, serve,
            device, F32_TOL)
        paths[f"train tox21 {layer}"] = phase_train(
            f"tox21-{layer}", cfg_fn,
            GraphDatasetSpec.tox21_like(TRAIN_TOX21["n_samples"], seed=0),
            dict(TRAIN_TOX21, steps=TRAIN_GNN_STEPS), impls, train, device,
            resume_impl="pallas_csr")
    paths["serve reaction100 rgcn"] = phase_serve(
        "reaction100 rgcn",
        lambda **kw: GCNConfig.reaction100(layer="rgcn", **kw),
        GraphDatasetSpec.reaction100_like(N_REQUESTS, seed=0),
        ("ref", "pallas_csr"),
        {"ref": {"grouped_matmul": 3},
         "pallas_csr": {"grouped_matmul": 3, "batched_spmm_csr": 3}},
        device, F32_TOL)
    return paths


def phase_precision_paths(device):
    """ChemGCN with each reduced-precision variant pinned: serve Tox21 (all
    nine, logits within TOLS[policy] of f32 ref) and Reaction100
    (fused_bf16, pallas_hybrid_bf16, pallas_csr_i8; the gap to ref printed),
    and train 20 Tox21 steps (fused_bf16, pallas_csr_bf16,
    pallas_hybrid_bf16, pallas_ell_i8; first-step gradients against the
    variant's own plain versions, loss curves within TOLS[policy] rtol of
    the mean f32 ref curve); returns launches per kernel of each path."""
    from repro_torch.autotune.cost_model import PRECISION_IMPLS, \
        precision_of
    from repro_torch.core.gcn import GCNConfig
    from repro_torch.data.graphs import GraphDatasetSpec

    # the kernel each variant's forward launches; ell_bf16 and csr_bf16
    # are plain (the reference's XLA siblings) and launch none
    entry = {"pallas_ell_bf16": "batched_spmm_ell_bf16",
             "pallas_ell_i8": "batched_spmm_ell_i8",
             "pallas_csr_bf16": "batched_spmm_csr_bf16",
             "pallas_csr_i8": "batched_spmm_csr_i8",
             "pallas_coo_bf16": "batched_spmm_coo_bf16",
             "fused_bf16": "fused_forward_bf16",
             "pallas_hybrid_bf16": "batched_spmm_hybrid_bf16"}
    variants = tuple(PRECISION_IMPLS)
    tols = {i: POLICY_TOLS[precision_of(i)[1]] for i in variants}
    paths = {}
    paths["serve tox21 precision"] = phase_serve(
        "tox21", GCNConfig.tox21,
        GraphDatasetSpec.tox21_like(N_REQUESTS, seed=0), ("ref",) + variants,
        {i: {entry[i]: 2} for i in entry}, device, F32_TOL, impl_tol=tols)
    r_impls = ("fused_bf16", "pallas_hybrid_bf16", "pallas_csr_i8")
    paths["serve reaction100 precision"] = phase_serve(
        "reaction100", GCNConfig.reaction100,
        GraphDatasetSpec.reaction100_like(N_REQUESTS, seed=0),
        ("ref",) + r_impls, {i: {entry[i]: 3} for i in r_impls}, device,
        F32_TOL, impl_tol={i: None for i in r_impls})
    paths["train tox21 precision"] = phase_train(
        "tox21-precision", GCNConfig.tox21,
        GraphDatasetSpec.tox21_like(TRAIN_TOX21["n_samples"], seed=0),
        TRAIN_TOX21, ("ref", "fused_bf16", "pallas_csr_bf16",
                      "pallas_hybrid_bf16", "pallas_ell_i8"),
        {"fused_bf16": {"fused_forward_bf16": 2, "batched_spmm_coo_bf16": 2},
         "pallas_csr_bf16": {"batched_spmm_csr_bf16": 4},
         "pallas_hybrid_bf16": {"batched_spmm_hybrid_bf16": 2,
                                "batched_spmm_csr_bf16": 2},
         "pallas_ell_i8": {"batched_spmm_ell_i8": 2, "batched_spmm_coo": 2}},
        device)
    return paths


def _attended_pairs(tq: int, tk: int, causal: bool, window: int) -> int:
    """(query, key) pairs that the mask keeps, per (batch, head)."""
    n = 0
    for t in range(tq):
        hi = min(t + 1, tk) if causal else tk
        lo = max(0, t - window + 1) if window else 0
        n += max(0, hi - lo)
    return n


def phase_flash_kernels(device, rows, errs):
    """The flash-attention kernel against its plain version: at the
    Llama-3-8B prefill shape (bf16, timed, with its bound and SDPA beside
    it), on the reference test's five corners and at FLASH_WIDTHS in f32
    and bf16, identical bits twice everywhere; then the HGMMA count of the
    bf16 entry's SASS. Adds to ``rows`` and ``errs``."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import KV_TILE, flash_attention

    from repro_torch import configs

    gen = torch.Generator(device=device).manual_seed(4)
    cfg = configs.get(LM_ARCH)
    b, t = PREFILL["batch"], PREFILL["seq_len"]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    # (tag, b, t, h, kv, hd, causal, window, dtype): the main path's shape,
    # then tests/test_kernels.py's five corners
    cases = [("llama3-8b prefill", b, t, h, kv, hd, True, 0, "bfloat16"),
             ("llama3-8b prefill float32", b, t, h, kv, hd, True, 0,
              "float32")]
    for dtype in ("float32", "bfloat16"):
        cases += [(f"mha causal {dtype}", 2, 64, 4, 4, 32, True, 0, dtype),
                  (f"gqa {dtype}", 1, 128, 8, 2, 16, True, 0, dtype),
                  (f"mqa ragged {dtype}", 2, 96, 4, 1, 32, True, 0, dtype),
                  (f"window 48 {dtype}", 1, 128, 4, 4, 32, True, 48, dtype),
                  (f"bidirectional {dtype}", 2, 64, 4, 2, 32, False, 0,
                   dtype)]
        # every head width of FLASH_WIDTHS, causal GQA at a ragged length
        cases += [(f"hd {w} {dtype}", 1, 300, 8, 2, w, True, 0, dtype)
                  for w in FLASH_WIDTHS]
    err = main_f32 = 0.0
    for tag, b, t, h, kv, hd, causal, window, dtype in cases:
        dt = getattr(torch, dtype)
        q = torch.randn((b, t, h, hd), generator=gen, device=device).to(dt)
        k, v = (torch.randn((b, t, kv, hd), generator=gen,
                            device=device).to(dt) for _ in range(2))
        kw = dict(causal=causal, window=window)

        def kern(q=q, k=k, v=v, kw=kw):
            return flash_attention(q, k, v, **kw)

        def plain(q=q, k=k, v=v, kw=kw):
            return ref.flash_attention_plain(q, k, v, kv_block=KV_TILE, **kw)

        tol = (FLASH_MAIN_TOL if tag.startswith("llama3-8b") else
               FLASH_TOL)[dtype]
        if tag != "llama3-8b prefill":
            got = kern()
            e = max_err(got.float(), plain().float(),
                        f"flash_attention {tag}", tol)
            main_f32 = e if tag.startswith("llama3-8b") else main_f32
            err = max(err, e)
            check(torch.equal(got, kern()),
                  f"flash_attention {tag}: two calls differ")
            continue

        def library(q=q, k=k, v=v):
            return torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True).transpose(1, 2)

        flops = 4 * b * h * hd * _attended_pairs(t, t, causal, window)
        # q, k and v read once, the output (q's shape) written once
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        key = f"flash_attention[{tag}]"
        _measure(rows, key, "flash_attention", kern, plain, nbytes, flops,
                 f"B {b}, T {t}, H {h}, KV {kv}, hd {hd}, causal, {dtype}, "
                 f"{flops:.3e} FLOP unmasked", library, bitwise=True,
                 tol=tol, flop_rate=BF16_FLOP_PER_S, iters=3, replays=2,
                 library_tol=FLASH_TOL[dtype])
        err = max(err, rows[key]["max_abs_err"])
        del q, k, v
    errs["flash_attention"] = err
    log("[kernels] flash_attention on the five corners of "
        "tests/test_kernels.py (MHA causal, GQA, MQA with T 96, window 48, "
        f"bidirectional) and at head widths {FLASH_WIDTHS} (T 300, GQA 8 / "
        f"2) in f32 (tolerance {FLASH_TOL['float32']}) and bf16 "
        f"({FLASH_TOL['bfloat16']}) and at the Llama-3-8B prefill shape in "
        f"bf16 ({FLASH_MAIN_TOL['bfloat16']}) and f32 (max abs err "
        f"{main_f32:.3e}, tolerance {FLASH_MAIN_TOL['float32']}) matches its "
        "plain version, identical bits twice")
    _log_rows([rows["flash_attention[llama3-8b prefill]"]])
    torch.cuda.empty_cache()
    hgmma = _sass_count("flash_attention", "flash_wgmma_kernel", "HGMMA")
    check(all(n > 0 for n in hgmma.values()) and len(hgmma) == 4,
          f"flash_attention: HGMMA per bf16 kernel {hgmma}")
    log(f"[kernels] flash_attention bf16 entry: HGMMA (wgmma) instructions "
        f"in the SASS of each head-width instance (cuobjdump -sass): "
        f"{hgmma}")


def _sass_count(lib: str, kernel: str, opcode: str) -> dict:
    """``opcode`` instructions in the SASS of each function of the built
    library ``lib`` whose name holds ``kernel`` (``_build.sass_count``);
    keyed by the function's first integer template argument."""
    import re

    from repro_torch.kernels import _build

    try:
        counts = _build.sass_count(lib, kernel, opcode)
    except RuntimeError as e:
        raise SmokeFailure(str(e)) from e
    return {re.search(r"ILi(\d+)E", fn.split(kernel, 1)[1]).group(1): n
            for fn, n in counts.items()}


def _lm_prompts(cfg):
    """LM_SERVE's requests: prompts of min_prompt..max_prompt tokens from
    ``make_batch`` (seed 0, step 1), new_tokens each, the fourth with a
    budget of 0."""
    from repro_torch.data.tokens import TokenStreamSpec, make_batch
    from repro_torch.serving.engine import Request

    n, lo, hi = (LM_SERVE["n_requests"], LM_SERVE["min_prompt"],
                 LM_SERVE["max_prompt"])
    toks = make_batch(TokenStreamSpec(vocab=cfg.vocab, batch=n, seq_len=hi,
                                      seed=0), 1)
    lengths = [lo + (hi - lo) * i // (n - 1) for i in range(n)]
    return [Request(prompt=toks[i, :lengths[i]].tolist(),
                    max_new_tokens=0 if i == 3 else LM_SERVE["new_tokens"])
            for i in range(n)]


def phase_lm(device):
    """Llama-3-8B at full width on the card: ``lm.prefill`` of 2 x 4096
    tokens through the flash-attention kernel and through the two plain
    impls, then ``ServeEngine`` waves of greedy decode; the model is freed
    before the next phase. Returns the launches per kernel of each path."""
    import gc

    import torch

    paths = _lm_paths(device)
    gc.collect()
    torch.cuda.empty_cache()
    allocated = torch.cuda.memory_allocated()
    check(allocated < 1e9, f"{allocated / 1e9:.2f} GB still allocated after "
                           "the LM phases")
    log(f"[lm] model freed: {allocated / 1e9:.2f} GB allocated on the card")
    return paths


def _lm_paths(device):
    """The body of :func:`phase_lm`; everything it allocates dies with its
    frame."""
    import torch
    from repro_torch import configs, tree, tuning
    from repro_torch.data.tokens import TokenStreamSpec, make_batch
    from repro_torch.models import lm
    from repro_torch.serving.engine import Request, ServeEngine

    cfg = configs.get(LM_ARCH)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = lm.init_params(
        cfg, generator=torch.Generator(device=device).manual_seed(0),
        device=device)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree.leaves(params))
    blk = params["blocks"]["0_attn_dense"]
    n_norm = params["final_norm"]["scale"].numel() + sum(
        p["scale"].numel() for p in (blk["ln1"], blk["ln2"], *(
            blk["attn"][k] for k in ("q_norm", "k_norm")
            if k in blk["attn"])))
    check(n_params - n_norm == cfg.param_count(),
          f"{n_params} parameters ({n_norm} in norms), param_count() says "
          f"{cfg.param_count()} without the norms")
    log(f"[lm] {LM_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV heads of {cfg.head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}: {n_params} "
        f"parameters ({torch.cuda.memory_allocated() / 1e9:.2f} GB) drawn on "
        f"the card in {time.perf_counter() - t0:.2f} s")

    # -- prefill -----------------------------------------------------------
    toks = make_batch(TokenStreamSpec(vocab=cfg.vocab,
                                      batch=PREFILL["batch"],
                                      seq_len=PREFILL["seq_len"], seed=0), 0)
    batch = {"tokens": torch.from_numpy(toks).to(device)}
    n_tok = toks.size
    orders = {"pallas": {}, "xla_packed": {}, "xla_chunked": {},
              "xla_chunked 512": CHUNKED_ORDER}
    last, launches = {}, {}
    for name, blocks in orders.items():
        impl = name.split()[0]
        wrappers = _reset_counters()
        torch.cuda.reset_peak_memory_stats()
        times = []
        with torch.inference_mode(), tuning.use_flags(attention_impl=impl,
                                                      **blocks):
            for _ in range(PREFILL["calls"]):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                logits, enc_out = lm.prefill(params, cfg, batch)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t1) * 1e3)
        counts = {k: fn.launches for k, fn in wrappers.items()}
        want = {k: 0 for k in counts}
        if impl == "pallas":
            want["flash_attention"] = cfg.n_layers * PREFILL["calls"]
            launches = counts
        check(counts == want, f"prefill {name}: launches {counts}, expected "
                              f"{want}")
        check(enc_out is None and tuple(logits.shape) == (
            PREFILL["batch"], 1, cfg.vocab), f"prefill {name}: "
            f"{tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all()),
              f"prefill {name}: non-finite logits")
        last[name] = logits[:, 0].float()
        log(f"[lm prefill] attention_impl={name}: {PREFILL['batch']} x "
            f"{PREFILL['seq_len']} tokens, ms per call {times[0]:.1f} (first)"
            f", {times[-1]:.1f} (last): {n_tok / times[-1] * 1e3:.0f} tokens/"
            f"s; flash_attention launches {counts['flash_attention']}; peak "
            f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    same = torch.equal(last["xla_packed"], last["xla_chunked"])
    floor = float((last["xla_chunked 512"] - last["xla_packed"]).abs().max())
    gap = float((last["pallas"] - last["xla_packed"]).abs().max())
    gap_c = float((last["pallas"] - last["xla_chunked 512"]).abs().max())
    check(floor > 0, "the two plain orders agree bit for bit: no noise floor")
    check(gap <= NOISE_MULT * floor,
          f"prefill: the kernel's last logits differ from xla_packed's by "
          f"{gap:.3e}, more than {NOISE_MULT} x the noise floor {floor:.3e}")
    ref_logits = last["xla_packed"]
    top2 = ref_logits.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    decided = margin > floor
    agree = ref_logits.argmax(-1) == last["pallas"].argmax(-1)
    check(bool(agree[decided].all()),
          f"prefill: argmax differs where the top-2 margin {margin.tolist()} "
          f"exceeds the floor {floor:.3e}")
    log(f"[lm prefill] xla_chunked at the default blocks equals xla_packed "
        f"bit for bit: {same}; noise floor (xla_chunked at "
        f"{CHUNKED_ORDER['q_block']}-blocks vs xla_packed) {floor:.4e}; "
        f"kernel vs xla_packed {gap:.4e} ({gap / floor:.2f} x the floor, "
        f"limit {NOISE_MULT}), vs xla_chunked 512 {gap_c:.4e}; |logit| max "
        f"{float(ref_logits.abs().max()):.3f}; argmax agrees on "
        f"{int(agree.sum())} of {agree.numel()} rows ({int(decided.sum())} "
        f"with a top-2 margin above the floor: {margin.tolist()})")
    paths = {"lm prefill": launches}

    # -- serving -----------------------------------------------------------
    engine = ServeEngine(params, cfg, batch=LM_SERVE["batch"],
                         max_len=LM_SERVE["max_len"], device=device)
    steps = []
    decode = engine._decode

    def counted(*a):
        steps.append(1)
        return decode(*a)

    engine._decode = counted
    outs = []
    for attempt in range(2):
        reqs = _lm_prompts(cfg)
        wrappers = _reset_counters()
        torch.cuda.reset_peak_memory_stats()
        steps.clear()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        engine.run(reqs)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) * 1e3
        counts = {k: fn.launches for k, fn in wrappers.items()}
        check(counts == {k: 0 for k in counts},
              f"serve: launches {counts}, expected none")
        for i, r in enumerate(reqs):
            check(r.done and not r.truncated
                  and len(r.out) == r.max_new_tokens
                  and all(0 <= x < cfg.vocab for x in r.out),
                  f"serve: request {i} done={r.done} truncated="
                  f"{r.truncated} with {len(r.out)} of {r.max_new_tokens} "
                  "tokens")
        outs.append([r.out for r in reqs])
        generated = sum(len(r.out) for r in reqs)
        if attempt == 0:
            first = (wall, len(steps), generated,
                     torch.cuda.max_memory_allocated())
    check(outs[0] == outs[1], "serve: greedy tokens differ between two runs")
    paths["lm serve"] = counts
    # device time of one decode step at the serving batch: CUDA-graph
    # replay of decode_step at position 128 of a fresh cache
    with torch.inference_mode():
        caches = lm.init_decode_state(cfg, LM_SERVE["batch"],
                                      LM_SERVE["max_len"], device=device)
        tok = torch.zeros((LM_SERVE["batch"], 1), dtype=torch.int64,
                          device=device)
        step_dev = graph_ms(lambda: lm.decode_step(params, cfg, tok, caches,
                                                   128), iters=5, replays=4)
    wall, n_steps, generated, peak = first
    per_step = wall / n_steps
    log(f"[lm serve] ServeEngine(batch={LM_SERVE['batch']}, max_len="
        f"{LM_SERVE['max_len']}): {LM_SERVE['n_requests']} requests (prompts "
        f"{LM_SERVE['min_prompt']}-{LM_SERVE['max_prompt']} tokens, "
        f"{LM_SERVE['new_tokens']} new, one with 0) in "
        f"{-(-LM_SERVE['n_requests'] // LM_SERVE['batch'])} waves: every "
        f"request done with exact lengths; {n_steps} decode steps in "
        f"{wall:.1f} ms ({generated} tokens generated: "
        f"{generated / wall * 1e3:.1f} tokens/s, "
        f"{n_steps * LM_SERVE['batch'] / wall * 1e3:.1f} slot-steps/s); ms "
        f"per decode step {per_step:.2f} wall = {step_dev:.2f} device "
        f"(CUDA-graph replay) + {per_step - step_dev:.2f} host; greedy "
        f"tokens identical on a second run; peak memory {peak / 1e9:.2f} GB")
    log("[lm serve] flash_attention launches while serving: 0 (decode "
        "attends over the KV cache by plain products, as the reference's "
        "decode does; the kernel runs only in prefill and forward)")

    # one-request waves of unpadded prompts: each first token against the
    # argmax of prefill's last logits through the kernel, where the top-2
    # margin exceeds that prompt's own noise floor (xla_packed against
    # xla_chunked at 8-blocks; a floor of 0 decides nothing)
    decided = agreed = 0
    for req in _lm_prompts(cfg):
        r = Request(prompt=req.prompt, max_new_tokens=1)
        engine.run([r])
        toks1 = {"tokens": torch.tensor([r.prompt], device=device)}
        got = {}
        for impl, blocks in (("pallas", {}), ("xla_packed", {}),
                             ("xla_chunked", dict(q_block=8, kv_block=8))):
            with torch.inference_mode(), tuning.use_flags(
                    attention_impl=impl, **blocks):
                got[impl] = lm.prefill(params, cfg, toks1)[0][0, 0].float()
        floor_p = float((got["xla_packed"] - got["xla_chunked"]).abs().max())
        top2 = got["pallas"].topk(2).values
        m = float(top2[0] - top2[1])
        hit = r.out[0] == int(got["pallas"].argmax())
        if 0 < floor_p < m:
            decided += 1
            agreed += hit
            check(hit, f"serve: first token {r.out[0]} of a "
                       f"{len(r.prompt)}-token prompt is not prefill's "
                       f"argmax {int(got['pallas'].argmax())} (margin "
                       f"{m:.3e} > floor {floor_p:.3e})")
        log(f"[lm serve] one-request wave of a {len(r.prompt)}-token prompt: "
            f"first token {r.out[0]}, prefill (kernel) argmax "
            f"{int(got['pallas'].argmax())}, top-2 margin {m:.4e}, the "
            f"prompt's noise floor {floor_p:.4e}"
            + ("" if 0 < floor_p < m else " (not decided)"))
    log(f"[lm serve] first token = prefill's argmax on {agreed} of "
        f"{decided} one-request waves whose margin exceeds the floor")
    return paths


def _rung_kernels(device, policy, requests, errs):
    """Kernels 1-4 and 7 at each rung of the scheduler's ladder, on the
    wave that rung's own requests make (at most one wave of them), against
    their plain versions: the fused layer (layer 1, 62 -> 64, and a
    64 -> 64 layer on masked random features), the stacked ELL, COO and CSR
    SpMMs (the three batched entries twice for identical bits), the COO
    kernel's g-SpMM entry at R-GCN's (copy_lhs, mean) aggregation and the
    grouped matmul of R-GCN's relation transform. Updates ``errs``."""
    import torch
    from repro_torch.core.formats import coo_to_csr, coo_to_ell
    from repro_torch.core.gcn import GCNConfig
    from repro_torch.core.graph_conv import flatten_channels, stack_channels
    from repro_torch.kernels import ref
    from repro_torch.kernels.batched_spmm_coo import batched_spmm_coo
    from repro_torch.kernels.batched_spmm_csr import batched_spmm_csr
    from repro_torch.kernels.batched_spmm_ell import batched_spmm_ell
    from repro_torch.kernels.fused_graph_conv import fused_forward, \
        runtime_chunks
    from repro_torch.kernels.grouped_matmul import _gmm, _row_groups
    from repro_torch.serving.engine import GraphServeEngine

    gen = torch.Generator(device="cpu").manual_seed(3)
    cfg = GCNConfig.tox21(impl="fused", bn_mode="sample")
    params = _params(cfg, 0, device)
    conv = params["convs"][0]

    def note(kname, err):
        errs[kname] = max(errs[kname], err)
        return f"{kname} {err:.2e}"

    for tier in policy.tiers:
        mine = [r for r in requests if policy.assign(r) == tier][:tier.batch]
        m = tier.m_pad
        wave = GraphServeEngine(params, cfg, device=device, batch=tier.batch,
                                m_pad=m, nnz_pad=tier.nnz_pad).assemble(mine)
        tag = f"rung {tier.key}"
        out = []
        rid, cid, val, nnz_sc = stack_channels(wave.adj)
        chunks = runtime_chunks(nnz_sc)
        x2 = torch.relu(torch.randn((tier.batch, m, 64), generator=gen)).to(
            device) * (torch.arange(m, device=device)[None, :, None]
                       < wave.n_nodes[:, None, None])
        w2 = (torch.randn((4, 64, 64), generator=gen) / 8).to(device)
        for x, w, bias, layer in ((wave.x, conv["w"], conv["b"], 1),
                                  (x2, w2, conv["b"], 2)):
            out.append(note("fused_forward", max_err(
                fused_forward(rid, cid, val, chunks, x, w, bias),
                ref.fused_graph_conv_plain(rid, cid, val, chunks, x, w, bias),
                f"{tag} fused_forward layer {layer}")))
        a = flatten_channels(wave.adj)
        u = (torch.einsum("bmn,cnf->cbmf", wave.x, conv["w"])
             + conv["b"][:, None, None, :]).reshape(-1, m, 64).contiguous()
        ell = coo_to_ell(a, m, cfg.k_pad)
        csr = coo_to_csr(a, m)
        h = torch.randn((a.batch, m, 64), generator=gen).to(device)
        cases = (
            ("batched_spmm_ell",
             lambda: batched_spmm_ell(ell.col_ids, ell.values, u),
             lambda: ref.batched_spmm_ell_plain(ell.col_ids, ell.values, u)),
            ("batched_spmm_coo",
             lambda: batched_spmm_coo(a.row_ids, a.col_ids, a.values, u),
             lambda: ref.batched_spmm_coo_plain(a.row_ids, a.col_ids,
                                                a.values, u)),
            ("batched_spmm_csr",
             lambda: batched_spmm_csr(csr.rpt, csr.col_ids, csr.values, u),
             lambda: ref.batched_spmm_csr_plain(csr.rpt, csr.col_ids,
                                                csr.values, u)),
            ("batched_spmm_coo",
             lambda: batched_spmm_coo(a.row_ids, a.col_ids, a.values, h,
                                      nnz=a.nnz, op="copy_lhs",
                                      reduce="mean"),
             lambda: ref.batched_gspmm_coo_plain(
                 a.row_ids, a.col_ids, a.values, a.nnz, h, op="copy_lhs",
                 reduce="mean")))
        for kname, kern, plain in cases:
            got = kern()
            out.append(note(kname, max_err(got, plain(), f"{tag} {kname}")))
            check(torch.equal(got, kern()), f"{tag} {kname}: two calls differ")
        e = cfg.channels
        xt = wave.x.reshape(1, -1, wave.x.shape[-1]).expand(e, -1, -1) \
            .reshape(-1, wave.x.shape[-1]).contiguous()
        rg = _row_groups(torch.full((e,), xt.shape[0] // e, dtype=torch.int32,
                                    device=device), xt.shape[0], e)
        w_rel = (torch.randn((e, wave.x.shape[-1], 64), generator=gen)
                 / 8).to(device)
        got = _gmm(xt, w_rel, rg)
        out.append(note("grouped_matmul", max_err(
            got, ref.grouped_matmul_ref(xt, rg, w_rel),
            f"{tag} grouped_matmul")))
        check(torch.equal(got, _gmm(xt, w_rel, rg)),
              f"{tag} grouped_matmul: two calls differ")
        log(f"[sched rung] {tier.key} ({len(mine)} requests, {a.batch} "
            f"stacked matrices, {int(a.nnz.sum())} real nnz, M {xt.shape[0]} "
            f"for the grouped matmul): max abs err vs plain: "
            + ", ".join(out) + "; ELL, COO (SpMM, g-SpMM), CSR and the "
            "grouped matmul identical bits twice")


def _time_waves(sched):
    """Wrap each warmed tier engine's ``run_wave`` so that every wave's
    host assembly and device forward are timed apart (a sync at each of
    the engine's ``on_phase`` marks). Returns the sink: ms are appended to
    its ``"host"`` and ``"dev"`` lists, which the caller may swap."""
    import torch

    sink = {"host": [], "dev": []}
    for tier in sched.programs.tiers():
        eng = sched.programs.get(tier).engine

        def run_wave(wave, inner=eng.run_wave):
            marks = []

            def mark(_phase):
                torch.cuda.synchronize()
                marks.append(time.perf_counter())

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            report = inner(wave, on_phase=mark)
            sink["host"].append((marks[0] - t0) * 1e3)
            sink["dev"].append((marks[1] - marks[0]) * 1e3)
            return report

        eng.run_wave = run_wave
    return sink


def _sched_line(tag, m, host, dev, card):
    s = m.summary()
    log(f"[sched] {tag}: {s['served']} served, {s['rejected']} rejected in "
        f"{s['waves']} waves over tiers "
        f"{sorted({w.tier_key for w in m.waves})}; throughput "
        f"{s['throughput_rps']:.1f} requests/s, latency p50 "
        f"{s['latency_p50_s'] * 1e3:.3f} ms, p99 "
        f"{s['latency_p99_s'] * 1e3:.3f} ms, mean wait "
        f"{s['mean_wait_s'] * 1e3:.3f} ms, {s['deadline_misses']} deadline "
        f"misses; padding waste nodes {s['padding_waste_nodes']:.4f}, nnz "
        f"{s['padding_waste_nnz']:.4f}; fill rate {s['fill_rate']:.4f}; "
        f"median ms per wave: host assembly {statistics.median(host):.3f}, "
        f"device forward {statistics.median(dev):.3f} ({card})")


def _ratio(entries, key, impl):
    """Geometric mean of measured / predicted over the regret auditor's
    ``entries`` of ``impl`` at workload ``key``, and their count."""
    import math

    logs = [math.log(m / e.predicted[impl]) for e in entries
            if e.key == key and e.chosen == impl
            for i, m in e.measured.items()
            if i == impl and e.predicted.get(impl)]
    return (math.exp(sum(logs) / len(logs)) if logs else None), len(logs)


def _idle_share(sched, requests):
    """One traced drain: ``sched.serve(requests)`` under ``torch.profiler``
    (CPU and CUDA). Returns (wall ms, kernel ms, kernels, idle share of the
    wall with no kernel running, idle share with no kernel or copy, the
    three longest gaps as (ms, enclosing span))."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("drain"):
            sched.serve(requests)
            torch.cuda.synchronize()
    evs = prof.events()
    drain = next(e for e in evs if e.name == "drain"
                 and e.device_type == DeviceType.CPU)
    t0, t1 = drain.time_range.start, drain.time_range.end
    # device activity: kernels and copies; a record_function range also
    # shows on the device track (a user annotation from its first kernel
    # to its last), which is not work
    dev = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in evs if e.device_type == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)
                 and e.name not in ("drain", "sched/wave", "serve/wave"))
    check(bool(dev), "idle share: the trace holds no device activity")
    spans = [e for e in evs if e.device_type == DeviceType.CPU
             and e.name in ("sched/wave", "serve/wave")]

    def busy(intervals):
        tot, end = 0.0, t0
        gaps = []
        for a, b in sorted(intervals):
            a, b = max(a, t0), min(b, t1)
            if b <= end:
                continue
            if a > end:
                gaps.append((end, a))
            tot += b - max(a, end)
            end = b
        gaps.append((end, t1))
        return tot, gaps

    kern = [(a, b) for a, b, name in dev
            if "memcpy" not in name.lower() and "memset" not in name.lower()]
    k_busy, gaps = busy(kern)
    d_busy, _ = busy([(a, b) for a, b, _ in dev])
    wall = t1 - t0

    def enclosing(a, b):
        mid = (a + b) / 2
        inside = [e for e in spans
                  if e.time_range.start <= mid <= e.time_range.end]
        return (min(inside, key=lambda e: e.time_range.elapsed_us()).name
                if inside else "scheduler loop, outside any wave span")

    top = sorted(gaps, key=lambda g: g[0] - g[1])[:3]
    return (wall / 1e3, k_busy / 1e3, len(kern), 1 - k_busy / wall,
            1 - d_busy / wall,
            [((b - a) / 1e3, enclosing(a, b)) for a, b in top])


def phase_scheduler(device, card, errs):
    """Continuous-batching serving through ``repro_torch.scheduler`` at
    ``GCNConfig.tox21()`` width on skewed Tox21-like traffic (SCHED): the
    ladder's kernels at each rung against their plain versions; then per
    impl (SCHED_IMPLS) a warmed ``Scheduler`` on the default device drains
    every request on the wall clock and again on a VirtualClock (Poisson
    arrivals at half the wall run's throughput, each tier's median wave
    time as the service model): every request done, its logits within
    F32_TOL of ``ref`` at the tier it rode, one program per tier used,
    exact launches per wave, no kernel library built or loaded while
    draining; a telemetry drain (pallas_coo) whose Chrome export nests
    sched/wave > serve/wave > spmm/* and whose regret report is not empty;
    the device idle share of one traced ``auto`` drain; and 10 Tox21 steps
    with the trainer's telemetry. Returns launches per kernel of each
    path."""
    import json as json_mod
    import tempfile

    import numpy as np
    import torch
    from repro_torch import observability as obs
    from repro_torch.core.gcn import GCNConfig, resolve_conv_impls
    from repro_torch.data.graphs import GraphDatasetSpec, generate
    from repro_torch.kernels import _build
    from repro_torch.scheduler import RealClock, Scheduler, \
        SchedulerConfig, TierPolicy, VirtualClock
    from repro_torch.serving.engine import GraphServeEngine
    from repro_torch.training.trainer import GCNTrainer, TrainerConfig

    t_phase = time.perf_counter()
    spec = GraphDatasetSpec.tox21_like(SCHED["n_requests"],
                                       size_dist="skewed", seed=0)
    data = generate(spec)
    policy = TierPolicy.from_requests(
        [(s.n_nodes, max(len(r) for r in s.rows)) for s in data],
        levels=SCHED["levels"], batch=SCHED["batch"])
    config = SchedulerConfig(flush_after=SCHED["flush_after"],
                             default_slo=SCHED["default_slo"])
    log(f"[sched] traffic: {len(data)} skewed Tox21-like requests, ladder "
        f"{[t.key for t in policy.tiers]}; {config}")
    _rung_kernels(device, policy, _requests(spec), errs)

    rgcn_per_impl = {"ref": {"grouped_matmul": 2}}
    rgcn_per_impl.update({i: {"grouped_matmul": 2, k: 2} for i, k in (
        ("pallas_coo", "batched_spmm_coo"), ("pallas_csr", "batched_spmm_csr"),
        ("pallas_ell", "batched_spmm_ell"))})
    ref_logits = {}     # (layer, tier key) -> {request index: logits}

    def ref_of(layer, cfg_fn, params, tier, idx):
        """``ref``'s logits of the requests ``idx`` at ``tier``'s geometry
        (cached): by bn_mode="sample" a request's logits do not depend on
        its wave, so they are scored in ref waves of the tier; the first of
        each batch is also scored alone and held to them."""
        got = ref_logits.setdefault((layer, tier.key), {})
        todo = [i for i in idx if i not in got]
        if todo:
            eng = GraphServeEngine(
                params, cfg_fn(impl="ref", bn_mode="sample"), device=device,
                batch=tier.batch, m_pad=tier.m_pad, nnz_pad=tier.nnz_pad)
            reqs = _requests(spec)
            for k in range(0, len(todo), tier.batch):
                part = [reqs[i] for i in todo[k:k + tier.batch]]
                eng.run_wave(part)
                for i, r in zip(todo[k:k + tier.batch], part):
                    check(r.done, f"ref at {tier.key}: request {i} failed")
                    got[i] = r.logits
            alone = _requests(spec)[todo[0]]
            eng.run_wave([alone])
            max_err(torch.from_numpy(alone.logits),
                    torch.from_numpy(got[todo[0]]),
                    f"ref at {tier.key}: request {todo[0]} alone vs in a "
                    "wave")
        return np.stack([got[i] for i in idx])

    paths = {}
    runs = [("gcn", i, GCNConfig.tox21) for i in SCHED_IMPLS] + [
        ("rgcn", "auto", lambda **kw: GCNConfig.tox21(layer="rgcn", **kw))]
    for layer, impl, cfg_fn in runs:
        tag = f"tox21 {layer} {impl}"
        params = _params(cfg_fn(impl="ref"), 0, device)
        cfg = cfg_fn(impl=impl)
        sched = Scheduler(params, cfg, tiers=policy, config=config)
        check(isinstance(sched.clock, RealClock)
              and sched.device.type == torch.device(DEVICE).type,
              f"{tag}: the scheduler's default clock and device")
        reqs = _requests(spec)
        n_prog = sched.warmup(reqs)
        aud = obs.default_auditor()
        n_aud = len(aud.entries)
        sink = _time_waves(sched)
        libs = dict(_build._libs)
        wrappers = _reset_counters()
        sched.serve(reqs)
        m = sched.metrics
        used = {w.tier_key for w in m.waves}
        _sched_line(f"impl={impl} {layer}, wall clock", m, sink["host"],
                    sink["dev"], card)
        med = {}
        for w in m.waves:
            med.setdefault(w.tier_key, []).append(w.service_time)
        med = {k: statistics.median(v) for k, v in med.items()}
        rps = 0.5 * m.throughput
        arrivals = list(np.cumsum(np.random.default_rng(0).exponential(
            1.0 / rps, len(reqs))))
        vsched = Scheduler(
            params, cfg, tiers=policy, config=config, clock=VirtualClock(),
            service_model=lambda tier, n: med.get(tier.key, max(med.values())),
            engine_factory=lambda tier: sched.programs.get(tier).engine)
        vreqs = _requests(spec)
        sink["host"], sink["dev"] = [], []      # the engines are shared
        vsched.serve(vreqs, arrivals=arrivals)
        counts = {k: fn.launches for k, fn in wrappers.items()}
        check(dict(_build._libs) == libs,
              f"{tag}: a kernel library was built or loaded while draining")
        _sched_line(f"impl={impl} {layer}, VirtualClock (Poisson "
                    f"{rps:.1f} requests/s, seed 0; service model: the wall "
                    f"run's median wave s per tier "
                    f"{ {k: round(v, 6) for k, v in med.items()} })",
                    vsched.metrics, sink["host"], sink["dev"], card)
        per_impl = SERVE_TOX21_LAUNCHES if layer == "gcn" else rgcn_per_impl
        want = {k: 0 for k in counts}
        for w in m.waves + vsched.metrics.waves:
            tier = next(t for t in policy.tiers if t.key == w.tier_key)
            for k, n in _auto_expect(resolve_conv_impls(
                    cfg, tier.batch, tier.m_pad, tier.nnz_pad,
                    device=device), per_impl).items():
                want[k] += n
        check(counts == want, f"{tag}: launches {counts}, expected {want} "
                              f"({len(m.waves) + len(vsched.metrics.waves)} "
                              "waves)")
        paths[f"serve {tag} scheduler"] = counts
        for s, rs in ((sched, reqs), (vsched, vreqs)):
            check(all(r.done and not r.failed for r in rs),
                  f"{tag}: {sum(not r.done for r in rs)} requests not done")
            # one program per tier that served a wave or was warmed
            tiers_used = {w.tier_key for w in s.metrics.waves} | {
                t.key for t in s.programs.tiers() if s.programs.get(t).warmed}
            check(s.metrics.compile_count == len(tiers_used)
                  and s.programs.jit_cache_sizes() == {},
                  f"{tag}: compile count {s.metrics.compile_count} for "
                  f"tiers {tiers_used}")
            by_tier = {}
            for p in s.completed:
                by_tier.setdefault(p.served_tier, []).append(p)
            err = 0.0
            for tier, ps in by_tier.items():
                want_l = ref_of(layer, cfg_fn, params, tier,
                                [p.seq for p in ps])
                err = max(err, max_err(
                    torch.from_numpy(np.stack([p.request.logits
                                               for p in ps])),
                    torch.from_numpy(want_l),
                    f"{tag}: logits vs per-request ref at {tier.key}"))
            log(f"[sched] impl={impl} {layer}: "
                f"{'wall' if s is sched else 'virtual'} run's logits within"
                f" {F32_TOL} of per-request ref at the tier each rode, max "
                f"abs err {err:.3e}")
        dec = []
        for key, d in sched.programs.decisions().items():
            r, n = _ratio(aud.entries[n_aud:], d.workload.key(), d.impl)
            dec.append(f"{key}: {d.impl} ({d.source}, workload "
                       f"{d.workload.key()}), measured/predicted "
                       + (f"{r:.2f} over {n} waves" if r is not None else
                          "no prediction (pinned)" if d.source == "forced"
                          else "none recorded (a tier's first wave is "
                          "skipped)"))
        log(f"[sched] impl={impl} {layer}: {n_prog} programs warmed; "
            f"decisions: " + "; ".join(dec))

    # telemetry: pallas_coo's stacked SpMM dispatches through batched_spmm
    cfg = GCNConfig.tox21(impl="pallas_coo")
    params = _params(cfg, 0, device)
    sched = Scheduler(params, cfg, tiers=policy, config=config)
    reqs = _requests(spec)
    sched.warmup(reqs)
    obs.TRACER.clear()
    aud = obs.default_auditor()
    n0 = len(aud.entries)
    wrappers = _reset_counters()
    with obs.telemetry():
        sched.serve(reqs)
    counts = {k: fn.launches for k, fn in wrappers.items()}
    want = {k: SERVE_TOX21_LAUNCHES["pallas_coo"].get(k, 0)
            * len(sched.metrics.waves) for k in counts}
    check(counts == want, f"telemetry drain: launches {counts}, expected "
                          f"{want}")
    paths["serve tox21 scheduler telemetry"] = counts
    with tempfile.TemporaryDirectory() as tmp:
        path = obs.export_chrome_trace(Path(tmp) / "sched_trace.json")
        text = path.read_text()

    def strict(tok):
        raise SmokeFailure(f"trace export holds the non-strict {tok}")

    doc = json_mod.loads(text, parse_constant=strict)
    evs = obs.TRACER.events()
    sw = [e for e in evs if e.name == "sched/wave"]
    vw = [e for e in evs if e.name == "serve/wave"]
    kw = [e for e in evs if e.name.startswith("spmm/")]

    def inside(o, i):
        return o.ts <= i.ts and i.ts + i.dur <= o.ts + o.dur

    check(len(sw) == len(vw) == len(sched.metrics.waves) and kw,
          f"telemetry: {len(sw)} sched/wave, {len(vw)} serve/wave, "
          f"{len(kw)} kernel spans for {len(sched.metrics.waves)} waves")
    check(all(any(inside(s, w) for s in sw) for w in vw),
          "telemetry: a serve/wave outside every sched/wave")
    check(all(any(inside(w, k) for w in vw) for k in kw),
          "telemetry: a kernel span outside every serve/wave")
    rep = aud.report()
    check(len(aud.entries) > n0 and bool(rep["per_impl"]),
          "telemetry: the regret report is empty")
    spmm_ms = statistics.median([k.dur for k in kw]) / 1e3
    log(f"[sched] telemetry drain (pallas_coo): {len(doc['traceEvents'])} "
        f"events exported as strict JSON ({len(text)} bytes), "
        f"{len(sw)} sched/wave > {len(vw)} serve/wave > {len(kw)} "
        f"spmm/* spans nested; median spmm span {spmm_ms:.3f} ms (two "
        f"syncs); regret per impl "
        + json_mod.dumps(obs.sanitize_json(rep["per_impl"]))
        + f" ({card})")
    obs.TRACER.clear()

    # the device idle share of one auto drain (telemetry off)
    cfg = GCNConfig.tox21()
    sched = Scheduler(_params(cfg, 0, device), cfg, tiers=policy,
                      config=config)
    reqs = _requests(spec)
    sched.warmup(reqs)
    wall, kern, n_kern, idle, idle_dev, gaps = _idle_share(sched, reqs)
    check(all(r.done for r in reqs), "idle-share drain: requests not done")
    log(f"[sched] idle share, auto drain of {len(reqs)} requests in "
        f"{len(sched.metrics.waves)} waves (torch.profiler): wall "
        f"{wall:.3f} ms, {n_kern} kernels busy {kern:.3f} ms; no kernel "
        f"running "
        f"{idle:.4f} of the wall, no kernel or copy {idle_dev:.4f}; longest "
        f"gaps: " + "; ".join(f"{g:.3f} ms in {name}" for g, name in gaps)
        + f" ({card})")

    # a few Tox21 training steps with the trainer's telemetry
    tdata = _train_batches(GraphDatasetSpec.tox21_like(
        TRAIN_TOX21["n_samples"], seed=0), TRAIN_TOX21["batch"])
    tdata = tdata[:SCHED_TRAIN["steps"]]
    reg = obs.MetricsRegistry()
    obs.TRACER.clear()
    wrappers = _reset_counters()
    with tempfile.TemporaryDirectory() as tmp:
        tr = GCNTrainer(GCNConfig.tox21(impl="fused"),
                        tcfg=TrainerConfig(tmp, checkpoint_every=1000,
                                           log_every=SCHED_TRAIN["log_every"]),
                        registry=reg)
        _, _, last = tr.fit(tdata, epochs=1)
    counts = {k: fn.launches for k, fn in wrappers.items()}
    want = {k: TRAIN_TOX21_LAUNCHES["fused"].get(k, 0) * len(tdata)
            for k in counts}
    check(counts == want, f"train telemetry: launches {counts}, expected "
                          f"{want}")
    paths["train tox21 telemetry"] = counts
    labels = {"layer": "gcn", "impl": "fused"}
    steps = [e for e in obs.TRACER.events() if e.name == "train/step"]
    loss = reg.get("train_loss").value(**labels)
    check(reg.get("train_steps_total").value(**labels) == len(tdata)
          == SCHED_TRAIN["steps"] and len(steps) == len(tdata)
          and np.isfinite(loss) and loss == last["loss"],
          f"train telemetry: {reg.get('train_steps_total').value(**labels)}"
          f" steps counted, {len(steps)} train/step spans, loss gauge {loss}")
    log(f"[sched] train telemetry: {len(tdata)} fused Tox21 steps of "
        f"{TRAIN_TOX21['batch']}, train_steps_total "
        f"{reg.get('train_steps_total').value(**labels):.0f}, "
        f"{len(steps)} train/step spans, loss gauge {loss:.5f}, grad norm "
        f"{reg.get('train_grad_norm').value(**labels):.4f}, mean step "
        f"{reg.get('train_step_seconds').sum(**labels) / len(tdata) * 1e3:.3f}"
        f" ms (host-paced: no sync per step), graphs/s "
        f"{reg.get('train_graphs_per_s').value(**labels):.1f} ({card})")
    obs.TRACER.clear()
    log(f"[sched] phase done in {time.perf_counter() - t_phase:.1f} s")
    return paths


def main() -> int:
    t_start = time.perf_counter()
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found next to this script; "
              "run it from the root of a checkout", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.core.gcn import GCNConfig
    from repro_torch.data.graphs import GraphDatasetSpec

    name, card = phase_device()
    device = torch.device(DEVICE)
    phase_build()
    rows, errs = phase_kernels(device)
    phase_gnn_kernels(device, rows, errs)
    phase_flash_kernels(device, rows, errs)
    phase_precision_kernels(device, rows, errs)
    phase_large_kernels(device, rows, errs)
    phase_fused_large(device, rows, errs)
    large_path = phase_large_path(device)
    lm_paths = phase_lm(device)
    p_launches = phase_powerlaw(device)

    tox_launches = phase_serve(
        "tox21", GCNConfig.tox21, GraphDatasetSpec.tox21_like(N_REQUESTS,
                                                              seed=0),
        ("ref", "fused", "pallas_ell", "pallas_coo", "pallas_hybrid",
         "fused_hybrid", "pallas_gemm"), SERVE_TOX21_LAUNCHES, device,
        F32_TOL)
    r_launches = phase_serve(
        "reaction100", GCNConfig.reaction100,
        GraphDatasetSpec.reaction100_like(N_REQUESTS, seed=0),
        ("ref", "fused", "fused_hybrid", "pallas_hybrid"),
        {"fused": {"fused_forward": 3},
         "fused_hybrid": {"fused_hybrid_forward": 3},
         "pallas_hybrid": {"batched_spmm_hybrid": 3}}, device, F32_TOL)
    t_launches = phase_train(
        "tox21", GCNConfig.tox21,
        GraphDatasetSpec.tox21_like(TRAIN_TOX21["n_samples"], seed=0),
        TRAIN_TOX21, ("ref", "fused", "pallas_coo", "pallas_ell",
                      "pallas_csr", "pallas_hybrid", "fused_hybrid",
                      "pallas_gemm"), TRAIN_TOX21_LAUNCHES, device,
        resume_impl="pallas_csr")
    tr_launches = phase_train(
        "reaction100", GCNConfig.reaction100,
        GraphDatasetSpec.reaction100_like(
            TRAIN_R100["batch"] * TRAIN_R100["steps"], seed=0),
        TRAIN_R100, ("ref", "fused", "fused_hybrid", "pallas_hybrid"),
        {"fused": {"fused_forward": 3, "batched_spmm_coo": 3},
         "fused_hybrid": {"fused_hybrid_forward": 3, "batched_spmm_coo": 3},
         "pallas_hybrid": {"batched_spmm_hybrid": 3, "batched_spmm_csr": 3}},
        device)

    paths = {"powerlaw model": p_launches, "serve tox21": tox_launches,
             "serve reaction100": r_launches, "train tox21": t_launches,
             "train reaction100": tr_launches}
    paths.update(phase_gnn_paths(device))
    paths.update(phase_precision_paths(device))
    paths.update(phase_autotune(device))
    paths.update(phase_scheduler(device, card, errs))
    paths.update(lm_paths)
    paths.update(large_path)
    kernels = []
    for kname, key in ENTRY_ROW.items():
        per_path = {p: c.get(kname, 0) for p, c in paths.items()}
        launches = sum(per_path.values())
        check(launches > 0, f"{kname} was never launched on the main paths")
        log(f"[launches] {kname}: {launches} on the main paths {per_path}")
        r = rows[key]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/csrc/{SOURCE[kname]}.cu",
            "replaces": TPU_SITE[kname], "launches": launches,
            "max_abs_err": errs[kname], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
