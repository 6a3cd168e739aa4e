#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Runs from the root of a checkout, needs one CUDA device and ``nvcc``, and
imports nothing of JAX or of the JAX package. Phases, each fatal on failure:

1. device: the card's name and power limit; TF32 off for matmul and cuDNN;
2. build: the CUDA kernels from ``src/repro_torch/csrc`` (``build/kernels``);
3. kernels: each kernel against its plain PyTorch version, at the main
   paths' shapes (taken from a real Tox21 / Reaction100 wave and training
   batch, and the degree-skewed powerlaw batch) and on the uniform /
   skewed / zero-nnz regimes, with kernel, plain, library-call and bound
   times (device times by CUDA-graph replay; the kernel's back-to-back
   call time beside it, and the PyTorch prep of the hybrid kernels); the
   CSR, hybrid and GEMM kernels also twice for identical bits, the hybrid
   kernel also without a slab, and the COO and CSR kernels in their
   backward roles (dU of the fused layer, dB of ``pallas_csr`` on the
   transposed CSR);
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
   fused_hybrid and pallas_hybrid against ``ref``.

The line before the last is the ``{"kernels": [...]}`` record; the last
line is ``{"ok": true, "device": {...}}``.
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
F32_TOL = (1e-4, 1e-5)         # (atol, rtol): tests/oracle.py TOLS["f32"]
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
TOX21 = dict(batch=128, m_pad=56, nnz_pad=256)
N_REQUESTS = 512
TRAIN_TOX21 = dict(n_samples=1000, batch=50, steps=20, lr=3e-3)
TRAIN_R100 = dict(batch=100, steps=5, lr=3e-3)
# the degree-skewed geometry the reference benchmarks the hybrid split on
# (benchmarks/bench_formats.py "powerlaw"), seed 0
POWERLAW = dict(batch=40, dim=256, avg_deg=8)
CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt"
TPU_SITE = {
    "batched_spmm_ell": "src/repro/kernels/batched_spmm_ell.py:142",
    "batched_spmm_coo": "src/repro/kernels/batched_spmm_coo.py:168",
    "batched_spmm_csr": "src/repro/kernels/batched_spmm_csr.py:163",
    "fused_forward": "src/repro/kernels/fused_graph_conv.py:197",
    "batched_spmm_hybrid": "src/repro/kernels/batched_spmm_hybrid.py:223",
    "batched_gemm": "src/repro/kernels/batched_gemm.py:44",
    "fused_hybrid_forward": "src/repro/kernels/fused_graph_conv.py:197",
}
SOURCE = {"batched_spmm_ell": "batched_spmm_ell",
          "batched_spmm_coo": "batched_spmm_coo",
          "batched_spmm_csr": "batched_spmm_csr",
          "fused_forward": "fused_graph_conv",
          "batched_spmm_hybrid": "batched_spmm_hybrid",
          "batched_gemm": "batched_gemm",
          "fused_hybrid_forward": "fused_graph_conv"}
# the row of each kernel that its {"kernels": ...} entry reports: the shape
# its first main path gives it (serving for ELL, COO, fused, hybrid, GEMM
# and fused hybrid, training for CSR); the other rows are printed as
# [kernels] lines
ENTRY_ROW = {"batched_spmm_ell": "batched_spmm_ell",
             "batched_spmm_coo": "batched_spmm_coo",
             "batched_spmm_csr": "batched_spmm_csr",
             "fused_forward": "fused_forward[tox21]",
             "batched_spmm_hybrid": "batched_spmm_hybrid[tox21]",
             "batched_gemm": "batched_gemm[tox21]",
             "fused_hybrid_forward": "fused_hybrid_forward[tox21]"}


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


def graph_ms(fn, iters: int = 30, replays: int = 5) -> float:
    """Mean device time of ``fn`` in ms: ``iters`` calls captured in one
    CUDA graph and replayed ``replays`` times between CUDA events, so that
    the host's cost of issuing each call drops out (inputs L2-warm)."""
    import torch

    side = torch.cuda.Stream()
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


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of bytes over the
    HBM rate and operations over the f32 peak."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def max_err(got, want, what: str, tol=F32_TOL) -> float:
    import torch

    torch.cuda.synchronize()
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
        regs = [ln.strip() for ln in log_file.read_text().splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"[build] {name}: {' | '.join(regs)}")


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
             library=None, bitwise=False):
    """Hold ``kern()`` against ``plain()`` (and ``library()`` when given,
    and two calls for identical bits when ``bitwise``), then time all
    three by CUDA-graph replay, and the kernel by back-to-back calls too;
    adds the row ``key`` of kernel ``kernel``."""
    import torch

    got = kern()
    err = max_err(got, plain(), key)
    if bitwise:
        check(torch.equal(got, kern()), f"{key}: two calls differ")
    if library is not None:
        max_err(library(), plain(), f"{key} library call")
    b_ms, b_by = bound(nbytes, flops)
    rows[key] = dict(
        name=key, kernel=kernel, max_abs_err=err, ms=graph_ms(kern),
        stream_ms=cuda_ms(kern), plain_ms=graph_ms(plain), bound_ms=b_ms,
        bound_by=b_by,
        library_ms=None if library is None else graph_ms(library),
        shape=shape)


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
             io + nnz * 12, flops, shape, lambda: torch.bmm(a_dense, u))

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
        _measure(rows, f"fused_forward[{tag}]", "fused_forward",
                 lambda: fused_forward(rid, cid, val, chunks, x, w, bias),
                 lambda: ref.fused_graph_conv_plain(rid, cid, val, chunks, x,
                                                    w, bias),
                 nbytes, 2 * real * n_out + 2 * live_rows * n_in * n_out,
                 f"{x.shape[0]} samples x {w.shape[0]} channels, m_pad "
                 f"{m_pad}, n_in {n_in} -> n_out {n_out}, {real} real nnz, "
                 f"{live} live (sample, channel) pairs", library)

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
                 f"{n_b}, {real} real nnz", lambda: torch.bmm(dense, dz))

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
        rank, st, rl, cid, val, slab = hybrid_operands(
            a.row_ids, a.col_ids, a.values, a.nnz, m, hp)
        sparse = int(rl.sum().item())
        real = int(a.nnz.sum().item())
        hubs = int((row_degrees(a, m) >= hp.dmin).sum().item())
        # the slab is read whole; its products count where it holds a value
        slab_n = 0 if slab is None else slab.numel()
        slab_nz = 0 if slab is None else int((slab != 0).sum().item())
        dense = coo_to_dense(a, m)
        key = f"batched_spmm_hybrid[{tag}]"
        _measure(rows, key, "batched_spmm_hybrid",
                 lambda: hybrid_launch(rank, st, rl, cid, val, slab, b,
                                       plan=hp),
                 lambda: ref.batched_spmm_hybrid_plain(rank, st, rl, cid,
                                                       val, slab, b),
                 3 * rank.numel() * 4 + sparse * 8 + slab_n * 4
                 + 2 * b.numel() * 4, 2 * (sparse + slab_nz) * b.shape[-1],
                 f"{a.batch} matrices x {m} rows, nnz_pad {a.nnz_pad}, n_b "
                 f"{b.shape[-1]}, {real} real nnz ({sparse} in the CSR "
                 f"remainder), dmin {hp.dmin}, d_pad {hp.d_pad}, "
                 f"{hubs / a.batch:.3f} hub rows per matrix",
                 lambda: torch.bmm(dense, b), bitwise=True)
        rows[key]["prep_ms"] = cuda_ms(lambda: hybrid_operands(
            a.row_ids, a.col_ids, a.values, a.nnz, m, hp))
        max_err(batched_spmm_hybrid(a.row_ids, a.col_ids, a.values, a.nnz, b,
                                    plan=hp),
                ref.batched_spmm_coo_ref(a, b, m), f"{key} wrapper vs COO")

    pl_adj, pl_m = _powerlaw_channels(device)
    pl_b = torch.randn((POWERLAW["batch"], pl_m, 64), generator=gen).to(
        device)
    hybrid_row("powerlaw", pl_adj[0], pl_b, pl_m)
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
        rid_s, cid_s, val_s, chunks, rank, slab = ops_
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
                                       bias, None, rank, slab),
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
        max_err(fused_hybrid_forward(rid, cid, val, nnz_sc, x, w, bias,
                                     hplan=hp),
                ref.fused_graph_conv_plain(rid, cid, val,
                                           runtime_chunks(nnz_sc), x, w,
                                           bias), f"{key} layer vs fused")

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
            got = fused_forward(*f_ops[:4], x, w, bias, res, *f_ops[4:],
                                epilogue="relu")
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
    check(h_ops[-1] is None, "d_pad 0 built a slab")
    errs["batched_spmm_hybrid"] = max(
        errs["batched_spmm_hybrid"],
        max_err(hybrid_launch(*h_ops, b, plan=hp),
                ref.batched_spmm_hybrid_plain(*h_ops, b),
                "batched_spmm_hybrid d_pad 0"))
    log("[kernels] batched_spmm_hybrid with d_pad 0 (nnz_pad "
        f"{small.nnz_pad} < dmin {hp.dmin}, no slab) matches its plain "
        "version")
    for r in rows.values():
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        prep = ("" if "prep_ms" not in r else
                f", PyTorch prep (back-to-back) {r['prep_ms']:.4f} ms")
        log(f"[kernels] {r['name']}: {r['shape']}: kernel {r['ms']:.4f} ms "
            f"(back-to-back calls {r['stream_ms']:.4f} ms), plain "
            f"{r['plain_ms']:.4f} ms, library {lib}, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}){prep}, max abs err "
            f"{r['max_abs_err']:.3e}")
    return rows, errs


def _reset_counters():
    from repro_torch.kernels.batched_spmm_coo import batched_spmm_coo
    from repro_torch.kernels.batched_spmm_csr import batched_spmm_csr
    from repro_torch.kernels.batched_gemm import batched_gemm
    from repro_torch.kernels.batched_spmm_ell import batched_spmm_ell
    from repro_torch.kernels.batched_spmm_hybrid import batched_spmm_hybrid
    from repro_torch.kernels.fused_graph_conv import fused_forward, \
        fused_hybrid_forward

    wrappers = {"batched_spmm_ell": batched_spmm_ell,
                "batched_spmm_coo": batched_spmm_coo,
                "batched_spmm_csr": batched_spmm_csr,
                "fused_forward": fused_forward,
                "batched_spmm_hybrid": batched_spmm_hybrid,
                "batched_gemm": batched_gemm,
                "fused_hybrid_forward": fused_hybrid_forward}
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


def phase_serve(tag, cfg_fn, spec, impls, expect_per_wave, device, tol):
    """Serve ``spec``'s requests once per impl; returns launches per kernel
    and a summary line per impl."""
    import numpy as np
    from repro_torch.serving.engine import GraphServeEngine

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
        for kname, per_wave in expect_per_wave.get(impl, {}).items():
            check(counts[kname] == per_wave * waves,
                  f"{tag} {impl}: {kname} launched {counts[kname]} times, "
                  f"expected {per_wave} x {waves} waves")
            launches[kname] = launches.get(kname, 0) + counts[kname]
        if impl == "ref":
            check(not any(counts.values()), f"{tag} ref launched {counts}")
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
            check(d <= tol[0], f"{tag} {impl}: request alone vs in a full "
                               f"wave differs by {d:.3e}")
            log(f"[serve {tag}] impl={impl}: alone vs in a full wave: max "
                f"abs diff {d:.3e}")
    want = results["ref"]
    for impl in impls:
        if impl == "ref":
            continue
        err = np.abs(results[impl] - want)
        ok = bool((err <= tol[0] + tol[1] * np.abs(want)).all())
        check(ok, f"{tag} {impl} vs ref: max abs logit error "
                  f"{err.max():.3e} above {tol}")
        log(f"[serve {tag}] impl={impl} vs ref: max abs logit error "
            f"{err.max():.3e} (|logit| max {np.abs(want).max():.3f})")
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
                resume_impl=None):
    """Train ``run["steps"]`` Adam steps per impl from one set of seed-0
    parameters through ``GCNTrainer.fit``; returns launches per kernel."""
    import shutil

    import numpy as np
    import torch
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
        g_err, flips, flip_max, free_err = _grads_vs_ref(
            f"train {tag} {impl} first-step grad", grads[impl],
            cfg_fn(impl="ref"), params0, first)
        gap = float(np.max(np.abs(curves[impl] - curves["ref"])
                           / np.abs(curves["ref"])))
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
    return launches


def main() -> int:
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

    t_start = time.perf_counter()
    name, card = phase_device()
    device = torch.device(DEVICE)
    phase_build()
    rows, errs = phase_kernels(device)
    p_launches = phase_powerlaw(device)

    tox_launches = phase_serve(
        "tox21", GCNConfig.tox21, GraphDatasetSpec.tox21_like(N_REQUESTS,
                                                              seed=0),
        ("ref", "fused", "pallas_ell", "pallas_coo", "pallas_hybrid",
         "fused_hybrid", "pallas_gemm"),
        {"fused": {"fused_forward": 2},
         "pallas_ell": {"batched_spmm_ell": 2},
         "pallas_coo": {"batched_spmm_coo": 2},
         "pallas_hybrid": {"batched_spmm_hybrid": 2},
         "fused_hybrid": {"fused_hybrid_forward": 2},
         "pallas_gemm": {"batched_gemm": 2}}, device, F32_TOL)
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
                      "pallas_gemm"),
        {"fused": {"fused_forward": 2, "batched_spmm_coo": 2},
         "pallas_coo": {"batched_spmm_coo": 4},
         "pallas_ell": {"batched_spmm_ell": 2, "batched_spmm_coo": 2},
         "pallas_csr": {"batched_spmm_csr": 4},
         "pallas_hybrid": {"batched_spmm_hybrid": 2, "batched_spmm_csr": 2},
         "fused_hybrid": {"fused_hybrid_forward": 2, "batched_spmm_coo": 2},
         "pallas_gemm": {"batched_gemm": 2, "batched_spmm_coo": 2}}, device,
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
