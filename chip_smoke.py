#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Runs from the root of a checkout, needs one CUDA device and ``nvcc``, and
imports nothing of JAX or of the JAX package. Phases, each fatal on failure:

1. device: the card's name and power limit; TF32 off for matmul and cuDNN;
2. build: the CUDA kernels from ``src/repro_torch/csrc`` (``build/kernels``);
3. kernels: each kernel against its plain PyTorch version, at the main
   path's shapes (taken from a real Tox21 / Reaction100 wave) and on the
   uniform / skewed / zero-nnz regimes, with kernel, plain, library-call
   and bound times;
4. serve Tox21 (62 -> 64 -> 64, 12 tasks): 512 requests through
   ``GraphServeEngine(batch=128, m_pad=56, nnz_pad=256)`` with
   ``impl`` = fused, pallas_ell, pallas_coo and ref; launch counts, logits
   against ``ref``, wave-composition invariance, host/device wave times;
5. serve Reaction100 (62 -> 512 x 3, 100 classes) with ``impl="fused"``
   against ``ref``.

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
TOX21 = dict(batch=128, m_pad=56, nnz_pad=256)
N_REQUESTS = 512
TPU_SITE = {
    "batched_spmm_ell": "src/repro/kernels/batched_spmm_ell.py:142",
    "batched_spmm_coo": "src/repro/kernels/batched_spmm_coo.py:168",
    "fused_forward": "src/repro/kernels/fused_graph_conv.py:197",
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events over ``iters``
    back-to-back calls (inputs stay L2-warm, as on the serving path)."""
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


def phase_kernels(device):
    """Each kernel against its plain version; times at the main-path shapes."""
    import torch
    from repro_torch.core.formats import coo_to_dense, coo_to_ell, \
        max_row_degree
    from repro_torch.core.gcn import GCNConfig
    from repro_torch.core.graph_conv import flatten_channels, stack_channels
    from repro_torch.data.graphs import GraphDatasetSpec
    from repro_torch.kernels import ref
    from repro_torch.kernels.batched_spmm_coo import batched_spmm_coo
    from repro_torch.kernels.batched_spmm_ell import batched_spmm_ell
    from repro_torch.kernels.fused_graph_conv import fused_forward, \
        runtime_chunks
    from repro_torch.serving.engine import GraphServeEngine

    rows = {}
    gen = torch.Generator(device="cpu").manual_seed(1)

    # -- the Tox21 main path: the first wave of the serving phase ----------
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
    spmm = {
        "batched_spmm_ell": (
            lambda: batched_spmm_ell(ell.col_ids, ell.values, u),
            lambda: ref.batched_spmm_ell_plain(ell.col_ids, ell.values, u),
            bound(io + nnz * 8, flops)),
        "batched_spmm_coo": (
            lambda: batched_spmm_coo(a_flat.row_ids, a_flat.col_ids,
                                     a_flat.values, u),
            lambda: ref.batched_spmm_coo_plain(a_flat.row_ids, a_flat.col_ids,
                                               a_flat.values, u),
            bound(io + nnz * 12, flops)),
    }
    for name, (kern, plain, (b_ms, b_by)) in spmm.items():
        err = max_err(kern(), plain(), f"{name} main path")
        max_err(torch.bmm(a_dense, u), plain(), f"{name} library call")
        rows[name] = dict(
            name=name, max_abs_err=err, ms=cuda_ms(kern),
            plain_ms=cuda_ms(plain), bound_ms=b_ms, bound_by=b_by,
            library_ms=cuda_ms(lambda: torch.bmm(a_dense, u)),
            shape=f"{u.shape[0]} matrices x {m_pad} rows, k_pad "
                  f"{cfg.k_pad}, nnz_pad {a_flat.nnz_pad}, n_b 64, "
                  f"{nnz} real nnz")

    # fused layers: Tox21 layer 1 and Reaction100 layer 2 (n_in 512)
    def fused_case(tag, adj, x, w, bias, n_nodes):
        rid, cid, val, nnz_sc = stack_channels(adj)
        chunks = runtime_chunks(nnz_sc)
        live = int((chunks > 0).sum().item())
        # the transform this data needs: real rows of each live channel
        live_rows = int(((chunks > 0) * n_nodes[:, None]).sum().item())
        real = int(nnz_sc.sum().item())
        n_in, n_out = x.shape[-1], w.shape[-1]
        ch = w.shape[0]
        dense = torch.stack([coo_to_dense(a, m_pad) for a in adj])  # ch,b,m,m

        def kern():
            return fused_forward(rid, cid, val, chunks, x, w, bias)

        def plain():
            return ref.fused_graph_conv_plain(rid, cid, val, chunks, x, w,
                                              bias)

        def library():
            uu = torch.einsum("bmn,cnf->cbmf", x, w) + bias[:, None, None, :]
            return torch.matmul(dense, uu).sum(dim=0)

        err = max_err(kern(), plain(), f"fused_forward {tag}")
        max_err(library(), plain(), f"fused library call {tag}")
        nbytes = (real * 12 + chunks.numel() * 4 + x.numel() * 4
                  + w.numel() * 4 + bias.numel() * 4 + x.shape[0] * m_pad
                  * n_out * 4)
        b_ms, b_by = bound(nbytes, 2 * real * n_out
                           + 2 * live_rows * n_in * n_out)
        rows[f"fused_forward[{tag}]"] = dict(
            name=f"fused_forward[{tag}]", max_abs_err=err, ms=cuda_ms(kern),
            plain_ms=cuda_ms(plain), bound_ms=b_ms, bound_by=b_by,
            library_ms=cuda_ms(library),
            shape=f"{x.shape[0]} samples x {ch} channels, m_pad {m_pad}, "
                  f"n_in {n_in} -> n_out {n_out}, {real} real nnz, "
                  f"{live} live (sample, channel) pairs")

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

    # -- the three regimes, small sizes -----------------------------------
    for rname, coo, mp in _regimes(device):
        k_pad = max(1, int(max_row_degree(coo, mp).max().item()))
        b = torch.randn((coo.batch, mp, 48), generator=gen).to(device)
        e = coo_to_ell(coo, mp, k_pad)
        for kname, got, want in (
                ("batched_spmm_ell", batched_spmm_ell(e.col_ids, e.values, b),
                 ref.batched_spmm_ell_plain(e.col_ids, e.values, b)),
                ("batched_spmm_coo",
                 batched_spmm_coo(coo.row_ids, coo.col_ids, coo.values, b),
                 ref.batched_spmm_coo_plain(coo.row_ids, coo.col_ids,
                                            coo.values, b))):
            err = max_err(got, want, f"{kname} {rname}")
            rows[kname]["max_abs_err"] = max(rows[kname]["max_abs_err"], err)
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
            err = max_err(got, want, f"fused_forward {rname} {epi}")
            rows["fused_forward[tox21]"]["max_abs_err"] = max(
                rows["fused_forward[tox21]"]["max_abs_err"], err)
        log(f"[kernels] regime {rname}: ELL, COO and fused (none, relu + "
            f"residual) match their plain versions")
    for r in rows.values():
        log(f"[kernels] {r['name']}: {r['shape']}: kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms,"
            f" bound {r['bound_ms']:.4f} ms ({r['bound_by']}), max abs err "
            f"{r['max_abs_err']:.3e}")
    return rows


def _reset_counters():
    from repro_torch.kernels.batched_spmm_coo import batched_spmm_coo
    from repro_torch.kernels.batched_spmm_ell import batched_spmm_ell
    from repro_torch.kernels.fused_graph_conv import fused_forward

    wrappers = {"batched_spmm_ell": batched_spmm_ell,
                "batched_spmm_coo": batched_spmm_coo,
                "fused_forward": fused_forward}
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
    rows = phase_kernels(device)

    tox_launches = phase_serve(
        "tox21", GCNConfig.tox21, GraphDatasetSpec.tox21_like(N_REQUESTS,
                                                              seed=0),
        ("ref", "fused", "pallas_ell", "pallas_coo"),
        {"fused": {"fused_forward": 2},
         "pallas_ell": {"batched_spmm_ell": 2},
         "pallas_coo": {"batched_spmm_coo": 2}}, device, F32_TOL)
    r_launches = phase_serve(
        "reaction100", GCNConfig.reaction100,
        GraphDatasetSpec.reaction100_like(N_REQUESTS, seed=0),
        ("ref", "fused"), {"fused": {"fused_forward": 3}}, device, F32_TOL)

    launches = {"batched_spmm_ell": tox_launches["batched_spmm_ell"],
                "batched_spmm_coo": tox_launches["batched_spmm_coo"],
                "fused_forward[tox21]": tox_launches["fused_forward"],
                "fused_forward[reaction100]": r_launches["fused_forward"]}
    kernels = []
    for key, r in rows.items():
        check(launches[key] > 0, f"{key} was never launched on the path")
        base = key.split("[")[0]
        kernels.append({
            "name": key, "route": "cuda",
            "source": f"src/repro_torch/csrc/"
                      f"{'fused_graph_conv' if base == 'fused_forward' else base}.cu",
            "replaces": TPU_SITE[base], "launches": launches[key],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
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
