#!/usr/bin/env python3
"""The records the autotune's cost model is fitted from, taken on the card.

    python3 scripts/autotune_fit.py [--root DIR] [--iters N] [--out FILE]

Imports ``repro_torch`` and ``chip_smoke.py`` from the checkout at DIR (by
default the one this script lies in). On the card it first times three
host costs back to back: one small eager op (an in-place add on 1,024
floats), one view op, and one device-to-host sync (``.item()`` of a sum,
less the sum). Then, for every conv layer of the Tox21 and Reaction100
serving and training paths (``chip_smoke.py``'s geometries), the Tox21
serving layer under the bf16 policy, the GAT and R-GCN Tox21 serving
g-SpMM workloads and the stacked Tox21 SpMM, and for each candidate the
model ranks there (``rank_layer`` / ``rank`` with ``allow_pallas=True``):

- ``wall``: ``measure_workload``'s median seconds of one call (``--iters``
  calls in rotated blocks of 3 or more, every candidate in every round,
  each call between two ``torch.cuda.synchronize()``);
- ``ops``: the PyTorch ops one call issues (a ``TorchDispatchMode``
  count), ``launches``: the kernel launches (the wrappers' counters),
  ``syncs``: its device-to-host reads (``aten._local_scalar_dense``);
- ``device``: the seconds of device work a call runs (``torch.profiler``'s
  CUDA events over three calls);
- ``model``: the cost model's estimate.

Prints one JSON line per record and writes them all to ``--out``
(``build/autotune_fit.jsonl`` by default), with a first line holding the
card's name and power limit and the three host costs.

    python3 scripts/autotune_fit.py --fit FILE [FILE ...]

reads such records (of one or more runs) on any machine and prints the
least-squares fits of ``OP_OVERHEAD`` and ``LAUNCH_OVERHEAD`` (``wall -
port kernel time ≈ OP · ops + LAUNCH · launches``, each record weighted by
the inverse of its left side, ``loop`` left out) and of the device
constants, over the records that split the device time by kernel owner;
then for each run and workload the cost model's pick (with the constants
in ``cost_model.py``), the measured best and the ratio of their measured
times.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--iters", type=int, default=15)
    ap.add_argument("--out", default="build/autotune_fit.jsonl")
    ap.add_argument("--fit", nargs="+", default=None)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    if args.fit:
        return fit(args.fit)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode

    if not torch.cuda.is_available():
        print("autotune_fit: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.autotune.cache import measure_workload, workload_call
    from repro_torch.autotune.cost_model import (
        Workload,
        estimate,
        estimate_layer,
        precision_of,
        rank,
        rank_layer,
    )
    from repro_torch.data.graphs import GraphDatasetSpec
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    _build.build()

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops, self.syncs = 0, 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops += 1
            if "_local_scalar_dense" in str(func):
                self.syncs += 1
            return func(*args, **(kwargs or {}))

    def per_call(fn, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n

    x = torch.zeros(1024, device=dev)
    for _ in range(2):
        op_s = per_call(lambda: x.add_(1.0), 4000)
        view_s = per_call(lambda: x.view(-1), 4000)
        sum_s = per_call(lambda: x.sum(), 2000)
        sync_s = per_call(lambda: x.sum().item(), 1000) - sum_s
    head = {"card": card, "op_s": op_s, "view_s": view_s, "sync_s": sync_s,
            "torch": torch.__version__}
    print(json.dumps(head), flush=True)
    lines = [head]

    def train_shape(spec, batch):
        b = cs._train_batches(spec, batch)[0]
        return b["x"].shape[0], b["x"].shape[1], b["adj"][0].nnz_pad

    geo = cs.TOX21
    t_b, t_m, t_nnz = train_shape(
        GraphDatasetSpec.tox21_like(cs.TRAIN_TOX21["n_samples"], seed=0),
        cs.TRAIN_TOX21["batch"])
    r_b, r_m, r_nnz = train_shape(
        GraphDatasetSpec.reaction100_like(
            cs.TRAIN_R100["batch"] * cs.TRAIN_R100["steps"], seed=0),
        cs.TRAIN_R100["batch"])

    def layer(batch, m_pad, nnz_pad, n_in, n_b, dtype="f32"):
        return Workload(batch=batch, m_pad=m_pad, nnz_pad=nnz_pad, k_pad=8,
                        n_b=n_b, channels=4, n_in=n_in, dtype=dtype)

    serve = (geo["batch"], geo["m_pad"], geo["nnz_pad"])
    workloads = [
        ("serve tox21 layer 1", layer(*serve, 62, 64)),
        ("serve tox21 layer 2", layer(*serve, 64, 64)),
        ("train tox21 layer 1", layer(t_b, t_m, t_nnz, 62, 64)),
        ("train tox21 layer 2", layer(t_b, t_m, t_nnz, 64, 64)),
        ("serve reaction100 layer 1", layer(*serve, 62, 512)),
        ("serve reaction100 layers 2-3", layer(*serve, 512, 512)),
        ("train reaction100 layer 1", layer(r_b, r_m, r_nnz, 62, 512)),
        ("train reaction100 layers 2-3", layer(r_b, r_m, r_nnz, 512, 512)),
        ("serve tox21 layer 1 bf16", layer(*serve, 62, 64, "bf16")),
        ("serve reaction100 layers 2-3 bf16",
         layer(*serve, 512, 512, "bf16")),
        ("serve gat tox21 layer 1", Workload(
            batch=4 * geo["batch"], m_pad=geo["m_pad"],
            nnz_pad=geo["nnz_pad"], k_pad=8, n_b=16, d_e=16)),
        ("serve rgcn tox21 layer 1", Workload(
            batch=4 * geo["batch"], m_pad=geo["m_pad"],
            nnz_pad=geo["nnz_pad"], k_pad=8, n_b=64, op="copy_lhs",
            reduce="mean")),
        ("stacked tox21 spmm", Workload(
            batch=4 * geo["batch"], m_pad=geo["m_pad"],
            nnz_pad=geo["nnz_pad"], k_pad=8, n_b=64)),
    ]
    for tag, w in workloads:
        is_layer = w.channels is not None
        ranked = (rank_layer if is_layer else rank)(w, allow_pallas=True)
        impls = tuple(i for i, _ in ranked
                      if not (w.nnz_pad > w.m_pad * w.k_pad
                              and precision_of(i)[0] in ("ell",
                                                         "pallas_ell")))
        t0 = time.perf_counter()
        times = measure_workload(w, impls, device=dev, iters=args.iters,
                                 contend=None)
        call = workload_call(w, device=dev)
        for impl in impls:
            wrappers = cs._reset_counters()
            count = Count()
            with torch.inference_mode():
                with count:
                    call(impl)
                torch.cuda.synchronize()
                launches = sum(fn.launches for fn in wrappers.values())
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(3):
                        call(impl)
                    torch.cuda.synchronize()
            split = {"torch": 0.0, "blas": 0.0, "port": 0.0}
            for e in prof.events():
                if e.device_type == DeviceType.CUDA:
                    split[_kernel_owner(e.name)] += \
                        e.time_range.elapsed_us() / 3e6
            model = (estimate_layer if is_layer else estimate)(w, impl)
            rec = {"tag": tag, "key": w.key(), "impl": impl,
                   "wall": times[impl], "ops": count.ops,
                   "launches": launches, "syncs": count.syncs,
                   "device": sum(split.values()),
                   **{f"device_{k}": v for k, v in split.items()},
                   "model": model}
            print(json.dumps(rec), flush=True)
            lines.append(rec)
        print(f"[{tag}] {len(impls)} impls in "
              f"{time.perf_counter() - t0:.1f} s", file=sys.stderr,
              flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("".join(json.dumps(r) + "\n" for r in lines))
    print(card)
    return 0


def _kernel_owner(name: str) -> str:
    """Whose device kernel a profiler event is: PyTorch's own ("torch"),
    cuBLAS's ("blas") or the port's hand-written ones ("port")."""
    if "at::" in name or "native" in name or "Memcpy" in name \
            or "Memset" in name:
        return "torch"
    if any(k in name for k in ("xmma", "cutlass", "sgemm", "gemv", "gemmk",
                               "cublas", "Kernel2")):
        return "blas"
    return "port"


def fit(paths: list[str]) -> int:
    """Fit the constants and score the model's picks (see the module
    docstring) from the records in ``paths``."""
    import numpy as np
    from repro_torch.autotune.cost_model import (
        Workload,
        estimate,
        estimate_layer,
    )

    runs = []
    for path in paths:
        lines = [json.loads(x) for x in Path(path).read_text().splitlines()]
        head, recs = lines[0], lines[1:]
        print(f"{path}: {head['card']}: op {head['op_s'] * 1e6:.2f} us, "
              f"view {head['view_s'] * 1e6:.2f} us, sync "
              f"{head['sync_s'] * 1e6:.2f} us")
        runs.append((path, recs))
    # the host's share: a call's wall time less its kernel's (issued last,
    # nothing hides it), from the runs that split the device time
    rs = [r for _, recs in runs for r in recs
          if r["impl"] != "loop" and "device_port" in r]
    a = np.array([[r["ops"], r["launches"]] for r in rs], dtype=float)
    y = np.array([r["wall"] - r["device_port"] for r in rs])
    (op, launch), *_ = np.linalg.lstsq(a / y[:, None], np.ones_like(y),
                                       rcond=None)
    rel = np.abs(a @ np.array([op, launch]) / y - 1)
    print(f"fit over {len(rs)} records: OP_OVERHEAD {op * 1e6:.2f} us, "
          f"LAUNCH_OVERHEAD {launch * 1e6:.2f} us (relative error median "
          f"{np.median(rel):.3f}, max {rel.max():.3f})")
    _fit_device([r for _, recs in runs for r in recs
                 if "device_port" in r], Workload)
    worst = 1.0
    for path, recs in runs:
        for tag in dict.fromkeys(r["tag"] for r in recs):
            group = {r["impl"]: r for r in recs if r["tag"] == tag}
            w = _workload_of(Workload, group[next(iter(group))]["key"])
            est = estimate_layer if w.channels is not None else estimate
            pick = min(group, key=lambda i: est(w, i))
            best = min(group, key=lambda i: group[i]["wall"])
            ratio = group[pick]["wall"] / group[best]["wall"]
            worst = max(worst, ratio)
            print(f"[{Path(path).name}: {tag}] model {pick} "
                  f"({group[pick]['wall'] * 1e3:.3f} ms, est "
                  f"{est(w, pick) * 1e3:.3f}), best {best} "
                  f"({group[best]['wall'] * 1e3:.3f} ms, est "
                  f"{est(w, best) * 1e3:.3f}), ratio {ratio:.3f}")
    print(f"worst ratio {worst:.3f}")
    return 0


def _fit_device(recs, workload_cls):
    """The device constants: the fused kernels' FMA efficiency and fixed
    time (least squares of their kernel time on their transform's flops),
    the bf16 entry's tensor-core efficiency at its largest shape, cuBLAS's
    FMA efficiency on the stacked layers' einsum, and the SpMM kernels'
    time at the stacked Tox21 SpMM."""
    import numpy as np
    from repro_torch.analysis.roofline import HW
    from repro_torch.autotune.cost_model import _mma_fill
    from repro_torch.core.batching import plan_fused_graph_conv

    hw = HW()

    def flops(w):
        return 2.0 * w.batch * w.channels * w.m_pad * w.n_in * w.n_b

    fused = [(flops(_workload_of(workload_cls, r["key"])), r["device_port"])
             for r in recs if r["impl"] == "fused"]
    a = np.array([[f, 1.0] for f, _ in fused])
    (slope, icpt), *_ = np.linalg.lstsq(
        a, np.array([t for _, t in fused]), rcond=None)
    print(f"fused f32 kernel over {len(fused)} records: KERNEL_FMA_EFF "
          f"{1 / (slope * hw.fma_flops):.3f}, FUSED_LATENCY "
          f"{icpt * 1e6:.1f} us")
    bf16 = [r for r in recs if r["impl"] == "fused_bf16"]
    big = max(bf16, key=lambda r: flops(_workload_of(workload_cls,
                                                     r["key"])))
    w = _workload_of(workload_cls, big["key"])
    plan = plan_fused_graph_conv(batch=w.batch, m_pad=w.m_pad, n_in=w.n_in,
                                 n_out=w.n_b, itemsize=2)
    mma = (flops(w) / (big["device_port"] - icpt) / hw.peak_flops
           / _mma_fill(w.m_pad, plan.n_block))
    print(f"fused bf16 kernel at {big['key']}: "
          f"{big['device_port'] * 1e3:.4f} ms, MMA_EFF {mma:.3f}")
    # the stacked layers' einsum: its cuBLAS time against its flops (the
    # impls whose SpMM runs no cuBLAS kernel of its own)
    plain_spmm = ("ref", "csr", "ell", "pallas_csr", "pallas_ell",
                  "pallas_coo", "pallas_hybrid")
    mm = [(flops(_workload_of(workload_cls, r["key"])), r["device_blas"])
          for r in recs if r["impl"] in plain_spmm and r["device_blas"] > 0
          and _workload_of(workload_cls, r["key"]).channels]
    (slope, b_icpt), *_ = np.linalg.lstsq(
        np.array([[f, 1.0] for f, _ in mm]),
        np.array([t for _, t in mm]), rcond=None)
    print(f"cuBLAS einsum over {len(mm)} records: BLAS_FMA_EFF "
          f"{1 / (slope * hw.fma_flops):.3f}, fixed {b_icpt * 1e6:.1f} us")
    spmm = {r["impl"]: r["device_port"] * 1e6 for r in recs
            if r["tag"] == "stacked tox21 spmm" and r["launches"]}
    print("SpMM kernels at the stacked Tox21 SpMM, us: " + ", ".join(
        f"{k} {v:.1f}" for k, v in sorted(spmm.items())))


def _workload_of(workload_cls, key: str):
    """The Workload a cache key names (the fields this script sets)."""
    kw = {"itemsize": 4}
    names = {"b": "batch", "m": "m_pad", "nnz": "nnz_pad", "k": "k_pad",
             "n": "n_b", "i": "itemsize", "c": "channels", "nin": "n_in",
             "d": "dtype", "e": "d_e", "r": "reduce", "o": "op"}
    for part in key.split("_"):
        for p in sorted(names, key=len, reverse=True):
            if part.startswith(p) and part[len(p):]:
                val = part[len(p):]
                kw[names[p]] = val if names[p] in ("dtype", "reduce",
                                                   "op") else int(val)
                break
    return workload_cls(**kw)


if __name__ == "__main__":
    sys.exit(main())
