#!/usr/bin/env python3
"""Kernel time of one R-GCN Reaction100 serving wave against its wall time.

    python3 scripts/wave_profile.py [--root DIR]

Imports ``repro_torch`` and ``chip_smoke.py`` from the checkout at DIR (by
default the one this script lies in) and, on the card, assembles the first
wave of ``chip_smoke.py``'s R-GCN Reaction100 serving phase (128 requests,
``GCNConfig.reaction100(layer="rgcn")``, seed-0 parameters) and runs its
forward with ``impl`` = ref and pallas_csr: after two warm-up forwards,
five timed on the host clock between synchronizations (what
``chip_smoke.py`` reports as a wave's device forward), then three traced
by ``torch.profiler``, whose CUDA kernel events give the kernel time per
forward, the grouped matmul's part of it and the share of the wall time
in which no kernel ran. Prints one JSON line ``{"root", "card", impl:
{...}}``. To compare two trees, run it on both in one call, in turns.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    root = Path(ap.parse_args().root).resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("wave_profile: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core.gcn import GCNConfig
    from repro_torch.data.graphs import GraphDatasetSpec
    from repro_torch.serving.engine import GraphServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = {"root": str(root)}
    for impl in ("ref", "pallas_csr"):
        cfg = GCNConfig.reaction100(layer="rgcn", impl=impl)
        eng = GraphServeEngine(cs._params(cfg, 0, dev), cfg, device=dev,
                               **cs.TOX21)
        wave = eng.assemble(cs._requests(GraphDatasetSpec.reaction100_like(
            cs.TOX21["batch"], seed=0)))
        for _ in range(2):
            eng.forward(wave)
        wall = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.forward(wave)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                eng.forward(wave)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        cs.check(bool(kernels), "wave_profile: the trace holds no kernel")
        total = sum(e.time_range.elapsed_us() for e in kernels) / 3e3
        gmm = sum(e.time_range.elapsed_us() for e in kernels
                  if "gmm_kernel" in e.name) / 3e3
        wall_ms = statistics.median(wall)
        out[impl] = {"wall_ms": wall_ms, "kernel_ms": total,
                     "grouped_matmul_ms": gmm,
                     "kernels_per_forward": len(kernels) / 3,
                     "idle_share": 1 - total / wall_ms}
        print(f"{impl}: {out[impl]}", file=sys.stderr, flush=True)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
