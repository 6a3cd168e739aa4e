#!/usr/bin/env python3
"""Time the grouped-matmul kernel at every tile it can take, at R-GCN's
main-path shapes, and beside builds of patched copies of its source.

    python3 scripts/gmm_tiles.py [--variant stages=N] [--variant min_blocks=N]

On the card, for each shape of ``chip_smoke.py``'s ``grouped_matmul[...]``
rows (random x and weights from seed 0, equal relation groups): the
kernel's C entry called with each tile (8 rows a thread; 4, 8 or 16 row
groups; 4 or 8 columns a thread), checked against the plain version and
for the same bits as every other tile (one fmaf chain per output, whatever
the tile), timed by CUDA-graph replay, and marked where
``grouped_matmul.gmm_tile`` picks it, beside ``torch.bmm`` over the
groups (``library``) and the batched GEMM kernel over the groups
(``batched_gemm``: the same mainloop without the group passes). Each
``--variant`` copies the kernel's sources under ``build/gmm_tiles/``,
patches one constant and times the copy at the tile ``gmm_tile`` picks:
``stages=N`` the ring depth of ``gemm_tile.cuh`` (4), ``min_blocks=N`` a
minimum of N blocks an SM in the kernel's launch bounds (none). Prints
one JSON line ``{"card", "ms": {shape: {tile: ms}}}``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {   # tag: (M, K, N, groups)
    "rgcn tox21 serving layer 1": (28_672, 62, 64, 4),
    "rgcn tox21 training layer 1": (11_200, 62, 64, 4),
    "rgcn tox21 training layer 2 dx": (11_200, 64, 64, 4),
    "rgcn reaction100 layer 1": (28_672, 62, 512, 4),
    "rgcn reaction100 layer 2": (28_672, 512, 512, 4),
}
# variant: (file, text in the repo's source, the patched text)
PATCHES = {
    "stages": ("gemm_tile.cuh", "constexpr int kStages = 4;",
               "constexpr int kStages = {};"),
    "min_blocks": ("grouped_matmul.cu",
                   "__launch_bounds__(kLanes * kMaxGroups)\ngmm_kernel(",
                   "__launch_bounds__(kLanes * kMaxGroups, {})\ngmm_kernel("),
}


def _variant(spec: str, build, argtypes):
    """The C entry of a copy of the kernel with one constant patched."""
    name, value = spec.split("=")
    file, old, new = PATCHES[name]
    out = ROOT / "build" / "gmm_tiles" / f"{name}{value}"
    out.mkdir(parents=True, exist_ok=True)
    for f in list(build.CSRC.glob("*.cuh")) + [
            build.CSRC / "grouped_matmul.cu"]:
        shutil.copy(f, out / f.name)
    src = (out / file).read_text()
    if old not in src:
        raise SystemExit(f"gmm_tiles: {file} no longer holds {old!r}")
    (out / file).write_text(src.replace(old, new.format(int(value))))
    lib = out / "grouped_matmul.so"
    res = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                          str(out / "grouped_matmul.cu")],
                         capture_output=True, text=True)
    print(res.stdout + res.stderr, file=sys.stderr)
    if res.returncode:
        raise SystemExit(f"gmm_tiles: the {spec} build failed")
    fn = ctypes.CDLL(str(lib)).grouped_matmul_f32
    fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", action="append", default=[])
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    if not torch.cuda.is_available():
        print("gmm_tiles: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build, ref, stream_handle
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels.batched_gemm import batched_gemm_large

    torch.backends.cuda.matmul.allow_tf32 = False
    libs = {"repo": _build.entry("grouped_matmul", "grouped_matmul_f32",
                                 gm._ARGTYPES)}
    for spec in args.variant:
        libs[spec] = _variant(spec, _build, gm._ARGTYPES)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    ms = {}
    for tag, (m, k, n, e) in SHAPES.items():
        x = torch.randn((m, k), generator=gen).to(dev)
        w = (torch.randn((e, k, n), generator=gen) / k ** 0.5).to(dev)
        rg = gm._row_groups(torch.full((e,), m // e, dtype=torch.int32,
                                       device=dev), m, e)
        want = ref.grouped_matmul_ref(x, rg, w)
        picked = gm.gmm_tile(m, n)
        first, ms[tag] = None, {}
        for lib, fn in libs.items():
            tiles = [(g, c) for g in (4, 8, 16) for c in (4, 8)] \
                if lib == "repo" else [picked]
            for groups, cols in tiles:
                out = torch.empty((m, n), device=dev)

                def call():
                    code = fn(x.data_ptr(), w.data_ptr(), rg.data_ptr(),
                              out.data_ptr(), m, k, n, e, 128, 4, groups,
                              cols, stream_handle())
                    if code:
                        raise RuntimeError(f"launch failed: {code}")
                    return out

                key = (f"{lib}: {gm.THREAD_ROWS * groups} x {16 * cols}"
                       + (" (gmm_tile)" if (groups, cols) == picked else ""))
                cs.max_err(call(), want, f"{tag} {key}")
                got = out.clone()
                if first is None:
                    first = got
                cs.check(torch.equal(got, first),
                         f"{tag} {key}: other bits than another tile")
                ms[tag][key] = cs.graph_ms(call)
        xg = x.view(e, m // e, k)
        ms[tag]["library"] = cs.graph_ms(lambda: torch.bmm(xg, w))
        cs.max_err(batched_gemm_large(xg, w), torch.bmm(xg, w),
                   f"{tag} batched_gemm_large", (1e-3, 1e-4))
        ms[tag]["batched_gemm"] = cs.graph_ms(
            lambda: batched_gemm_large(xg, w))
        print(f"{tag}: {ms[tag]}", file=sys.stderr, flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
