#!/usr/bin/env python3
"""Which operand's type makes the hybrid SpMM kernel's bf16 entry slower
than its f32 entry: the kernel's template ``launch<V, D, I>`` (V: values
and slab, D: B and C, I: column ids) built at six instances from the
source as it is, and each timed on the same sparsity at the Tox21 serving
and powerlaw rows of ``scripts/fused_compare.py`` (B: Tox21 layer 1's
transformed features, N(0, 1) at powerlaw).

    python3 scripts/hybrid_types.py

The instances, from the f32 entry to the bf16 entry one type at a time:
``f32`` (float, float, int: the f32 entry), ``f32 + int16 ids``,
``bf16 values`` (bf16, float, short), ``bf16 B`` (float, bf16, short),
``bf16 + int32 ids`` (bf16, bf16, int) and ``bf16`` (bf16, bf16, short:
the bf16 entry). A wrapper that includes ``csrc/batched_spmm_hybrid.cu``
and exports one C entry per instance is built under the git-ignored
``build/hybrid_types/``; nothing in the kernel changes. Each instance is
checked against the plain version on its own operands, then timed by
CUDA-graph replay in four rounds (in order, reversed, in order, reversed).
Prints each instance's registers and spills (``ptxas -v``) and static
SASS counts (``cuobjdump``), a line per row and, last, one JSON line
``{"card", "registers", "sass", "ms": {row: {instance: [ms, ...]}}}``.
Needs a CUDA card and ``nvcc``.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "hybrid_types"
# name -> (C symbol, V, D, I)
INSTANCES = {
    "f32": ("h_f32", "float", "float", "int"),
    "f32 + int16 ids": ("h_f32_i16", "float", "float", "short"),
    "bf16 values": ("h_val_bf16", "__nv_bfloat16", "float", "short"),
    "bf16 B": ("h_b_bf16", "float", "__nv_bfloat16", "short"),
    "bf16 + int32 ids": ("h_bf16_i32", "__nv_bfloat16", "__nv_bfloat16",
                         "int"),
    "bf16": ("h_bf16", "__nv_bfloat16", "__nv_bfloat16", "short"),
}
_C_TYPE = {"float": "float32", "__nv_bfloat16": "bfloat16",
           "int": "int32", "short": "int16"}


def _library(build):
    """The wrapper library: one extern "C" entry per instance."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = [f'#include "{build.CSRC / "batched_spmm_hybrid.cu"}"']
    for sym, v, d, i in INSTANCES.values():
        src.append(
            f'extern "C" int {sym}(const int* rank, const int* start, '
            "const int* rlen, const void* cid, const void* val, "
            "const void* slab, const int* hubs, const void* b, void* c, "
            "int batch, int m_pad, int nnz_pad, int n_b, int n_block, "
            "int d_pad, void* stream) {\n"
            f"  return launch<{v}, {d}, {i}>(rank, start, rlen, cid, val, "
            "slab, hubs, b, c, batch, m_pad, nnz_pad, n_b, n_block, d_pad, "
            "stream);\n}")
    cu, so = OUT / "instances.cu", OUT / "instances.so"
    cu.write_text("\n".join(src) + "\n")
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                           str(cu)], capture_output=True, text=True,
                          timeout=600)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(so)), proc.stdout + proc.stderr, so


def _sass_counts(build, so) -> dict:
    """{instance: {opcode class: static count}} from ``cuobjdump -sass``:
    every instruction, the global loads, the FMAs and the integer ops that
    widen a bf16 (shifts, logic ops, byte permutes)."""
    exe = str(Path(build.nvcc()).parent / "cuobjdump")
    sass = subprocess.run([exe, "-sass", str(so)], capture_output=True,
                          text=True, timeout=120)
    if sass.returncode:
        raise RuntimeError(f"cuobjdump failed: {sass.stderr[-500:]}")
    classes = {"LDG": ("LDG",), "FFMA": ("FFMA",),
               "SHF/LOP3/PRMT/IMAD.SHL": ("SHF", "LOP3", "PRMT", "IMAD.SHL")}
    counts, fn = {}, None
    for line in sass.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            fn = _instance(name) if "hybrid_kernelI" in name else None
            if fn is not None:
                counts[fn] = dict.fromkeys(["instructions", *classes], 0)
        elif fn is not None and line.strip().startswith("/*"):
            # "/*0050*/  @P0 LDG.E R2, [R4.64] ;  /* encoding */"
            words = line.split("*/", 1)[1].split(";")[0].split()
            words = words[1:] if words and words[0].startswith("@") else words
            if not words or words[0].startswith("/*"):
                continue
            op = words[0]
            counts[fn]["instructions"] += 1
            for cls, prefixes in classes.items():
                if op.startswith(prefixes):
                    counts[fn][cls] += 1
    return counts


def _instance(mangled: str) -> str:
    """"f32/bf16/i16" from hybrid_kernel<float, __nv_bfloat16, short>'s
    mangled name (a repeated bf16 is a substitution, S<n>_)."""
    t = mangled.split("hybrid_kernelI")[1].split("EEv")[0]
    names = []
    while t:
        if t.startswith("13__nv_bfloat16"):
            names.append("bf16")
            t = t[len("13__nv_bfloat16"):]
        elif t.startswith("S"):
            names.append("bf16")
            t = t[t.index("_") + 1:]
        else:
            names.append({"f": "f32", "i": "i32", "s": "i16"}[t[0]])
            t = t[1:]
    return "/".join(names)


def main() -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    if not torch.cuda.is_available():
        print("hybrid_types: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core.batching import plan_hybrid
    from repro_torch.core.gcn import GCNConfig
    from repro_torch.core.graph_conv import flatten_channels
    from repro_torch.data.graphs import GraphDatasetSpec
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.batched_spmm_hybrid import _ARGTYPES, \
        hybrid_operands
    from repro_torch.serving.engine import GraphServeEngine

    lib, log, so = _library(_build)
    # ptxas -v: each kernel instance's registers and spill stores, as V/D/I
    regs, kernel, spill = {}, None, 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel, spill = _instance(line.split("'")[1]), 0
        elif "bytes spill stores" in line and kernel:
            spill = int(line.split("bytes spill stores")[0].split()[-1])
        elif "Used " in line and kernel:
            regs[kernel] = (int(line.split("Used ")[1].split()[0]), spill)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"[hybrid types] {card}; (registers a thread, spill-store bytes): "
          f"{regs}", flush=True)
    sass = _sass_counts(_build, so)
    for inst, c in sass.items():
        print(f"[hybrid types] SASS {inst}: {c}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    cfg = GCNConfig.tox21(impl="fused", bn_mode="sample")
    params = cs._params(cfg, 0, dev)
    wave = GraphServeEngine(params, cfg, device=dev, **cs.TOX21).assemble(
        cs._requests(GraphDatasetSpec.tox21_like(cs.TOX21["batch"], seed=0)))
    conv, m_pad = params["convs"][0], cs.TOX21["m_pad"]
    u = (torch.einsum("bmn,cnf->cbmf", wave.x, conv["w"])
         + conv["b"][:, None, None, :]).reshape(-1, m_pad, 64).contiguous()
    pl_adj, pl_m = cs._powerlaw_channels(dev)
    pl_b = torch.randn((pl_adj[0].batch, pl_m, 64), generator=gen).to(dev)
    rows = {"tox21": (flatten_channels(wave.adj), u, m_pad),
            "powerlaw": (pl_adj[0], pl_b, pl_m)}
    ms = {}
    for tag, (coo, b32, m) in rows.items():
        hp = plan_hybrid(batch=coo.batch, m_pad=m, n_b=64,
                         nnz_pad=coo.nnz_pad)
        # the bf16 entry's own plan has the same panels at these shapes
        assert hp.spmm.n_block == plan_hybrid(
            batch=coo.batch, m_pad=m, n_b=64, nnz_pad=coo.nnz_pad,
            itemsize=2).spmm.n_block
        rank, start, rlen, cid, val, slab, hubs = hybrid_operands(
            coo.row_ids, coo.col_ids, coo.values, coo.nnz, m, hp)
        batch, _, n_b = b32.shape
        calls = {}
        for name, (sym, v, d, i) in INSTANCES.items():
            vt, dt, it = (getattr(torch, _C_TYPE[t]) for t in (v, d, i))
            ops = (rank, start, rlen, cid.to(it), val.to(vt),
                   None if slab is None else slab.to(vt), hubs)
            b = b32.to(dt)
            fn = ctypes.CFUNCTYPE(ctypes.c_int, *_ARGTYPES)((sym, lib))

            def call(ops=ops, b=b, fn=fn):
                out = torch.empty_like(b)
                code = fn(*(None if t is None else t.data_ptr()
                            for t in ops + (b, out)),
                          batch, m, cid.shape[1], n_b, hp.spmm.n_block,
                          hp.d_pad, torch.cuda.current_stream().cuda_stream)
                if code:
                    raise RuntimeError(f"launch failed: CUDA error {code}")
                return out

            cs.max_err(call(), ref.batched_spmm_hybrid_plain(*ops, b),
                       f"{name}[{tag}]", cs.BF16_KERNEL_TOL
                       if dt == torch.bfloat16 else cs.F32_TOL)
            calls[name] = call
        times = {name: [] for name in calls}
        order = list(calls)
        for names in (order, order[::-1], order, order[::-1]):
            for name in names:
                times[name].append(cs.graph_ms(calls[name]))
        ms[tag] = times
        print(f"[hybrid types] {tag}: " + ", ".join(
            f"{n} {min(t):.5f}-{max(t):.5f}" for n, t in times.items()),
            flush=True)
    print(json.dumps({"card": card, "registers": regs, "sass": sass,
                      "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
