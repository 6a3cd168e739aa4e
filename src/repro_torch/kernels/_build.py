"""Build the hand-written CUDA kernels and load them with ``ctypes``.

Every ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, under ``build/kernels/`` at the
root of the checkout (listed in ``.gitignore``). The file name carries a
hash of the sources and flags, so an edited kernel rebuilds and an unchanged
one loads at once. All missing libraries build in parallel, one ``nvcc`` per
source. A failed build raises with the compiler's output.

Each entry point returns ``cudaGetLastError()`` after its launch; the
wrappers raise on a non-zero code (a launch refused for its shared memory
or block size never runs, and a later synchronise does not report it).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("batched_spmm_ell", "batched_spmm_coo", "batched_spmm_csr",
           "batched_spmm_hybrid", "batched_gemm", "fused_graph_conv",
           "grouped_matmul", "flash_attention")

_libs: dict[str, ctypes.CDLL] = {}
_entries: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default install prefix."""
    cands = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")] \
        if os.environ.get("CUDA_HOME") else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the port's CUDA kernels cannot be built")


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Compile every library of ``names`` that is not built yet, all at
    once. Returns the seconds each compile took (0.0 when it was cached);
    each compiler log is kept beside its library as ``<lib>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    seconds = {n: 0.0 for n in names}
    todo = [n for n in names if not _library_path(n).exists()]
    if not todo:
        return seconds
    exe = nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = _library_path(n)
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    failed = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"--- {n}.cu (nvcc exit {proc.returncode})\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return seconds


def sass_count(name: str, kernel: str, opcode: str) -> dict[str, int]:
    """How many ``opcode`` instructions (e.g. ``HGMMA``) the SASS of
    library ``name`` holds in each function whose mangled name contains
    ``kernel``, by ``cuobjdump -sass`` from ``nvcc``'s toolkit; keyed by
    the mangled name. Builds the library first."""
    load(name)
    exe = os.path.join(os.path.dirname(nvcc()), "cuobjdump")
    sass = subprocess.run([exe, "-sass", str(_library_path(name))],
                          capture_output=True, text=True, timeout=120)
    if sass.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {sass.stderr[-500:]}")
    counts, fn = {}, None
    for line in sass.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            fn = fn if kernel in fn else None
            if fn is not None:
                counts[fn] = 0
        elif fn is not None and opcode in line:
            counts[fn] += 1
    return counts


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building every missing
    library first."""
    if name not in _libs:
        build()
        _libs[name] = ctypes.CDLL(str(_library_path(name)))
    return _libs[name]


def entry(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """C entry point ``symbol`` of library ``name``, returning an int."""
    key = (name, symbol)
    if key not in _entries:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _entries[key] = fn
    return _entries[key]


def check(name: str, code: int) -> None:
    """Raise when a launch returned a CUDA error code."""
    if code != 0:
        lib = load(name)
        lib.repro_error_string.restype = ctypes.c_char_p
        lib.repro_error_string.argtypes = [ctypes.c_int]
        msg = lib.repro_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} "
                           f"({msg})")
