#!/usr/bin/env python3
"""What splitting P into two bf16 halves buys the bf16 flash-attention
kernel: at the Llama-3-8B prefill shape (B 2, T 4096, H 32, KV 8, hd 128,
causal), the kernel as built beside a copy built with
``-DREPRO_FLASH_P_LO=0`` (P rounded to bf16 alone, one P.V product), both
timed in one process on one card, in turns, and each with the count of its
outputs outside ``chip_smoke.py``'s FLASH_MAIN_TOL of the plain version.

    python3 scripts/flash_ablation.py [--iters N]

Needs a CUDA card and ``nvcc``; the copy is built under the git-ignored
``build/flash_ablation/``.
"""
import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "flash_ablation"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("flash_ablation: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.flash_attention import _ARGTYPES

    OUT.mkdir(parents=True, exist_ok=True)
    so = OUT / "p_bf16.so"
    build = subprocess.run(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-DREPRO_FLASH_P_LO=0", "-o",
         str(so), str(_build.CSRC / "flash_attention.cu")],
        capture_output=True, text=True)
    if build.returncode:
        print(f"flash_ablation: nvcc failed\n{build.stdout}{build.stderr}",
              file=sys.stderr)
        return 1
    libs = {"kernel": _build.load("flash_attention"),
            "p_bf16": ctypes.CDLL(str(so))}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, t, h, kv, hd = 2, 4096, 32, 8, 128
    q = torch.randn((b, t, h, hd), generator=gen, device=dev).bfloat16()
    k, v = (torch.randn((b, t, kv, hd), generator=gen, device=dev).bfloat16()
            for _ in range(2))
    want = ref.flash_attention_plain(q, k, v, causal=True).float()
    atol, rtol = chip_smoke.FLASH_MAIN_TOL["bfloat16"]

    def runner(lib):
        fn = ctypes.CFUNCTYPE(ctypes.c_int, *_ARGTYPES)(
            ("flash_attention_bf16", lib))

        def run():
            out = torch.empty_like(q)
            code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), b, t, t, h, kv, hd, hd ** -0.5, 1, 0,
                      torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"launch failed: CUDA error {code}")
            return out
        return run

    print(f"[ablation] {card}; B {b}, T {t}, H {h}, KV {kv}, hd {hd}, "
          "causal, bf16; ms by CUDA-graph replay", flush=True)
    times = {name: [] for name in libs}
    for name in ("kernel", "p_bf16", "p_bf16", "kernel"):   # in turns
        run = runner(libs[name])
        err = (run().float() - want).abs()
        over = int((err > atol + rtol * want.abs()).sum())
        times[name].append(chip_smoke.graph_ms(run, iters=args.iters,
                                               replays=2))
        print(f"[ablation] {name}: {times[name][-1]} ms; outputs outside "
              f"FLASH_MAIN_TOL {over}, max abs error {err.max().item()}",
              flush=True)
    base = sum(times["kernel"]) / 2
    for name, ms in times.items():
        print(f"[ablation] {name}: mean {sum(ms) / 2} ms, "
              f"{sum(ms) / 2 - base:+} ms against the kernel")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
