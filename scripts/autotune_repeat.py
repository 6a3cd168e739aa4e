#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s ``phase_autotune`` several times in one process
on one CUDA card, to see how often the tuning cache's picks hold when they
are timed again.

    python3 scripts/autotune_repeat.py [--root CHECKOUT] [--repeats N]

``--root`` is the checkout whose ``chip_smoke.py`` and ``src/`` are
imported (this one by default). The kernels are built once, then each
repeat starts from an empty tuning cache. Every ``[autotune]`` line the
phase prints is kept; a repeat whose checks fail is reported and the next
one runs. Exits 1 if any repeat failed.
"""
import argparse
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parent.parent)
    ap.add_argument("--repeats", type=int, default=4)
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    import torch

    if not torch.cuda.is_available():
        print("autotune_repeat: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.autotune import cache as tune_cache

    cs.phase_device()
    cs.phase_build()
    device = torch.device(cs.DEVICE)
    fails = 0
    for r in range(args.repeats):
        tune_cache._cache_for.cache_clear()
        t0 = time.perf_counter()
        try:
            cs.phase_autotune(device)
            verdict = "passed"
        except cs.SmokeFailure as e:
            fails += 1
            verdict = f"FAILED: {e}"
        print(f"[repeat {r + 1}/{args.repeats}] phase_autotune {verdict} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    print(f"{root}: {fails} of {args.repeats} repeats failed")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
