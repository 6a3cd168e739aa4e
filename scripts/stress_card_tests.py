#!/usr/bin/env python3
"""Run the fused-layer tests of ``tests/test_torch_cuda.py`` on many torch
seeds, on one CUDA card, to measure how often they fail on their own random
draws.

    python3 scripts/stress_card_tests.py [--root CHECKOUT] [--seeds N]

``--root`` is the checkout whose ``src/`` and ``tests/`` are imported (this
one by default; point it at an unpacked older commit to compare). For each
seed s, torch is seeded with s before each test, as the file's own fixture
does with ``REPRO_TEST_SEED=s``, so a failing seed replays there.
"""
import argparse
import sys
import time
from pathlib import Path

TESTS = (("test_fused_backward_on_the_card_matches_plain", ()),
         ("test_fused_kernel_matches_plain", (12, 40)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parent.parent)
    ap.add_argument("--seeds", type=int, default=1000)
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path[:0] = [str(root / "src"), str(root / "tests")]
    import torch
    import test_torch_cuda as T

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", torch.cuda.current_device())
    fails, runs, t0 = [], 0, time.perf_counter()
    for seed in range(args.seeds):
        for name, extra in TESTS:
            for regime in T.REGIMES:
                torch.manual_seed(seed)
                runs += 1
                try:
                    getattr(T, name)(dev, regime, *extra)
                except AssertionError as e:
                    fails.append((seed, name, regime))
                    print(f"FAIL seed {seed} {name}[{regime}]: "
                          f"{' '.join(str(e).split())[:300]}", flush=True)
    print(f"{root}: {len(fails)} failures in {runs} runs ({args.seeds} seeds "
          f"x {len(TESTS)} tests x {len(T.REGIMES)} regimes, "
          f"{time.perf_counter() - t0:.1f} s)")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
