"""Run one cell of ``BENCHMARK.json`` once on the card and print its result
as the last line of standard output:

    python3 tinylfu_bench/run.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

Run it from the root of a checkout.  The program under test is the
``repro_torch`` package in ``src/``; its kernels are built into ``build/``
inside the checkout on the first run and found there afterwards.
``--trace 1`` runs the window under ``torch.profiler`` and prints the
per-layer metrics instead of the end-to-end ones.
"""
import time

T_START = time.perf_counter()       # set-up is timed from here

import argparse                      # noqa: E402
import os                            # noqa: E402
import sys                           # noqa: E402
from pathlib import Path             # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # caches of anything the program compiles stay inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / sub)
    # the program and the benchmark's package, in place of this directory
    sys.path[0:1] = [str(ROOT / "src"), str(ROOT)]
    from tinylfu_bench import harness
    return harness.main(args.workload, args.seed, args.seconds, args.trace,
                        T_START)


if __name__ == "__main__":
    sys.exit(main())
