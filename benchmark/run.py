"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cells, configurations, traffic mixes and metrics are named in
``BENCHMARK.json`` at the root of the checkout; this file runs from that
root.  The run needs a CUDA device: without one, or with fewer than the
cell asks for, it exits with code 2 and prints no result.  It exits with
code 3, naming them on standard error, if a module of JAX or of the JAX
package is loaded at the start or once the window has closed.  The last
line on standard output is the result (JSON); the numbers the check
compared, each beside its limit, are the last lines on standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build" / "benchmark"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the program's caches inside the checkout, at fixed paths; no entry
    # of an earlier process serves a request
    os.environ["FEU_DISK_CACHE"] = "0"
    os.environ["FEU_CACHE_DIR"] = str(BUILD / "feu_cache")
    os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
    sys.path[0] = str(ROOT)

    from benchmark.isolation import loaded
    bad = loaded()
    if bad:
        print(f"isolation: loaded at start: {bad}", file=sys.stderr)
        sys.exit(3)
    import torch
    from benchmark.manifest import Cell
    cell = Cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        sys.exit(2)
    from benchmark.harness import run_cell
    result = run_cell(cell, args.seed, args.seconds, args.trace,
                      device="cuda", t_start=T_START)
    bad = loaded()
    if bad:
        print(f"isolation: loaded once the window closed: {bad}",
              file=sys.stderr)
        sys.exit(3)
    print(json.dumps(result), flush=True)
    for name, (value, limit) in result["check"].items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
