#!/usr/bin/env python3
"""Time the build of the port's CUDA kernel library two ways, in turns on
one machine: ``ops/_build.build`` (one nvcc per source, all started
together, then a link) against one nvcc call over all sources with the
same flags.  Each build starts from an empty directory.

    python3 scripts/kernel_build_time.py [--turns N]

Needs the CUDA toolkit, not a card.  Prints one line per build and, last,
one JSON object with every time in seconds.
"""

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from fenics_eff_uptake_tpu_torch.ops import _build  # noqa: E402


def per_source(d: Path) -> None:
    _build.BUILD_DIR = d
    _build.build()


def one_call(d: Path) -> None:
    cus = [str(s) for s in _build._sources() if s.suffix == ".cu"]
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    str(d / "lib.so"), *cus], check=True,
                   capture_output=True, timeout=1200)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args(argv)
    builds = {"per_source": per_source, "one_call": one_call}
    times = {name: [] for name in builds}
    order = ["per_source", "one_call", "one_call", "per_source"]
    for name in order * max(1, args.turns // 2):
        with tempfile.TemporaryDirectory() as d:
            t0 = time.time()
            builds[name](Path(d))
            times[name].append(time.time() - t0)
        print(f"[build] {name}: {times[name][-1]:.2f} s", flush=True)
    print(json.dumps(times))


if __name__ == "__main__":
    main()
