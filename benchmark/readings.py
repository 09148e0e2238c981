"""The readings that the check's limits (``limits/<workload>.json``) are set
from: in one process, sound runs of a cell on many seeds (each number's
lower reading is the largest they give), control runs, the port's f32
solve and the reference's float32 metrics in the program's place (each
number's upper reading is the smallest they give), and loosened runs, the
configuration's transport and Stokes rtol each taken ten times larger (a
weaker guarantee than the configuration states; their smallest reading of
each number is printed beside the control's).

    python3 benchmark/readings.py --workload <cell> [--seeds 12]
        [--controls 3] [--loosened 3] [--seconds 8]
        [--base-seed 4000000000] [--out FILE]

Each run is ``harness.run_cell`` at the cell's own sizes and load, with a
short window (long enough to complete the requests a run's check samples);
the benchmark's own runs never run the control.  Prints one JSON line with
every run's numbers and the readings; needs a CUDA device.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--loosened", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--base-seed", type=int, default=4_000_000_000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[0] = str(ROOT)
    import os
    os.environ["FEU_DISK_CACHE"] = "0"
    import torch
    from benchmark.harness import run_cell
    from benchmark.manifest import Cell
    if not torch.cuda.is_available():
        sys.exit("readings: no CUDA device")
    cell = Cell(args.workload)
    loose = Cell(args.workload)
    loose.config["rtol"] *= 10
    if "rtol" in loose.config.get("stokes_options", {}):
        loose.config["stokes_options"]["rtol"] *= 10
    runs = {"sound": [], "control": [], "loosened": []}
    for kind, n, off in (("sound", args.seeds, 0),
                         ("control", args.controls, 1000),
                         ("loosened", args.loosened, 2000)):
        for i in range(n):
            seed = args.base_seed + off + i
            r = run_cell(loose if kind == "loosened" else cell, seed,
                         args.seconds, 0, device="cuda",
                         control=kind == "control")
            nums = {k: v for k, (v, _) in r["check"].items()}
            runs[kind].append({"seed": seed, "correct": r["correct"],
                               "failed": r["failed"], **nums})
            print(f"[readings] {kind} seed {seed}: {nums}", file=sys.stderr,
                  flush=True)
    keys = [k for k in runs["sound"][0] if k not in
            ("seed", "correct", "failed")]
    out = {"workload": args.workload,
           "card": torch.cuda.get_device_name(0),
           "lower": {k: max(r[k] for r in runs["sound"]) for k in keys},
           "upper": {k: min((r[k] for r in runs["control"]),
                            default=None) for k in keys},
           "loosened": {k: min((r[k] for r in runs["loosened"]),
                               default=None) for k in keys},
           "runs": runs}
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
