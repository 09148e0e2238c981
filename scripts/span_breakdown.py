"""Where a benchmark cell's requests spend their time, by the program's own
spans and solve counters (``fenics_eff_uptake_tpu_torch/utils/profiling.py``).

    python3 scripts/span_breakdown.py --workload noadv.mu_sweep \
        [--requests 12] [--out build/spans_noadv.mu_sweep.json]

Drives the cell of ``BENCHMARK.json`` through ``benchmark.port.Port`` as
the harness does (set-up and one warm-up request first; the memos emptied
before each request, the disk cache off, each stage ending in a device
sync) with the span recorder on, and profiles every other request whole
(CUDA activity only, as the harness's tracer; a trace is kept only where
it holds one record per launch of the hand kernels).  Needs a CUDA
device.  Prints one JSON line (and writes it to ``--out``):

* ``stage_s``, ``tree_s``: over the unprofiled requests, the mean host
  seconds of each harness-style stage and of each span path;
  ``ml_split_s`` the ``ml_setup`` children's, ``ml_coverage`` the share
  of the ``ml_setup`` stage that level meshes, velocities and systems,
  transfers, transfer bands and the coarsest inverses cover;
* ``host_syncs_per_step``: the counters' deltas summed over every request;
* ``krylov_graph``: per request, the graphs of the Krylov step that the
  solves captured (``captures``), the share of the Krylov steps that ran
  as a replay of one (``graph_step_share``) and the seconds of the
  captures (``capture_s``, the ``solve.capture`` spans); and the host
  seconds of the ``solve`` span per Krylov step over the unprofiled
  requests (``solve_ms_per_step``);
* ``stokes``, for the set-up and for the requests: the Stokes solve's
  split (``stokes_split_s``: the ``stokes`` span's children, mean seconds
  per solve), its MINRES steps and host syncs per solve, and the transfer
  plans built (``plans``, ``widened``, ``fill``: live entries over band
  slots), from the counters' deltas;
* ``band_forms``, for the set-up and for the requests: kernel A's f32
  binds by form (``packed``, ``span``), the packed form's fill (nonzeros
  over slots), and kernel A's launches (``launches``; ``launches_packed``
  among them), from the counters' deltas;
* over the whole profiled requests: ``inside_share``, the device records
  that start inside a span of their request or less than 1 ms after one
  ends; ``solve_launches_per_step``, the records starting inside the
  ``solve`` span per Krylov step; ``idle_by_span``, the host time that
  each innermost span holds the device idle (its own stretches, less its
  children's and the device's busy time there), named by its path with
  the layer spans that a dotted child names left out; ``htod_pageable``,
  the pageable host-to-device copies by the innermost span they start in.
"""

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SLACK_US = 1000.0


def _short(names):
    """ml_setup/ml_setup.level_systems/assembly/assembly.reorder ->
    ml_setup.level_systems/assembly.reorder."""
    keep = [n for i, n in enumerate(names)
            if not (i + 1 < len(names)
                    and names[i + 1].startswith(n + "."))]
    return "/".join(keep)


def _paths(spans):
    by_id = {s[1]: s for s in spans}

    def chain(s):
        names = [s[0]]
        while s[2]:
            s = by_id[s[2]]
            names.append(s[0])
        return names[::-1]
    return {s[1]: chain(s) for s in spans}


def _minus(iv, cuts):
    """The parts of interval iv outside the sorted intervals cuts."""
    out, a = [], iv[0]
    for c0, c1 in cuts:
        if c1 <= a or c0 >= iv[1]:
            continue
        if c0 > a:
            out.append((a, c0))
        a = max(a, c1)
    if a < iv[1]:
        out.append((a, iv[1]))
    return out


def _busy_in(parts, recs):
    from benchmark.tracer import union_seconds
    clipped = [(max(a, r0), min(b, r1)) for a, b in parts
               for _, r0, r1 in recs if r1 > a and r0 < b]
    return union_seconds(clipped)


def _window(spans, recs):
    """One whole profiled request: its records against its spans."""
    paths = _paths(spans)
    kids = defaultdict(list)
    for s in spans:
        kids[s[2]].append((s[3], s[4]))
    inside = sum(any(s[3] <= r0 <= s[4] + SLACK_US for s in spans)
                 for _, r0, _ in recs)
    idle, dev = defaultdict(float), defaultdict(float)
    for s in spans:
        own = _minus((s[3], s[4]), sorted(kids[s[1]]))
        busy = _busy_in(own, recs)
        name = _short(paths[s[1]])
        idle[name] += sum(b - a for a, b in own) / 1e6 - busy
        dev[name] += busy
    htod = defaultdict(lambda: [0, 0.0])
    for n, r0, r1 in recs:
        if "HtoD" not in n or "Pageable" not in n:
            continue
        hold = [s for s in spans if s[3] <= r0 <= s[4] + SLACK_US]
        name = (_short(paths[max(hold, key=lambda s: s[3])[1]])
                if hold else "outside any span")
        htod[name][0] += 1
        htod[name][1] += (r1 - r0) / 1e6
    solve = [s for s in spans if s[0] == "solve"]
    in_solve = sum(any(s[3] <= r0 <= s[4] for s in solve)
                   for _, r0, _ in recs)
    return {"records": len(recs), "inside": inside, "in_solve": in_solve,
            "idle": idle, "device": dev, "htod": htod}


COUNTERS = ("stokes_solves", "minres_steps", "stokes_host_syncs",
            "rect_band_plans", "rect_band_widened", "rect_band_entries",
            "rect_band_slots")


BAND_COUNTERS = ("band_packed_binds", "band_span_binds",
                 "band_packed_entries", "band_packed_slots")


def _counters(profiling):
    from fenics_eff_uptake_tpu_torch.ops.banded import band_apply
    return {**{k: getattr(profiling, k) for k in COUNTERS + BAND_COUNTERS},
            "launches": band_apply.launches,
            "launches_packed": band_apply.launches_packed}


def _band_part(before, after):
    """Kernel A's binds by form, the packed fill and its launches between
    two counter readings."""
    d = {k: after[k] - before[k] for k in after}
    return {"packed": d["band_packed_binds"], "span": d["band_span_binds"],
            "fill": (d["band_packed_entries"] / d["band_packed_slots"]
                     if d["band_packed_slots"] else None),
            "launches": d["launches"],
            "launches_packed": d["launches_packed"]}


def _stokes_part(spans, before, after):
    """The Stokes solves and transfer plans between two counter readings,
    with the ``stokes`` span's children in ``spans``."""
    d = {k: after[k] - before[k] for k in COUNTERS}
    n = d["stokes_solves"]
    top = {s.id for s in spans if s.name == "stokes" and not s.parent}
    split = defaultdict(float)
    for s in spans:
        if s.parent in top:
            split[s.name] += (s.end_ns - s.start_ns) / 1e9
    return {"solves": n,
            "stokes_split_s": {k: v / n for k, v in split.items()} if n
            else {},
            "minres_steps_per_solve": d["minres_steps"] / n if n else None,
            "stokes_syncs_per_solve": (d["stokes_host_syncs"] / n if n
                                       else None),
            "plans": d["rect_band_plans"], "widened": d["rect_band_widened"],
            "fill": (d["rect_band_entries"] / d["rect_band_slots"]
                     if d["rect_band_slots"] else None)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    os.environ["FEU_DISK_CACHE"] = "0"
    os.environ["FEU_CACHE_DIR"] = str(ROOT / "build" / "span_breakdown")
    sys.path.insert(0, str(ROOT))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark.manifest import Cell
    from benchmark.port import Port
    from benchmark.tracer import is_whole
    from benchmark.traffic import Traffic
    from fenics_eff_uptake_tpu_torch.parallel.sharding import \
        kernel_launches
    from fenics_eff_uptake_tpu_torch.utils import profiling
    if not torch.cuda.is_available():
        sys.exit("span_breakdown: no CUDA device")

    def launches():
        n = kernel_launches()
        return n["band_apply"] + n["rect_band_apply"] + n["element_apply"]

    cell = Cell(args.workload)
    port = Port(cell.config, "cuda")
    traffic = Traffic(cell.mix)
    seconds = {}

    @contextlib.contextmanager
    def stage(name):
        t0 = time.perf_counter()
        yield
        port.sync()
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0

    first = traffic.next()
    c0 = _counters(profiling)
    with profiling.recording():
        port.setup(first["geometry"], stage)
    setup_stokes = _stokes_part(profiling.take(), c0, _counters(profiling))
    setup_bands = _band_part(c0, _counters(profiling))
    port.request(first, stage)
    port.sync()
    profiling.take()
    requests, windows = [], []
    c0 = _counters(profiling)
    stokes_spans = []
    for i in range(args.requests):
        req = traffic.next()
        seconds.clear()
        profiled = i % 2 == 0
        s0, k0, n0 = profiling.host_syncs, profiling.krylov_steps, \
            launches()
        g0 = (profiling.krylov_graph_captures, profiling.krylov_graph_steps)
        with profiling.recording():
            if profiled:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    out = port.request(req, stage)
            else:
                out = port.request(req, stage)
        spans = profiling.take()
        stokes_spans += spans
        q = {"id": req["id"], "profiled": profiled,
             "stages": dict(seconds),
             "syncs": profiling.host_syncs - s0,
             "steps": profiling.krylov_steps - k0,
             "captures": profiling.krylov_graph_captures - g0[0],
             "graph_steps": profiling.krylov_graph_steps - g0[1],
             "capture_s": sum((s.end_ns - s.start_ns) / 1e9 for s in spans
                              if s.name == "solve.capture"),
             "iters": [int(v) for v in out["info"]["iters"]],
             "passes": out["info"].get("passes")}
        out = None
        tree = defaultdict(float)
        paths = _paths(spans)
        for s in spans:
            tree["/".join(paths[s.id])] += (s.end_ns - s.start_ns) / 1e9
        q["tree"] = dict(tree)
        if profiled:
            recs = [(e.name, e.time_range.start, e.time_range.end)
                    for e in prof.events()
                    if str(e.device_type).endswith("CUDA")]
            q["whole"] = is_whole([r[0] for r in recs], launches() - n0)
            if q["whole"]:
                w = _window(profiling.on_timeline(spans, prof), recs)
                w["steps"] = q["steps"]
                windows.append(w)
        requests.append(q)
        print(f"[spans] request {req['id']} profiled={profiled} "
              f"stages={q['stages']} syncs={q['syncs']} "
              f"steps={q['steps']} captures={q['captures']} "
              f"graph_steps={q['graph_steps']} "
              f"capture_s={q['capture_s']:.4f}", file=sys.stderr, flush=True)

    plain = [q for q in requests if not q["profiled"]]
    request_stokes = _stokes_part(stokes_spans, c0, _counters(profiling))
    request_bands = _band_part(c0, _counters(profiling))

    def mean(key, qs, field):
        return statistics.fmean(q[field].get(key, 0.0) for q in qs)

    stage_names = sorted({k for q in plain for k in q["stages"]})
    paths = sorted({k for q in plain for k in q["tree"]})
    ml_kids = sorted({k.split("/")[1] for k in paths
                      if k.startswith("ml_setup/") and k.count("/") == 1})
    split = {k: mean(f"ml_setup/{k}", plain, "tree") for k in ml_kids}
    covered = sum(v for k, v in split.items() if k in (
        "ml_setup.level_meshes", "ml_setup.level_velocities",
        "ml_setup.level_systems", "ml_setup.transfers",
        "ml_setup.transfer_bands", "ml_setup.coarse_inverse"))
    ml_stage = mean("ml_setup", plain, "stages")
    idle, htod = defaultdict(float), defaultdict(lambda: [0, 0.0])
    for w in windows:
        for k, v in w["idle"].items():
            idle[k] += v
        for k, (n, t) in w["htod"].items():
            htod[k][0] += n
            htod[k][1] += t
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    result = {
        "workload": args.workload, "card": card.strip(),
        "requests": len(requests), "unprofiled": len(plain),
        "whole_profiled": len(windows),
        "stage_s": {k: mean(k, plain, "stages") for k in stage_names},
        "tree_s": {k: mean(k, plain, "tree") for k in paths},
        "ml_split_s": split, "ml_setup_span_s": mean("ml_setup", plain,
                                                     "tree"),
        "ml_coverage": covered / ml_stage if ml_stage else None,
        "ml_levels_s": sum(split.get(f"ml_setup.{k}", 0.0) for k in (
            "level_meshes", "level_velocities", "level_systems")),
        "ml_transfers_s": sum(split.get(f"ml_setup.{k}", 0.0) for k in (
            "transfers", "transfer_bands")),
        "ml_coarse_inverse_s": split.get("ml_setup.coarse_inverse", 0.0),
        "host_syncs_per_step": (sum(q["syncs"] for q in requests)
                                / max(1, sum(q["steps"] for q in requests))),
        "syncs_steps_passes": [(q["syncs"], q["steps"], q["passes"])
                               for q in requests],
        "krylov_graph": {
            "captures": [q["captures"] for q in requests],
            "graph_step_share": [q["graph_steps"] / q["steps"]
                                 if q["steps"] else None for q in requests],
            "capture_s": [q["capture_s"] for q in requests],
            "solve_ms_per_step": (
                1e3 * sum(q["tree"].get("solve", 0.0) for q in plain)
                / max(1, sum(q["steps"] for q in plain)))},
        "inside_share": (sum(w["inside"] for w in windows)
                         / max(1, sum(w["records"] for w in windows))),
        "solve_launches_per_step": (
            sum(w["in_solve"] for w in windows)
            / max(1, sum(w["steps"] for w in windows))),
        "idle_by_span": sorted(([k, v] for k, v in idle.items()),
                               key=lambda kv: -kv[1])[:15],
        "htod_pageable": sorted(([k, n, t] for k, (n, t) in htod.items()),
                                key=lambda x: -x[2]),
        "stokes": {"setup": setup_stokes, "requests": request_stokes},
        "band_forms": {"setup": setup_bands, "requests": request_bands},
    }
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
