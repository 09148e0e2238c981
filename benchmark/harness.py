"""One run of one cell: set-up, the measured window, the traced stages,
the per-layer readers and the check.

The client is closed-loop with one client (a study process runs its
sweeps one after another): each request is one sweep, sent when the last
one's metric dicts are on the host.  The window runs for ``seconds`` and
then to the end of the request under way; its length is from the first
request's start to the last one's end, and every request it holds counts.

``--trace 1`` runs the same window with ``record_function`` labels on the
stages, and profiles every other request until ``TRACED`` of them are
whole (``tracer.Tracer``); the per-layer metrics read the whole profiled
requests (device records) and the requests that were not profiled (stage
spans).
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import cost
from .check import Sampler, host_copy, judge, load_limits
from .manifest import Cell
from .traffic import Traffic

__all__ = ["run_cell", "TRACED", "STAGES"]

HERE = Path(__file__).resolve().parent
TRACED = 10
STAGES = ("meshing", "stokes", "assembly", "ml_setup", "solve", "metrics")


def _log(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}",
        HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class _Stages:
    """The harness's spans around the port's calls: host seconds per stage
    (each ending in a device sync); in a profiled request each stage also
    starts with the tracer's sentinel (``Tracer.mark``)."""

    def __init__(self, port, labels, tracer):
        self.port, self.labels, self.tracer = port, labels, tracer
        self.seconds, self.order = {}, []
        self.profiled = False

    def begin(self, profiled):
        self.seconds, self.order = {}, []
        self.profiled = profiled and self.tracer is not None

    @contextlib.contextmanager
    def __call__(self, name):
        if self.profiled:
            self.tracer.mark(len(self.order))
            self.order.append(name)
        t0 = time.perf_counter()
        label = (torch.profiler.record_function(name) if self.labels
                 else contextlib.nullcontext())
        with label:
            yield
        self.port.sync()
        self.seconds[name] = self.seconds.get(name, 0.0) + \
            (time.perf_counter() - t0)


def _traced_window(stages, traced, out, peaks):
    """One profiled request's record: its wall and busy seconds, its
    device seconds by kernel, per attributed stage the same, and the
    solve's least time; None when its trace is not whole."""
    if not traced["whole"]:
        return None
    from .tracer import union_seconds

    def tally(recs, wall):
        ops = {}
        for n, a, b in recs:
            ops[n] = ops.get(n, 0.0) + (b - a) / 1e6
        return {"wall": wall, "ops": ops, "device": sum(ops.values()),
                "busy": union_seconds([(a, b) for _, a, b in recs])}

    rec = tally(traced["records"], sum(stages.seconds.values()))
    rec["stages"] = {name: tally(recs, stages.seconds[name])
                     for name, recs in traced["stages"].items()}
    info = out["info"]
    iters = int(np.max(info["iters"]))
    work = cost.solve_cost(out["sys"], out["ml"], len(out["D"]), iters,
                           int(info.get("passes") or 1), out["krylov"],
                           out["cycle"], out["n_smooth"])
    rec["solve_bound_s"] = cost.bound_seconds(work, peaks)
    return rec


class Run:
    """What the per-layer readers read (``metrics/<name>.py``)."""

    def __init__(self, requests, windows):
        self.requests = requests    # completed requests, in order
        self.windows = windows      # whole profiled requests

    def untraced(self):
        """The requests whose stages were not profiled (all of them if
        every one was)."""
        r = [q for q in self.requests if not q["traced"]]
        return r or self.requests


def run_cell(cell: Cell, seed, seconds, trace, device="cuda", t_start=None,
             control=False, port_hook=None):
    """One run: returns the result line's dict (``check`` last).
    ``control``: the control run (``check``); ``port_hook(port)``: lets a
    test break the timed path underneath."""
    from .port import Port
    t_start = time.perf_counter() if t_start is None else t_start
    cfg, mix = cell.config, cell.mix
    limits = load_limits(cell.name)
    port = Port(cfg, device, control=control)
    if port_hook is not None:
        port_hook(port)
    cuda = port.device.type == "cuda"
    tracer = None
    if trace and cuda:
        from .tracer import Tracer
        tracer = Tracer()
    stages = _Stages(port, bool(trace), tracer)
    traffic = Traffic(mix)

    # set-up: the configuration's own state, then one warm-up request
    first = traffic.next()
    stages.begin(False)
    port.setup(first["geometry"], stages)
    setup_stages = dict(stages.seconds)
    stages.begin(False)
    port.request(first, stages)
    port.sync()
    warm_stages = dict(stages.seconds)
    gc.collect()
    gc_log = _GcLog()
    sampler = Sampler(limits["sample"], seed)
    peaks = cost.chip_peaks(torch.cuda.get_device_name(port.device)) \
        if tracer is not None else None

    requests, windows = [], []
    dropped = failed = attempted = 0
    mem_start = _memory(cuda)
    t_win0 = time.perf_counter()
    setup_s = t_win0 - t_start
    while True:
        req = traffic.next()
        attempted += 1
        profiled = tracer is not None and len(requests) % 2 == 0 \
            and len(windows) < TRACED
        stages.begin(profiled)
        traced = {}
        t0 = time.perf_counter()
        with (tracer.request(stages.order, traced) if stages.profiled
              else contextlib.nullcontext()):
            try:
                out = port.request(req, stages)
            except Exception as e:         # an answer that never comes
                failed += 1
                _log(f"request {req['id']} failed: {type(e).__name__}: {e}")
                out = None
        t1 = time.perf_counter()
        if out is not None:
            info = out["info"]
            requests.append({
                "id": req["id"], "seconds": t1 - t0,
                "points": len(out["D"]), "stages": dict(stages.seconds),
                "iters": [int(v) for v in info["iters"]],
                "passes": info.get("passes"), "traced": stages.profiled})
            sampler.offer(req, {k: out[k] for k in
                                ("X", "D", "mu", "mesh", "dicts", "stokes")})
            if stages.profiled:
                rec = _traced_window(stages, traced, out, peaks)
                if rec is None:
                    dropped += 1
                    _log(f"request {req['id']}: trace not whole "
                         f"{traced['diag']}")
                else:
                    windows.append(rec)
            out = None
        if t1 - t_win0 >= seconds:
            break
    window_s = t1 - t_win0
    gc_log.stop()

    # the window has closed: the peak, then the program's state freed
    mem_peak = (torch.cuda.max_memory_allocated(port.device) if cuda
                else 0)
    mem_end = _memory(cuda)
    samples = [(req, host_copy(out)) for req, out in sampler.kept]
    sampler = None
    port.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    points = sum(q["points"] for q in requests)
    result = {"correct": False, "attempted": attempted, "failed": failed}
    if trace:
        run = Run(requests, windows)
        metrics = {}
        for m in cell.per_layer:
            value = _reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        _log(f"traced requests: {sum(q['traced'] for q in requests)}, "
             f"whole {len(windows)}, dropped {dropped}; stages attributed "
             f"in the whole ones: "
             f"{[sorted(w['stages']) for w in windows]}")
    else:
        values = {"points_per_s": points / window_s, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in values}
    result["metrics"] = metrics
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": (torch.cuda.get_device_name(port.device) if cuda
                    else "cpu"),
           "count": 1, "memory_peak_bytes": int(mem_peak)}
    if trace:
        dev.update(busy_s=sum(w["busy"] for w in windows),
                   window_s=sum(w["wall"] for w in windows))
        result["breakdown"] = _breakdown(windows)
    result["device"] = dev
    if requests:
        lat = sorted(q["seconds"] for q in requests)
        mean = {k: sum(q["stages"].get(k, 0.0) for q in requests)
                / len(requests) for k in STAGES}
        _log(f"request seconds: min {lat[0]:.4f} median "
             f"{statistics.median(lat):.4f} max {lat[-1]:.4f}; mean by "
             f"stage {mean}; mean by quarter of the window "
             f"{_quarters(requests)}")
    _log(f"window {window_s:.3f} s, {len(requests)} requests, {points} "
         f"points, set-up {setup_s:.3f} s (its stages {setup_stages}, "
         f"warm-up request {warm_stages}), "
         f"memory peak {mem_peak} B; {gc_log}; memory at the window's "
         f"start {mem_start}, end {mem_end}")

    t0 = time.perf_counter()
    if samples:
        nums = judge(cfg, samples, limits, control=control)
    else:
        nums = {k: [None, v] for k, v in limits.items() if k != "sample"}
    _log(f"check of {len(samples)} sampled requests in "
         f"{time.perf_counter() - t0:.1f} s")
    result["correct"] = bool(
        samples and failed == 0
        and all(v is not None and v <= lim for v, lim in nums.values()))
    result["check"] = nums
    return result


class _GcLog:
    """Collections of the cyclic garbage collector in the window, by
    generation, and the seconds they took (a cause of drift to rule in or
    out)."""

    def __init__(self):
        self.counts, self.seconds, self._t = [0, 0, 0], 0.0, None
        gc.callbacks.append(self._cb)

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.counts[info["generation"]] += 1
            self.seconds += time.perf_counter() - self._t
            self._t = None

    def stop(self):
        if self._cb in gc.callbacks:
            gc.callbacks.remove(self._cb)

    def __str__(self):
        return (f"gc collections by generation {self.counts} in "
                f"{self.seconds:.4f} s")


def _memory(cuda):
    """Host resident bytes and, on a card, the allocator's allocated and
    reserved bytes."""
    import resource
    out = {"host_maxrss_kb": resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss}
    if cuda:
        out.update(allocated=torch.cuda.memory_allocated(),
                   reserved=torch.cuda.memory_reserved())
    return out


def _quarters(requests):
    """Mean request seconds in each quarter of the window's requests."""
    n = len(requests)
    cuts = [round(i * n / 4) for i in range(5)]
    return [round(statistics.fmean(q["seconds"] for q in
                                   requests[cuts[i]:cuts[i + 1]]), 4)
            for i in range(4) if cuts[i + 1] > cuts[i]]


def _breakdown(windows):
    """The device operations that took most time over the whole traced
    requests, and the longest idle stretches by what the host was doing
    (per attributed stage)."""
    ops, idle = {}, {}
    for w in windows:
        for op, t in w["ops"].items():
            ops[op] = ops.get(op, 0.0) + t
        for name, s in w["stages"].items():
            idle[name] = idle.get(name, 0.0) + s["wall"] - s["busy"]
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(((f"host in {k}", v) for k, v in idle.items()),
                  key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in gaps]}
