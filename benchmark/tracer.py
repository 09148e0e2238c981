"""Traced requests: one ``torch.profiler`` window per traced request,
read only where the trace is whole.

The profiler on the card's machine now and then loses CUDA records: the
first of a window, a sentinel kernel launched onto an idle device, or a
run of records around one (on the flow cell a whole stage boundary in
most windows); it lost no hand kernel's record in any window seen.  So a
window is whole when it holds exactly as many records of the hand kernels
(A and B: ``band_f32_kernel`` / ``tc_band_kernel``; C:
``element_tiles_kernel``) as the port's launch counters moved by, as
``chip_smoke.device_ms`` keeps its traces; a window that is not whole is
dropped, and never read.

Stage k of a request starts with a mark: two sentinel kernels
(``torch.cuda._sleep``) of 4^k times the base length, left out of every
sum, so that a surviving sentinel's length tells which boundary it marks
(a factor of 4 between marks, so that a clock half or twice the one the
base was timed at still reads the right mark).
A stage's records are those between its mark and the next; a stage whose
two marks were not both kept is not attributed (the whole request's busy
time still counts)."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

__all__ = ["HAND_KERNELS", "Tracer", "union_seconds", "is_whole"]

HAND_KERNELS = ("band_f32_kernel", "tc_band_kernel", "element_tiles_kernel")


def union_seconds(intervals):
    """Seconds covered by the union of (start_us, end_us) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e6


def is_whole(names, launched):
    """Whether a window's records hold one record of a hand kernel per
    launch the counters saw."""
    return sum(any(k in n for k in HAND_KERNELS) for n in names) == launched


def _launches():
    from fenics_eff_uptake_tpu_torch.parallel.sharding import \
        kernel_launches
    n = kernel_launches()
    return n["band_apply"] + n["rect_band_apply"] + n["element_apply"]


BASE_CYCLES = 5000           # about 2.5 us at the H100's clock


class Tracer:
    """Profiles requests on a CUDA device: one ``torch.profiler`` window
    per traced request (``request``) and a mark at each stage's start
    (``mark``)."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self._profile = lambda: profile(activities=[ProfilerActivity.CUDA])
        for _ in range(3):           # a trace may lose every record
            with self._profile() as prof:
                for _ in range(4):
                    torch.cuda._sleep(BASE_CYCLES)
                    torch.cuda.synchronize()
            recs = [e for e in prof.events()
                    if str(e.device_type).endswith("CUDA")]
            names = {e.name for e in recs}
            if len(names) == 1:
                break
        else:
            raise RuntimeError(f"sentinel kernel traced as {names}")
        self.sentinel = names.pop()
        self.base_us = float(np.median([e.time_range.elapsed_us()
                                        for e in recs]))

    def mark(self, k):
        """The mark of stage k (the device is idle there: every stage ends
        in a sync)."""
        for _ in range(2):
            torch.cuda._sleep(BASE_CYCLES << (2 * k))
        torch.cuda.synchronize()

    @contextlib.contextmanager
    def request(self, stages, out):
        """Profile one request whose ``stages`` (a list the body fills with
        each stage's name in order, marking its start) end in a sync.
        Fills ``out``: ``whole``, ``records`` (name, start_us, end_us)
        less the sentinels, and ``stages``: the records of each stage
        whose two marks were kept."""
        n0 = _launches()
        with self._profile() as prof:
            yield
        launched = _launches() - n0
        recs = sorted((e.time_range.start, e.time_range.end, e.name)
                      for e in prof.events()
                      if str(e.device_type).endswith("CUDA"))
        names = [r[2] for r in recs]
        out["whole"] = is_whole(names, launched)
        out["records"] = [(n, a, b) for a, b, n in recs
                          if n != self.sentinel]
        # each kept mark: (stage, first start, last end) of its sentinels
        bounds = {}
        for a, b, n in recs:
            if n == self.sentinel:
                k = int(round(np.log(max(b - a, 1e-3) / self.base_us)
                              / np.log(4.0)))
                lo, hi = bounds.get(k, (a, b))
                bounds[k] = (min(lo, a), max(hi, b))
        out["diag"] = {"records": len(recs), "launched": launched,
                       "hand": sum(any(k in n for k in HAND_KERNELS)
                                   for n in names),
                       "marks": sorted(bounds), "stages": len(stages)}
        out["stages"] = {}
        for k, name in enumerate(stages):
            last = k + 1 == len(stages)
            if k not in bounds or not (last or k + 1 in bounds):
                continue
            lo, hi = bounds[k][1], np.inf if last else bounds[k + 1][0]
            out["stages"][name] = [(n, a, b) for n, a, b in out["records"]
                                   if lo <= a < hi]
