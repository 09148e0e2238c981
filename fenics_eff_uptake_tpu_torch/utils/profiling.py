"""Spans, solve counters and profiler hooks (counterpart of
``utils/profiling.py``; the reference has none).

Spans.  ``span(name)`` marks a stretch of host work inside the program
(the layers ``meshing``, ``stokes``, ``assembly``, ``ml_setup``,
``solve``, ``metrics`` and their children, and ``StageTimer``'s stages).
Recording is off by default: a span is then one flag test and a shared
null context.  It is on inside ``recording()`` and inside
``device_trace``:

    with recording():
        solve_sweep(...)
    spans = take()      # the Span records since the last take()

A span records its name, its id, the id of its parent (the innermost span
open when it started; 0 for none) and its start and end in ns on the wall
clock (``time.time_ns``), the clock ``torch.profiler`` stamps its records
on: subtracting a profile's ``trace_start_ns`` puts a span on that
profile's record timeline (``on_timeline``).  While a torch profiler runs,
a span also enters a ``record_function`` of its name, so a trace with CPU
activity shows it.  A span never synchronizes the device; spans nest on
the thread that opens them, and the program opens them on one thread.

Counters, counted always (plain module integers, as the kernels' launch
counters are): ``host_syncs``, the blocking device-to-host reads of
``solve_sweep`` and of the batched Krylov loops, every one made through
``host_read``; ``krylov_steps``, the executed iterations of those loops
(one per trip, whatever the number of columns); ``krylov_graph_captures``,
the graphs of a step that the mixed solves captured on the card (one per
solve that replays, ``solvers.batched.KrylovGraph``), and
``krylov_graph_steps``, the steps among ``krylov_steps`` that ran as a
replay of one.  The Stokes solve counts
apart, so that syncs per Krylov step stay a transport number:
``stokes_solves``, the MINRES saddle solves run (``saddle_solve``; a
cached field is none); ``minres_steps``, their MINRES iterations over
every pass (the sum of ``outer_iters``); ``stokes_host_syncs``, their
blocking reads, every one made through ``stokes_read``.  The transfer
plans (``ops.band_plans.build_rect_band_plan``) count
``rect_band_plans`` built, ``rect_band_widened`` (those past the width
menu), ``rect_band_entries`` (the live entries placed) and
``rect_band_slots`` (T * R * W of each plan).  Kernel A's binds of an
f32 band on the card (``ops.banded.band_form``) count by form:
``band_packed_binds`` and ``band_span_binds``, and the packed form's
``band_packed_entries`` (nonzeros) and ``band_packed_slots`` (slots with
their padding).

``device_trace`` writes a Chrome trace (``trace_<pid>_<ns>.json``,
readable in Perfetto or chrome://tracing) of the host and, where a CUDA
device is present, the device activity of the block, with the spans in
it.  Unlike the JAX package's, it raises where the profiler cannot start
instead of printing and running the block untraced.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from typing import List, NamedTuple

import torch

__all__ = ["Span", "span", "recording", "take", "on_timeline",
           "device_trace", "host_read", "stokes_read"]

# read them as ``profiling.host_syncs``: an imported name is a copy
host_syncs = 0
krylov_steps = 0
krylov_graph_captures = 0
krylov_graph_steps = 0
stokes_solves = 0
minres_steps = 0
stokes_host_syncs = 0
rect_band_plans = 0
rect_band_widened = 0
rect_band_entries = 0
rect_band_slots = 0
band_packed_binds = 0
band_span_binds = 0
band_packed_entries = 0
band_packed_slots = 0


def host_read(t):
    """``t`` copied to the host as a numpy array: the solves' one way to
    read the device, counted in ``host_syncs``."""
    global host_syncs
    host_syncs += 1
    return t.cpu().numpy()


def stokes_read(t):
    """``host_read`` of the Stokes solve, counted in
    ``stokes_host_syncs``."""
    global stokes_host_syncs
    stokes_host_syncs += 1
    return t.cpu().numpy()


class Span(NamedTuple):
    name: str
    id: int
    parent: int         # the enclosing span's id; 0 for none
    start_ns: int       # time.time_ns()
    end_ns: int


_recording = False
_spans: List[Span] = []
_open: List[int] = []           # ids of the spans open now, innermost last
_ids = itertools.count(1)
_OFF = contextlib.nullcontext()


class _Open:
    __slots__ = ("name", "id", "parent", "start", "label")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.start = time.time_ns()
        self.label = None
        if torch.autograd.profiler._is_profiler_enabled:
            self.label = torch.profiler.record_function(self.name)
            self.label.__enter__()
        self.id = next(_ids)
        self.parent = _open[-1] if _open else 0
        _open.append(self.id)
        return self

    def __exit__(self, *exc):
        if self.label is not None:
            self.label.__exit__(*exc)
        end = time.time_ns()
        _open.pop()
        _spans.append(Span(self.name, self.id, self.parent, self.start,
                           end))
        return False


def span(name):
    """A context that records a span of ``name`` while recording is on."""
    if not _recording:
        return _OFF
    return _Open(name)


@contextlib.contextmanager
def recording():
    """Record spans inside the block (``take`` returns them)."""
    global _recording
    was, _recording = _recording, True
    try:
        yield
    finally:
        _recording = was


def take() -> List[Span]:
    """The spans ended since the last ``take``, in the order they ended;
    clears them."""
    global _spans
    out, _spans = _spans, []
    return out


def on_timeline(spans, prof):
    """``spans`` as (name, id, parent, start_us, end_us) on the record
    timeline of the finished ``torch.profiler`` profile ``prof`` (the
    frame of its events' ``time_range``)."""
    t0 = prof.profiler.kineto_results.trace_start_ns()
    return [(s.name, s.id, s.parent, (s.start_ns - t0) / 1e3,
             (s.end_ns - t0) / 1e3) for s in spans]


@contextlib.contextmanager
def device_trace(log_dir):
    """Profile the block with spans recorded; yields the
    ``torch.profiler.profile`` and writes its Chrome trace into
    ``log_dir`` when the block returns."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with recording(), \
            torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
