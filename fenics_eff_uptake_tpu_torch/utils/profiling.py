"""Profiler hooks (counterpart of ``utils/profiling.py``; the reference
has none).

    with device_trace("/tmp/feu_trace"):
        solve_sweep(...)

writes a Chrome trace (``trace_<pid>_<ns>.json``, readable in Perfetto or
chrome://tracing) of the host and, where a CUDA device is present, the
device activity of the block; ``annotate(name)`` labels a span in it.
Unlike the JAX package's, ``device_trace`` raises where the profiler
cannot start instead of printing and running the block untraced.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["device_trace", "annotate"]


@contextlib.contextmanager
def device_trace(log_dir):
    """Profile the block; yields the ``torch.profiler.profile`` and
    writes its Chrome trace into ``log_dir`` when the block returns."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name):
    """A labelled span (``torch.profiler.record_function``) in the trace."""
    return torch.profiler.record_function(name)
