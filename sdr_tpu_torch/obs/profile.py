"""Profiler hooks (port of ``sdr_tpu/obs/profile.py``, over
``torch.profiler``).

Profiling is a context manager around any call of the port; the trace is
a Chrome trace (viewable in ui.perfetto.dev or chrome://tracing) written
into ``log_dir``. ``profile_coded.py`` reads the same profiler's tables
for the coded and pipeline cells.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str, annotate: str | None = None):
    """Capture a trace of the enclosed block into ``log_dir/trace.json``:
    CPU activity, and CUDA activity (the kernels) where CUDA is available.
    ``annotate`` names the block (``record_function``). Yields the
    profiler, whose ``key_averages()`` the caller may read.

    Usage:
        with obs.trace("/tmp/sdr_trace"):
            fn(seed)  # any call of the port
    """
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(annotate) if annotate else contextlib.nullcontext():
            yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
