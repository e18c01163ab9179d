"""Device-side profiling hooks: port of perceive_tpu/utils/profiling.py.

TimeTracker (utils/time_tracker.py) times host stages; ``trace`` records a
``torch.profiler`` trace of a block, CPU and CUDA activity, as a Chrome
trace (viewable in Perfetto or chrome://tracing).

Enable globally with PERCEIVE_TPU_TRACE_DIR=/path: every ``trace("name")``
block then writes ``<dir>/<name>-<ms>.json``; without the variable the
context manager is free.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

TRACE_ENV = "PERCEIVE_TPU_TRACE_DIR"


@contextlib.contextmanager
def trace(name: str, trace_dir: Optional[str] = None) -> Iterator[None]:
    """Record a torch.profiler trace of the block when tracing is enabled."""
    target = trace_dir or os.environ.get(TRACE_ENV)
    if not target:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(target, exist_ok=True)
    path = os.path.join(target, f"{name}-{int(time.time() * 1000)}.json")
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(path)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region inside an active trace."""
    import torch

    with torch.profiler.record_function(name):
        yield
