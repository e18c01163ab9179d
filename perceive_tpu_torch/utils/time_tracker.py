"""A copy of perceive_tpu/utils/time_tracker.py.

Concurrent wall-clock tracker (reference: crates/
perceive-core/time_tracker.rs:7-52).

Accrues elapsed time only while at least one begin()..end() span is active, so
N overlapping workers count the wall time once — used for per-stage pipeline
timing in ScanStats.
"""

from __future__ import annotations

import threading
import time


class TimeTracker:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._active = 0
        self._accum = 0.0
        self._started_at = 0.0

    def begin(self) -> None:
        with self._lock:
            if self._active == 0:
                self._started_at = time.monotonic()
            self._active += 1

    def end(self) -> None:
        with self._lock:
            self._active -= 1
            if self._active == 0:
                self._accum += time.monotonic() - self._started_at

    def track(self) -> "_Span":
        return _Span(self)

    def elapsed(self) -> float:
        """Seconds accrued so far, including any currently-open span."""
        with self._lock:
            total = self._accum
            if self._active > 0:
                total += time.monotonic() - self._started_at
            return total


class _Span:
    def __init__(self, tracker: TimeTracker):
        self._tracker = tracker

    def __enter__(self) -> None:
        self._tracker.begin()

    def __exit__(self, *exc) -> None:
        self._tracker.end()
