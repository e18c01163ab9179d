"""A copy of perceive_tpu/utils/batch_sender.py.

Concurrent batcher: accumulate items from many threads, flush to a queue
in fixed-size batches, flush the remainder on close.

Role of the reference's BatchSender (crates/perceive-core/
batch_sender.rs:25-100): producers add items, consumers receive ``list`` s of
``batch_size`` (the tail batch may be smaller).  The guarantee that matters is
*no lost items* under concurrency, enforced here with a lock (Python's queue
hop dominates cost anyway; the ingest feeder uses this only on the host side).
"""

from __future__ import annotations

import queue
import threading
from typing import Generic, Optional, TypeVar

T = TypeVar("T")


class BatchSender(Generic[T]):
    def __init__(self, out: "queue.Queue[list[T]]", batch_size: int):
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        self.out = out
        self.batch_size = batch_size
        self._lock = threading.Lock()
        self._buf: list[T] = []
        self._closed = False

    def add(self, item: T) -> None:
        batch: Optional[list[T]] = None
        with self._lock:
            if self._closed:
                raise RuntimeError("BatchSender is closed")
            self._buf.append(item)
            if len(self._buf) >= self.batch_size:
                batch = self._buf[: self.batch_size]
                self._buf = self._buf[self.batch_size :]
        if batch is not None:
            self.out.put(batch)

    def add_many(self, items: list[T]) -> None:
        for it in items:
            self.add(it)

    def flush(self) -> None:
        with self._lock:
            batch, self._buf = self._buf, []
        if batch:
            self.out.put(batch)

    def close(self) -> None:
        """Flush the remainder; further adds raise."""
        with self._lock:
            self._closed = True
            batch, self._buf = self._buf, []
        if batch:
            self.out.put(batch)

    def __enter__(self) -> "BatchSender[T]":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
