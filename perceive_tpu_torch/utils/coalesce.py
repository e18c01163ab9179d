"""A copy of perceive_tpu/utils/coalesce.py (jax-free, but the JAX package's
``utils/__init__`` imports jax).

Generic request coalescer: merge concurrent calls into one backend batch.

The serving pattern behind BatchingSearchExecutor, factored for reuse: the
device cost of an operation (a sweep, a chunk-encode) is per-DISPATCH, not
per-request, so concurrent requests should share one.  Requests enqueue; a
dispatcher thread drains the queue every ``window_ms`` (or immediately when
``max_batch`` are waiting, or when a single request arrives with no recent
dispatch activity — an uncontended caller pays zero added latency) and
answers all of them with one ``batch_fn(items)`` call.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Callable, Sequence


class CoalescingBatcher:
    def __init__(
        self,
        batch_fn: Callable[[Sequence], Sequence],
        *,
        window_ms: float = 2.0,
        max_batch: int = 64,
        idle_factor: float = 4.0,
        name: str = "coalescer",
        resolving: bool = True,
    ):
        """``resolving=True`` (default): ``batch_fn(items) -> results`` and
        the batcher resolves each future with its result.  ``resolving=
        False``: ``batch_fn(pairs)`` receives the live (item, future) pairs
        and is itself responsible for resolving every future (the search
        executor groups requests and resolves per group)."""
        self.batch_fn = batch_fn
        self.window = window_ms / 1e3
        self.max_batch = max_batch
        self.idle_after = idle_factor * self.window
        self.resolving = resolving
        self._last_drain = 0.0
        self._solo_streak = 0  # consecutive single-request drains (sequential-client detection)
        self._queue: list[tuple[object, Future]] = []
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True, name=name)
        self._thread.start()

    def submit(self, item) -> Future:
        fut: Future = Future()
        with self._wake:
            if self._closed:
                raise RuntimeError("batcher closed")
            self._queue.append((item, fut))
            self._wake.notify()
        return fut

    def call(self, item, timeout: float = 30.0):
        """Blocking convenience wrapper."""
        return self.submit(item).result(timeout)

    def close(self) -> None:
        with self._wake:
            self._closed = True
            self._wake.notify()
        self._thread.join(timeout=5)

    def _run(self) -> None:
        while True:
            with self._wake:
                while not self._queue and not self._closed:
                    self._wake.wait()
                if self._closed and not self._queue:
                    return
                now = time.monotonic()
                # dispatch a lone request immediately when (a) nothing
                # dispatched recently (idle), or (b) the last TWO drains
                # were also single requests — a SEQUENTIAL client (request,
                # response, request...) never exhibits concurrency, so
                # holding its lone request for the window buys nothing and
                # costs the window on every call.  Two-in-a-row (not one)
                # keeps the documented burst contract: a burst arriving
                # right after one idle query still coalesces.
                solo = len(self._queue) == 1 and (
                    now - self._last_drain > self.idle_after or self._solo_streak >= 2
                )
                if not solo:
                    deadline = now + self.window
                    while len(self._queue) < self.max_batch and not self._closed:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        self._wake.wait(remaining)
                batch, self._queue = self._queue[: self.max_batch], self._queue[self.max_batch :]
                self._last_drain = time.monotonic()
                self._solo_streak = self._solo_streak + 1 if len(batch) == 1 else 0
            live = [(it, f) for it, f in batch if f.set_running_or_notify_cancel()]
            if not live:
                continue
            if self.resolving:
                try:
                    results = self.batch_fn([it for it, _ in live])
                except Exception as e:  # noqa: BLE001 — fail requests, not the loop
                    for _, f in live:
                        f.set_exception(e)
                    continue
                for (_, f), r in zip(live, results):
                    f.set_result(r)
            else:
                try:
                    self.batch_fn(live)  # batch_fn resolves every future
                except Exception as e:  # noqa: BLE001 — bug guard: batch_fn
                    for _, f in live:  # must resolve, never raise
                        if not f.done():
                            f.set_exception(e)
