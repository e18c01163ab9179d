"""A copy of perceive_tpu/sources/scanner.py.

Scanner interface and scan-item state machine.

Host-side analog of the reference's SourceScanner trait and scan types
(crates/perceive-core/sources/pipeline.rs:22-104).  Scanners
are pure host code — they feed the device embed stage but never touch devices.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
from typing import Optional, Protocol, runtime_checkable

from ..types import Item, ItemCompareStrategy, SkipReason, Source
from ..utils import TimeTracker


class ReadResult(enum.Enum):
    """Outcome of reading one item's content (reference pipeline.rs:22-34)."""

    FOUND = "found"
    # Scanner determined content is unchanged (e.g. HTTP 304 via cache headers)
    UNCHANGED = "unchanged"
    # Present in the scan but unreadable/uninteresting; drop from the pipeline
    OMIT = "omit"


class ScanItemState(enum.Enum):
    """(reference pipeline.rs:57-68)"""

    NEW = "new"
    UNCHANGED = "unchanged"
    FOUND = "found"  # exists; changed-ness not yet determined
    CHANGED = "changed"  # will be re-encoded


@dataclasses.dataclass
class FoundItem:
    """Existing-row data carried from the match stage to read/compare
    (reference pipeline.rs:79-86)."""

    hash: str = ""
    content: str = ""
    modified: Optional[int] = None
    last_accessed: Optional[int] = None
    skipped: Optional[SkipReason] = None
    has_embedding: bool = False


@dataclasses.dataclass
class ScanItem:
    state: ScanItemState
    item: Item
    existing: Optional[FoundItem] = None


@runtime_checkable
class SourceScanner(Protocol):
    """Connector interface (reference pipeline.rs:36-55).

    ``scan`` emits Items (metadata only) into the sender; ``read`` fills one
    item's content; ``reprocess`` re-runs content post-processing from stored
    raw bytes without re-fetching.
    """

    def scan(self, emit) -> None:  # emit: callable(Item) (a BatchSender.add)
        ...

    def read(
        self,
        existing: Optional[FoundItem],
        compare_strategy: ItemCompareStrategy,
        item: Item,
    ) -> ReadResult:
        ...

    def latest_process_version(self) -> int:
        ...

    def reprocess(self, item: Item) -> ReadResult:
        return ReadResult.UNCHANGED


def create_scanner(source: Source) -> SourceScanner:
    """Scanner factory keyed by the source config's "type" tag
    (reference sources.rs:110-136)."""
    t = source.source_type
    if t == "fs":
        from .fs import FileScanner

        return FileScanner(source.id, source.location, source.config)
    if t == "chromium_history":
        from .chromium_history import ChromiumHistoryScanner

        return ChromiumHistoryScanner(source.id, source.location, source.config)
    if t == "chromium_bookmarks":
        from .chromium_bookmarks import ChromiumBookmarksScanner

        return ChromiumBookmarksScanner(source.id, source.location, source.config)
    raise ValueError(f"unknown source type {t!r}")


class _Counter:
    """Atomic u64 analog (CPython int ops on a lock)."""

    __slots__ = ("_v", "_lock")

    def __init__(self) -> None:
        self._v = 0
        self._lock = threading.Lock()

    def add(self, n: int = 1) -> None:
        with self._lock:
            self._v += n

    def sub(self, n: int = 1) -> None:
        with self._lock:
            self._v -= n

    @property
    def value(self) -> int:
        return self._v


class ScanStats:
    """Live pipeline counters + per-stage concurrent wall-clock timers
    (reference pipeline.rs:88-104).  Read by the CLI progress ticker."""

    def __init__(self) -> None:
        self.scanned = _Counter()
        self.encoded = _Counter()
        self.fetched = _Counter()
        self.added = _Counter()
        self.changed = _Counter()
        self.unchanged = _Counter()
        # items whose embed batch failed (poisoned): their rows may be left
        # un-bumped, so pruning after a scan with failures is unsafe
        self.embed_failed = _Counter()
        # gauges: items currently in flight per stage
        self.reading = _Counter()
        self.embedding = _Counter()

        self.scan_time = TimeTracker()
        self.read_time = TimeTracker()
        self.encode_time = TimeTracker()
        self.write_time = TimeTracker()

    def summary(self) -> dict:
        return {
            "scanned": self.scanned.value,
            "encoded": self.encoded.value,
            "fetched": self.fetched.value,
            "added": self.added.value,
            "changed": self.changed.value,
            "unchanged": self.unchanged.value,
            "embed_failed": self.embed_failed.value,
            "scan_time": round(self.scan_time.elapsed(), 3),
            "read_time": round(self.read_time.elapsed(), 3),
            "encode_time": round(self.encode_time.elapsed(), 3),
            "write_time": round(self.write_time.elapsed(), 3),
        }
