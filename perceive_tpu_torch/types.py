"""A copy of perceive_tpu/types.py, so that the port imports nothing of the JAX
package (tests/test_torch_db.py holds the two schemas equal).

Core datatypes shared across the framework.

Semantics mirror the reference's core types (see crates/
perceive-core/lib.rs:14-61 for Item/ItemMetadata/SkipReason and
crates/perceive-core/sources.rs:21-108 for the source model),
re-expressed as host-side Python dataclasses.  Everything here is host-only
metadata; the TPU compute path never sees these objects — documents are
flattened to token batches and embedding rows before they reach the device.
"""

from __future__ import annotations

import enum
import json
from dataclasses import dataclass, field
from typing import Any, Optional


class SkipReason(enum.Enum):
    """Why an item was stored without content.

    ``permanent`` skips are never re-fetched on later scans
    (reference: lib.rs:25-46).
    """

    NOT_FOUND = "not_found"
    FETCH_ERROR = "fetch_error"
    UNAUTHORIZED = "unauthorized"
    # The item redirected elsewhere and this source does not follow
    # redirects (e.g. a login page).
    REDIRECTED = "redirected"
    NO_CONTENT = "no_content"

    @property
    def permanent(self) -> bool:
        return self is not SkipReason.NO_CONTENT

    def __str__(self) -> str:  # DB/text serialization
        return self.value

    @classmethod
    def parse(cls, s: Optional[str]) -> Optional["SkipReason"]:
        if not s:
            return None
        return cls(s)


@dataclass
class ItemMetadata:
    """Optional metadata gleaned from the item (reference: lib.rs:14-21).

    ``mtime``/``atime`` are unix timestamps in seconds (int) — the DB stores
    BIGINT seconds, so we never carry datetime objects across layers.
    """

    name: Optional[str] = None
    author: Optional[str] = None
    description: Optional[str] = None
    mtime: Optional[int] = None
    atime: Optional[int] = None


@dataclass
class Item:
    """One searchable document (reference: lib.rs:50-61).

    ``external_id`` is the path/URL inside the source.  ``raw_content`` holds
    the original bytes (zstd-compressed) for content that was post-processed
    (e.g. HTML -> article text), enabling reprocessing without a re-fetch.
    """

    id: int = -1
    source_id: int = -1
    external_id: str = ""
    hash: Optional[str] = None
    content: Optional[str] = None
    raw_content: Optional[bytes] = None
    process_version: int = 0
    metadata: ItemMetadata = field(default_factory=ItemMetadata)
    skipped: Optional[SkipReason] = None


class ItemCompareStrategy(enum.Enum):
    """How to decide whether a re-scanned item changed
    (reference: sources.rs:64-95).  String values match the reference's
    snake_case DB serialization so databases are interchangeable.
    """

    MTIME_AND_CONTENT = "m_time_and_content"
    MTIME = "m_time"
    CONTENT = "content"
    FORCE = "force"

    @property
    def should_compare_mtime(self) -> bool:
        return self in (ItemCompareStrategy.MTIME_AND_CONTENT, ItemCompareStrategy.MTIME)

    @property
    def should_compare_content(self) -> bool:
        return self in (ItemCompareStrategy.MTIME_AND_CONTENT, ItemCompareStrategy.CONTENT)

    def __str__(self) -> str:
        return self.value


class SourceTypeTag(enum.Enum):
    """Filter tag for search (`--type local|web|bookmarks`);
    reference: sources.rs:21-31."""

    LOCAL = "local"
    WEB = "web"
    BOOKMARKS = "bookmarks"


@dataclass
class SourceStatus:
    """Tagged status persisted as JSON in sources.status
    (reference: sources.rs:57-62).  Exactly one of the field groups is
    meaningful depending on ``status``.
    """

    status: str = "indexing"  # indexing | ready | error
    started_at: Optional[int] = None  # indexing
    scanned: Optional[int] = None  # ready
    duration: Optional[int] = None  # ready (seconds)
    error: Optional[str] = None  # error

    def to_json(self) -> str:
        d: dict[str, Any] = {"status": self.status}
        if self.status == "indexing":
            d["started_at"] = self.started_at or 0
        elif self.status == "ready":
            d["scanned"] = self.scanned or 0
            d["duration"] = self.duration or 0
        elif self.status == "error":
            d["error"] = self.error or ""
        return json.dumps(d)

    @classmethod
    def from_json(cls, s: Optional[str]) -> "SourceStatus":
        if not s:
            return cls(status="ready", scanned=0, duration=0)
        d = json.loads(s)
        return cls(
            status=d.get("status", "ready"),
            started_at=d.get("started_at"),
            scanned=d.get("scanned"),
            duration=d.get("duration"),
            error=d.get("error"),
        )

    @classmethod
    def indexing(cls, started_at: int) -> "SourceStatus":
        return cls(status="indexing", started_at=started_at)

    @classmethod
    def ready(cls, scanned: int, duration: int) -> "SourceStatus":
        return cls(status="ready", scanned=scanned, duration=duration)

    @classmethod
    def err(cls, error: str) -> "SourceStatus":
        return cls(status="error", error=error)


@dataclass
class Source:
    """A registered content source (reference: sources.rs:98-108).

    ``config`` is a tagged dict serialized to the sources.config JSON column;
    its "type" key selects the scanner (fs / chromium_history /
    chromium_bookmarks), mirroring the reference's tagged enum
    (sources.rs:33-41).
    """

    id: int = -1
    name: str = ""
    config: dict = field(default_factory=dict)
    location: str = ""
    compare_strategy: ItemCompareStrategy = ItemCompareStrategy.MTIME_AND_CONTENT
    status: SourceStatus = field(default_factory=SourceStatus)
    last_indexed: int = 0
    index_version: int = 0
    # seconds between automatic refresh scans (None = always due);
    # schema column existed unused in the reference (00001_init.sql:57)
    index_interval: Optional[int] = None

    @property
    def source_type(self) -> str:
        return self.config.get("type", "fs")

    def matches_tag(self, tag: SourceTypeTag) -> bool:
        t = self.source_type
        if tag is SourceTypeTag.LOCAL:
            return t == "fs"
        if tag is SourceTypeTag.WEB:
            return t in ("chromium_history", "chromium_bookmarks")
        if tag is SourceTypeTag.BOOKMARKS:
            return t == "chromium_bookmarks"
        return False
