"""A copy of perceive_tpu/sources/chromium_bookmarks.py.

Chromium bookmarks connector.

Behavior parity with the reference (crates/perceive-core/
sources/chromium_bookmarks.rs): parse the profile's ``Bookmarks`` JSON,
recursively walk every root folder, emit an Item per URL entry with
atime = date_last_used (falling back to date_added when unused), apply the
skip-domain filter, and fetch via the shared conditional-GET HTML path.

Timestamp note: Chromium stores bookmark dates as WebKit epochs (µs since
1601-01-01).  The reference parsed them as unix seconds
(chromium_bookmarks.rs:74-83) which yields far-future dates; here they are
converted properly, with a unix-seconds fallback for already-converted files.
"""

from __future__ import annotations

import json
import os
from typing import Optional
from ..types import Item, ItemCompareStrategy, ItemMetadata
from .chromium_history import _stale_read_check, normalize_url, webkit_to_unix
from .parse_html import HTML_PROCESS_VERSION, fetch_html, make_session, should_skip
from .scanner import FoundItem, ReadResult


def _parse_time(s: Optional[str]) -> Optional[int]:
    try:
        v = int(s or "0")
    except ValueError:
        return None
    if v == 0:
        return None
    # WebKit µs values are ~1.3e16; unix seconds ~1.7e9
    return webkit_to_unix(v) if v > 10_000_000_000 else v


class ChromiumBookmarksScanner:
    def __init__(self, source_id: int, location: str, config: dict):
        self.source_id = source_id
        self.location = location
        self.skip = list(config.get("skip", []))
        self.session = make_session()

    def _walk(self, out: dict, entry: dict) -> None:
        etype = entry.get("type")
        if etype == "url":
            url = entry.get("url", "")
            atime = _parse_time(entry.get("date_last_used")) or _parse_time(
                entry.get("date_added")
            )
            # normalize like the history connector (https, no fragment) and
            # dedupe by the trailing-slash-stripped key: the same page
            # bookmarked in two folders must yield ONE item, or every scan
            # inserts a fresh duplicate row (external_id has no unique index)
            norm = normalize_url(url)
            if norm is None:
                return
            fetch_url, dedupe_key = norm
            if should_skip(self.skip, fetch_url):
                return
            prev = out.get(dedupe_key)
            if prev is not None:
                # same page bookmarked in two folders: MERGE instead of
                # keeping the first wholesale — emitting a stale atime would
                # mask the newer folder's use and the freshness gate
                # (`new_atime > old_atime`) would never re-fetch (same
                # hazard the history connector's MAX()/merge avoids,
                # chromium_history.py)
                if atime is not None and (prev.metadata.atime or 0) < atime:
                    prev.metadata.atime = atime
                if not prev.metadata.name and entry.get("name"):
                    prev.metadata.name = entry["name"]
                return
            out[dedupe_key] = Item(
                id=-1,
                source_id=self.source_id,
                external_id=fetch_url,
                process_version=HTML_PROCESS_VERSION,
                metadata=ItemMetadata(name=entry.get("name") or None, atime=atime),
            )
        elif etype == "folder":
            for child in entry.get("children", []):
                self._walk(out, child)

    def scan(self, emit) -> None:
        path = os.path.join(self.location, "Bookmarks")
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        out: dict = {}
        for root in (data.get("roots") or {}).values():
            if isinstance(root, dict):
                self._walk(out, root)
        for item in out.values():
            emit(item)

    def read(
        self,
        existing: Optional[FoundItem],
        compare_strategy: ItemCompareStrategy,
        item: Item,
    ) -> ReadResult:
        gate = _stale_read_check(existing, compare_strategy, item)
        if gate is not None:
            return gate
        return fetch_html(
            self.session, existing, item,
            unconditional=compare_strategy is ItemCompareStrategy.FORCE,
        )

    def latest_process_version(self) -> int:
        return HTML_PROCESS_VERSION

    def reprocess(self, item: Item) -> ReadResult:
        from .parse_html import reprocess_html_article

        return reprocess_html_article(item)
