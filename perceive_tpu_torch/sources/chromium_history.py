"""A copy of perceive_tpu/sources/chromium_history.py.

Chromium browser-history connector.

Behavior parity with the reference (crates/perceive-core/
sources/chromium_history.rs): copy the (possibly locked) History SQLite to a
temp dir, ``SELECT url, MAX(title), MAX(last_visit_time) ... WHERE url LIKE
'http%' GROUP BY url``, convert WebKit epochs (µs since 1601), normalize URLs
(force https, strip fragment), dedupe by trailing-slash-stripped key, apply
the skip-domain filter, shuffle so consecutive fetches spread across domains,
and fetch via the shared conditional-GET HTML path at read time.
"""

from __future__ import annotations

import os
import random
import shutil
import sqlite3
import tempfile
from typing import Optional
from urllib.parse import urlsplit, urlunsplit

from ..types import Item, ItemCompareStrategy, ItemMetadata
from .parse_html import HTML_PROCESS_VERSION, fetch_html, make_session, should_skip
from .scanner import FoundItem, ReadResult

# WebKit epoch (1601-01-01) to unix epoch offset in seconds
WEBKIT_EPOCH_OFFSET = 11_644_473_600


def webkit_to_unix(us: int) -> int:
    """µs since 1601-01-01 -> unix seconds (chromium_history.rs:75-78)."""
    return us // 1_000_000 - WEBKIT_EPOCH_OFFSET


def normalize_url(url: str) -> Optional[tuple[str, str]]:
    """(fetch_url, dedupe_key) or None if unparseable.

    Forces https and strips fragments; the dedupe key additionally strips a
    trailing path slash (kept on the fetch URL — some sites care)
    (chromium_history.rs:97-122).
    """
    try:
        parts = urlsplit(url)
    except ValueError:
        return None
    if not parts.hostname:
        return None
    if parts.scheme != "https" or parts.fragment:
        parts = parts._replace(scheme="https", fragment="")
    fetch = urlunsplit(parts)
    path = parts.path.rstrip("/")
    dedupe = urlunsplit(parts._replace(path=path)) if path != parts.path else fetch
    return fetch, dedupe


def _stale_read_check(
    existing: Optional[FoundItem], compare_strategy: ItemCompareStrategy, item: Item
) -> Optional[ReadResult]:
    """Shared web-connector read gate: honor permanent skips, and only
    re-fetch when this visit is newer than the stored access time
    (chromium_history.rs:159-178)."""
    if compare_strategy is ItemCompareStrategy.FORCE:
        return None
    if existing is not None and existing.skipped is not None and existing.skipped.permanent:
        item.skipped = existing.skipped
        return ReadResult.UNCHANGED
    if (
        existing is not None
        and not existing.has_embedding
        and (existing.content or "").strip()
    ):
        # no vector for the ACTIVE model (model switch / earlier embed
        # failure) but the content is already stored: reuse it WITHOUT a
        # re-fetch.  The match stage classified the item CHANGED, and a
        # FOUND read result preserves that, so the embed stage runs.
        # (Items with EMPTY stored content — untitled PDFs etc. — can never
        # embed; they fall through to the normal freshness gate instead of
        # re-fetching forever.)
        item.content = existing.content
        item.hash = existing.hash
        item.metadata.mtime = existing.modified
        return ReadResult.FOUND
    new_atime = item.metadata.atime
    old_atime = existing.last_accessed if existing else None
    if new_atime is not None and old_atime is not None and not new_atime > old_atime:
        return ReadResult.UNCHANGED
    return None


class ChromiumHistoryScanner:
    def __init__(self, source_id: int, location: str, config: dict):
        self.source_id = source_id
        self.location = location
        self.skip = list(config.get("skip", []))
        self.session = make_session()

    def scan(self, emit) -> None:
        with tempfile.TemporaryDirectory() as td:
            # browsers hold a lock on History; copy first (rs:52-57).  The
            # sidecar files ride along: a live WAL/journal holds the newest
            # visits, and a bare-file copy of a mid-write database can read
            # as "malformed" without its journal
            tmp = os.path.join(td, "History")
            shutil.copy(os.path.join(self.location, "History"), tmp)
            for suffix in ("-wal", "-shm", "-journal"):
                side = os.path.join(self.location, "History" + suffix)
                if os.path.exists(side):
                    try:
                        shutil.copy(side, tmp + suffix)
                    except OSError:
                        pass  # browser may rotate it mid-copy; best effort
            # the copy is private, so open read-write: recovering a copied
            # hot journal / WAL requires write access (read-only would fail
            # with SQLITE_READONLY_RECOVERY)
            conn = sqlite3.connect(tmp)
            try:
                rows = conn.execute(
                    """SELECT url, MAX(title), MAX(last_visit_time) FROM urls
                       WHERE url LIKE 'http%' GROUP BY url"""
                ).fetchall()
            finally:
                conn.close()

        out: dict[str, tuple[str, str, int]] = {}
        for url, title, last_visit in rows:
            norm = normalize_url(url)
            if norm is None:
                continue
            fetch_url, dedupe_key = norm
            if should_skip(self.skip, fetch_url):
                continue
            cand = (fetch_url, title or "", webkit_to_unix(last_visit or 0))
            prev = out.get(dedupe_key)
            if prev is not None:
                # merge duplicate spellings (http/https, trailing slash):
                # keep the first URL form (stable external_id) but the
                # NEWEST visit time and any non-empty title — keeping the
                # first row's atime could mask a fresh visit from the
                # _stale_read_check freshness gate
                cand = (prev[0], prev[1] or cand[1], max(prev[2], cand[2]))
            out[dedupe_key] = cand

        # spread consecutive fetches across domains (the reference leaned on
        # HashMap iteration order; we shuffle explicitly, rs:125-127)
        values = list(out.values())
        random.Random(0x5EED).shuffle(values)
        for fetch_url, title, atime in values:
            emit(
                Item(
                    id=-1,
                    source_id=self.source_id,
                    external_id=fetch_url,
                    process_version=HTML_PROCESS_VERSION,
                    metadata=ItemMetadata(name=title or None, atime=atime),
                )
            )

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
