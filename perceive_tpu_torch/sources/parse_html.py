"""A copy of perceive_tpu/sources/parse_html.py (``requests`` loads only in
``make_session``).

HTML fetch + article extraction for the web connectors.

Behavior parity with the reference (crates/perceive-core/
sources/parse_html.rs): conditional GET with If-Modified-Since +
If-None-Match/ETag, HTTP-status -> SkipReason mapping, non-text content
stored with empty content (keeps title/etag so we never re-fetch), raw HTML
zstd-compressed for reprocessing, readability-style article extraction.

Article extraction lives in perceive_tpu_torch.sources.readability — an arc90
(Mozilla Readability) implementation matching the reference's readability
crate semantics (parse_html.rs:164-174); extract_html_article below is the
(title, text) façade the connectors and the reprocess pipeline call
(parse_html.rs:32-39).
"""

from __future__ import annotations

import email.utils
import sys
from typing import Optional
from urllib.parse import urlsplit

from ..types import Item, SkipReason
from .fs import compress_raw, decompress_raw
from .scanner import FoundItem, ReadResult

ALWAYS_SKIP = (
    # Sign-in/console pages: frequent in history, never searchable content
    # (reference parse_html.rs:11-18)
    "accounts.google.com",
    "ad.doubleclick.net",
    "console.cloud.google.com",
    "console.aws.amazon.com",
    "googleapis.com",
)

# bumped 1 -> 2 with the arc90 extractor: `source reprocess` re-extracts
# stored raw HTML under the new algorithm (reference parse_html.rs:30)
HTML_PROCESS_VERSION = 2
USER_AGENT = "perceive-tpu-search"
FETCH_TIMEOUT = 30


class TransientFetchError(Exception):
    """A fetch failure that should be RETRIED, never persisted as a skip:
    connection errors, timeouts, 429, and 5xx.  Propagates to the read
    stage, which forwards existing items UNCHANGED (content/vectors kept,
    access-time retry window preserved) and drops new items until the next
    scan.  Permanent skips (404, 403, redirects) stay SkipReason rows, per
    the reference's permanence table (lib.rs:38-46)."""


def should_skip(skip: list[str], url: str) -> bool:
    """Domain-suffix-match the host against skip + ALWAYS_SKIP
    (reference parse_html.rs:22-28).  The suffix must sit on a label
    boundary: skipping "x.com" must not swallow "phonetix.com"."""
    host = urlsplit(url).hostname or ""
    return any(
        host == s or host.endswith("." + s)
        # accept the common ".example.com" spelling too (raw endswith
        # matched it before the label-boundary fix)
        for s in (e.lstrip(".") for e in (*skip, *ALWAYS_SKIP))
    )


# -- article extraction ------------------------------------------------------


def extract_html_article(url: str, raw: bytes) -> tuple[str, str]:
    """(title, text) from raw HTML via the arc90 readability scorer
    (perceive_tpu_torch.sources.readability; reference parse_html.rs:32-39)."""
    from .readability import extract_article

    return extract_article(raw)


def reprocess_html_article(item: Item) -> ReadResult:
    """Re-extract from stored raw HTML; Found only when the result changed
    (reference parse_html.rs:41-72)."""
    if item.raw_content is None:
        return ReadResult.UNCHANGED
    raw = decompress_raw(item.raw_content)
    title, text = extract_html_article(item.external_id, raw)
    changed = (item.metadata.name != title) or (item.content != text)
    if not changed:
        return ReadResult.UNCHANGED
    item.process_version = HTML_PROCESS_VERSION
    item.metadata.name = title
    item.content = text
    return ReadResult.FOUND


# -- fetch -------------------------------------------------------------------


def fetch_html(
    session, existing: Optional[FoundItem], item: Item, *, unconditional: bool = False
) -> ReadResult:
    """Conditional GET + extract (reference parse_html.rs:74-182).

    ``session`` is requests.Session-shaped: ``get(url, headers=, timeout=,
    allow_redirects=False)`` -> response with .status_code/.headers/.text.
    ``unconditional`` drops the If-Modified-Since/If-None-Match headers —
    a forced rescan (or a missing embedding for the active model) must get
    a full body, not a 304 that downgrades the item to UNCHANGED.
    """
    headers = {"User-Agent": USER_AGENT}
    if not unconditional:
        mtime = item.metadata.mtime
        if mtime is None and existing is not None:
            mtime = existing.modified  # stored Last-Modified from the prior fetch
        if mtime is not None:
            headers["If-Modified-Since"] = email.utils.formatdate(mtime, usegmt=True)
        etag = item.hash or (existing.hash if existing else None)
        if etag:
            headers["If-None-Match"] = etag

    try:
        resp = session.get(
            item.external_id, headers=headers, timeout=FETCH_TIMEOUT, allow_redirects=False
        )
    except Exception as e:  # noqa: BLE001
        # TRANSIENT, not a permanent skip: the read stage forwards existing
        # items UNCHANGED (content and vectors kept, retry window
        # preserved); a permanent FETCH_ERROR here would overwrite an
        # indexed page's content with '' and delete its vectors over one
        # network blip
        raise TransientFetchError(f"fetch error: {e}") from e

    status = resp.status_code
    if status == 304:
        return ReadResult.UNCHANGED

    if status == 429 or status >= 500:
        # the server said "temporarily unavailable" — same transient
        # handling as a connection error, never a data-destroying skip
        raise TransientFetchError(f"HTTP {status}")
    if status in (401, 403):
        item.skipped = SkipReason.UNAUTHORIZED
    elif status == 404:
        item.skipped = SkipReason.NOT_FOUND
    elif 300 <= status < 400:
        item.skipped = SkipReason.REDIRECTED
    elif status >= 400:
        item.skipped = SkipReason.FETCH_ERROR
    if item.skipped is not None:
        return ReadResult.FOUND

    ct_header = resp.headers.get("Content-Type") or "text/plain"
    if "charset" not in ct_header.lower():
        # requests decodes charset-less text/* as ISO-8859-1 (RFC 2616
        # pedantry); the web is UTF-8 — without this a page declaring its
        # charset only in <meta> is stored as permanent mojibake, raw
        # bytes included, so reprocess can't heal it (reqwest's
        # .text() defaults UTF-8 the same way)
        resp.encoding = "utf-8"
    content_type = ct_header.split(";")[0].strip()
    item.hash = resp.headers.get("ETag")
    lm = resp.headers.get("Last-Modified")
    if lm:
        try:
            item.metadata.mtime = int(email.utils.parsedate_to_datetime(lm).timestamp())
        except (TypeError, ValueError):
            pass

    if not content_type.startswith("text/"):
        # keep the row (title/etag/mtime) with empty content so PDFs etc.
        # don't re-fetch every scan (parse_html.rs:148-154)
        item.content = ""
        return ReadResult.FOUND

    raw_text = resp.text or ""
    if not raw_text:
        item.skipped = SkipReason.NO_CONTENT
        return ReadResult.FOUND

    if content_type.startswith("text/html"):
        raw_bytes = raw_text.encode("utf-8")  # encode ONCE, share both uses
        item.raw_content = compress_raw(raw_bytes)
        title, text = extract_html_article(item.external_id, raw_bytes)
        item.metadata.name = title or item.metadata.name
        item.content = text
    else:
        item.content = raw_text
    item.process_version = HTML_PROCESS_VERSION
    return ReadResult.FOUND


def make_session():
    """Default HTTP client: gzip, no redirects (handled as SkipReason),
    30 s timeout (reference chromium_history.rs:41-46)."""
    import requests

    return requests.Session()
