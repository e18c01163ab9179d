"""The port's web connectors (Chromium history and bookmarks, the HTML fetch
and the readability extractor) against the JAX package's, on the CPU.

The fixtures are written by the tests: a ``History`` SQLite file, a
``Bookmarks`` JSON file, and a fake HTTP session (shaped as
tests/test_web_sources.py's) set on each scanner after construction, so
nothing touches the network.  Both packages scan them through their own
pipeline into databases of their own, with the tiny encoder of
tests/test_torch_ingest.py: the items, skips, process versions, stored
bytes and requests must be equal, and so must a rescan and a reprocess.
"""

import json
import sqlite3
from pathlib import Path

import numpy as np
import pytest
from test_torch_ingest import EMB_TOL, ITEM_SQL, tiny_models

from perceive_tpu.db import Database as JaxDatabase
from perceive_tpu.db import add_source as jax_add_source
from perceive_tpu.sources import parse_html as jax_html
from perceive_tpu.sources import readability as jax_readability
from perceive_tpu.sources import scan_source as jax_scan
from perceive_tpu.sources.chromium_bookmarks import ChromiumBookmarksScanner as JaxBookmarks
from perceive_tpu.sources.chromium_history import ChromiumHistoryScanner as JaxHistory
from perceive_tpu.sources.chromium_history import normalize_url as jax_normalize_url
from perceive_tpu.sources.chromium_history import webkit_to_unix as jax_webkit_to_unix
from perceive_tpu.sources.reprocess import reprocess_source as jax_reprocess
from perceive_tpu.types import Item as JaxItem
from perceive_tpu.types import ItemMetadata as JaxMetadata
from perceive_tpu.types import Source as JaxSource
from perceive_tpu_torch.db import Database, add_source
from perceive_tpu_torch.sources import parse_html, readability, scan_source
from perceive_tpu_torch.sources.chromium_bookmarks import ChromiumBookmarksScanner
from perceive_tpu_torch.sources.chromium_history import (
    ChromiumHistoryScanner,
    normalize_url,
    webkit_to_unix,
)
from perceive_tpu_torch.sources.reprocess import reprocess_source
from perceive_tpu_torch.types import Item, ItemMetadata, Source
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)

PAGES = Path(__file__).resolve().parent / "fixtures" / "pages"
WEBKIT_2023 = (1_700_000_000 + 11_644_473_600) * 1_000_000
PAGE = """<html><head><title>Pizza river notes | Site</title></head><body>
<nav><a href="/">Home</a><a href="/about">About</a></nav>
<article><h1>Pizza river notes</h1>
<p>The river kernel searches semantic music, pizza and mountain notes, with commas, here.</p>
<p>A second paragraph of the article body names the river and the mountain again.</p>
</article>
<footer>Copyright Footer Inc</footer></body></html>"""
HTML = {"Content-Type": "text/html; charset=utf-8"}


class FakeResponse:
    def __init__(self, status=200, headers=None, text=""):
        self.status_code = status
        self.headers = headers or {}
        self.text = text


class FakeSession:
    def __init__(self, responses):
        self.responses = responses  # url -> FakeResponse | Exception
        self.requests = []  # (url, headers)

    def get(self, url, headers=None, timeout=None, allow_redirects=False):
        self.requests.append((url, headers or {}))
        r = self.responses[url]
        if isinstance(r, Exception):
            raise r
        return r


def responses():
    long_page = PAGE.replace("</article>", "<p>" + "river music pizza, notes. " * 60 + "</p></article>")
    return {
        "https://a.test/page": FakeResponse(200, {**HTML, "ETag": '"e1"',
                                                  "Last-Modified": "Tue, 14 Nov 2023 22:13:20 GMT"}, PAGE),
        "https://a.test/long": FakeResponse(200, HTML, long_page),
        "https://b.test/plain": FakeResponse(200, {"Content-Type": "text/plain"}, "plain river notes"),
        "https://b.test/doc.pdf": FakeResponse(200, {"Content-Type": "application/pdf"}, "%PDF"),
        "https://b.test/empty": FakeResponse(200, HTML, ""),
        "https://c.test/missing": FakeResponse(404),
        "https://c.test/private": FakeResponse(403),
        "https://c.test/moved": FakeResponse(301),
        "https://c.test/gone": FakeResponse(410),
        "https://d.test/busy": FakeResponse(503),
        "https://d.test/down": ConnectionError("refused"),
        "https://keep.org/a": FakeResponse(200, HTML, PAGE.replace("Pizza", "Mountain")),
        "https://nested.org/b": FakeResponse(200, {"Content-Type": "text/html"}, "<p>nested bookmark page text</p>"),
    }


def write_history(path, extra=()):
    conn = sqlite3.connect(path)
    conn.execute("CREATE TABLE urls (id INTEGER PRIMARY KEY, url TEXT, title TEXT, last_visit_time INTEGER)")
    rows = [
        ("http://a.test/page#frag", "Page", WEBKIT_2023),
        ("https://a.test/page/", "Page slash", WEBKIT_2023 + 5_000_000),
        ("https://a.test/long", "", WEBKIT_2023),
        ("https://b.test/plain", None, WEBKIT_2023),
        ("https://b.test/doc.pdf", "Doc", WEBKIT_2023),
        ("https://b.test/empty", "Empty", WEBKIT_2023),
        ("https://c.test/missing", "Missing", WEBKIT_2023),
        ("https://c.test/private", "Private", WEBKIT_2023),
        ("https://c.test/moved", "Moved", WEBKIT_2023),
        ("https://c.test/gone", "Gone", WEBKIT_2023),
        ("https://d.test/busy", "Busy", WEBKIT_2023),
        ("https://d.test/down", "Down", WEBKIT_2023),
        ("https://accounts.google.com/x", "Skip me", WEBKIT_2023),
        ("https://sub.skip.test/y", "Skip too", WEBKIT_2023),
        ("chrome-extension://junk", "Nope", WEBKIT_2023),
        *extra,
    ]
    conn.executemany("INSERT INTO urls (url, title, last_visit_time) VALUES (?,?,?)", rows)
    conn.commit()
    conn.close()


def write_bookmarks(path):
    bookmarks = {"roots": {
        "bookmark_bar": {"type": "folder", "name": "Bar", "children": [
            {"type": "url", "url": "https://keep.org/a", "name": "Keep",
             "date_added": str(WEBKIT_2023), "date_last_used": "0"},
            {"type": "folder", "name": "Sub", "children": [
                {"type": "url", "url": "https://nested.org/b", "name": "Nested",
                 "date_added": "0", "date_last_used": str(WEBKIT_2023 + 9_000_000)},
                {"type": "url", "url": "http://keep.org/a/#x", "name": "",
                 "date_added": "0", "date_last_used": "1700000500"},
            ]},
            {"type": "url", "url": "https://googleapis.com/x", "name": "Skip"},
            {"type": "url", "url": "https://sub.skip.test/z", "name": "Skip too"},
            {"type": "url", "url": "bogus", "name": "Bad"},
        ]},
        "other": {"type": "folder", "name": "Other", "children": [
            {"type": "url", "url": "https://c.test/missing", "name": "Missing", "date_added": "1700000001"},
        ]},
        "sync_transaction_version": "1",
    }}
    path.write_text(json.dumps(bookmarks))


@pytest.fixture(scope="module")
def models():
    return tiny_models()


class WebSide:
    """One package's database, source and scanner for a web connector."""

    def __init__(self, pkg, tmp_path, model, kind, location):
        config = {"type": kind, "skip": ["skip.test"]}
        scanner_cls = {("jax", "chromium_history"): JaxHistory, ("jax", "chromium_bookmarks"): JaxBookmarks,
                       ("torch", "chromium_history"): ChromiumHistoryScanner,
                       ("torch", "chromium_bookmarks"): ChromiumBookmarksScanner}[pkg, kind]
        if pkg == "jax":
            self.db = JaxDatabase(tmp_path / "jax.sqlite3")
            self.src = jax_add_source(self.db, JaxSource(name="web", config=config, location=str(location)))
            self.scan, self.reprocess = jax_scan, jax_reprocess
        else:
            self.db = Database(tmp_path / "torch.sqlite3")
            self.src = add_source(self.db, Source(name="web", config=config, location=str(location)))
            self.scan, self.reprocess = scan_source, reprocess_source
        self.scanner = scanner_cls(self.src.id, str(location), config)
        self.scanner.session = FakeSession(responses())
        self.model = model

    def run(self, reprocess=False):
        self.scanner.session.requests.clear()
        if reprocess:
            stats, ok = self.reprocess(self.db, self.model, self.src, scanner=self.scanner)
        else:
            self.src.index_version += 1
            stats, ok = self.scan(self.db, self.model, self.src, scanner=self.scanner)
        summary = stats.summary()
        return ok, {k: v for k, v in summary.items() if not k.endswith("_time")}, sorted(
            (u, sorted(h.items())) for u, h in self.scanner.session.requests)

    def rows(self):
        items = {r[0]: r[1:] for r in self.db.read().execute(ITEM_SQL.replace(" FROM", ", last_accessed FROM"))}
        embs = {(r[0], r[1]): np.frombuffer(r[2], dtype="<f4") for r in self.db.read().execute(
            """SELECT items.external_id, e.chunk_idx, e.embedding FROM item_embeddings e
               JOIN items ON items.id = e.item_id""")}
        return items, embs


def assert_same_rows(jx, pt):
    (ji, je), (pi, pe) = jx.rows(), pt.rows()
    assert pi == ji
    assert sorted(pe) == sorted(je)
    for key, vec in je.items():
        np.testing.assert_allclose(pe[key], vec, atol=EMB_TOL, rtol=0, err_msg=str(key))


@pytest.mark.parametrize("kind", ["chromium_history", "chromium_bookmarks"])
def test_web_scan_matches_jax(models, tmp_path, kind):
    jm, pm = models
    profile = tmp_path / "profile"
    profile.mkdir()
    write_history(profile / "History")
    write_bookmarks(profile / "Bookmarks")
    jx = WebSide("jax", tmp_path, jm, kind, profile)
    pt = WebSide("torch", tmp_path, pm, kind, profile)

    first = pt.run()
    assert first == jx.run()
    assert first[0] and first[1]["scanned"] > 0 and first[1]["encoded"] > 0
    assert_same_rows(jx, pt)
    skipped = {r[6] for r in pt.rows()[0].values()}
    if kind == "chromium_history":
        assert {"not_found", "unauthorized", "redirected", "fetch_error", "no_content"} <= skipped

    # a rescan: permanent skips and unchanged visits fetch nothing; the
    # transient failures are retried
    again = pt.run()
    assert again == jx.run()
    assert again[1]["encoded"] == 0
    if kind == "chromium_history":
        # a newer visit re-fetches conditionally (If-None-Match / If-Modified-Since)
        (profile / "History").unlink()
        write_history(profile / "History", extra=[("https://a.test/page", "Page", WEBKIT_2023 + 60_000_000)])
        newer = pt.run()
        assert newer == jx.run()
        assert any(h for u, h in newer[2] if u == "https://a.test/page" and dict(h).get("If-None-Match"))
        assert_same_rows(jx, pt)

    # reprocess re-extracts stored raw HTML; nothing changes
    assert pt.run(reprocess=True) == jx.run(reprocess=True)
    with pt.db.write() as conn:  # an older extraction stored: the reprocess rewrites it
        conn.execute("UPDATE items SET content = 'stale', process_version = 1 WHERE raw_content IS NOT NULL")
    with jx.db.write() as conn:
        conn.execute("UPDATE items SET content = 'stale', process_version = 1 WHERE raw_content IS NOT NULL")
    redone = pt.run(reprocess=True)
    assert redone == jx.run(reprocess=True) and redone[1]["fetched"] > 0
    assert_same_rows(jx, pt)
    jx.db.close()
    pt.db.close()


def _page(body: str, title: str = "T") -> bytes:
    return f"<html><head><title>{title}</title></head><body>{body}</body></html>".encode()


CANNED = {
    **{p.name: p.read_bytes() for p in sorted(PAGES.glob("*.html"))},
    "article": PAGE.encode(),
    "fragment": b"<p>just a fragment of text, with a comma</p>",
    "garbage": b"\x00\x01 not html at all <<<>>>",
    "empty": b"",
    "media_class": _page('<div class="media"><p>' + "Media wrapped body text, long enough. " * 4 + "</p></div>"),
    "repeated": _page("<table>" + "<tr><td>Same cell text repeated here.</td></tr>" * 3 + "</table>"),
    "dash_title": _page("<p>Body text of the page, long enough to score a point.</p>",
                        "Understanding attention - and beyond"),
    "site_title": _page("<p>Body text of the page, long enough to score a point.</p>", "Headline of the day | Site"),
    "hidden": _page('<div hidden><p>hidden text that must not show up</p></div><p>Visible paragraph text, '
                    'with some commas, and more.</p><div aria-hidden="true">aria</div>'),
    "inline_flow": _page("<div>Bare div text <b>bold</b> and a <a href='x'>link</a><br>second line"
                         "<p>A paragraph of body text, with commas, enough to score.</p> tail text</div>"),
}


@pytest.mark.parametrize("name", sorted(CANNED))
def test_readability_matches_jax(name):
    raw = CANNED[name]
    want = jax_readability.extract_article(raw)
    assert readability.extract_article(raw) == want
    assert parse_html.extract_html_article("https://x.test/" + name, raw) == jax_html.extract_html_article(
        "https://x.test/" + name, raw)


FETCHES = {
    "html": FakeResponse(200, {**HTML, "ETag": '"v1"', "Last-Modified": "Tue, 14 Nov 2023 22:13:20 GMT"}, PAGE),
    "charsetless": FakeResponse(200, {"Content-Type": "text/html"}, PAGE),
    "plain": FakeResponse(200, {"Content-Type": "text/plain"}, "plain text"),
    "pdf": FakeResponse(200, {"Content-Type": "application/pdf"}, "%PDF"),
    "empty": FakeResponse(200, HTML, ""),
    "bad_date": FakeResponse(200, {**HTML, "Last-Modified": "not a date"}, PAGE),
    **{str(s): FakeResponse(s) for s in (304, 301, 401, 403, 404, 410, 429, 500)},
    "error": OSError("connection reset"),
}


@pytest.mark.parametrize("unconditional", [False, True])
@pytest.mark.parametrize("case", sorted(FETCHES))
def test_fetch_html_matches_jax(case, unconditional):
    url = "https://x.test/a"

    def fetch(html, item_cls, meta_cls):
        session = FakeSession({url: FETCHES[case]})
        item = item_cls(external_id=url, hash='"old"', metadata=meta_cls(mtime=1_600_000_000))
        try:
            got = html.fetch_html(session, None, item, unconditional=unconditional).value
        except html.TransientFetchError as e:
            got = f"transient: {e}"
        skipped = item.skipped.value if item.skipped else None
        return (got, skipped, item.content, item.hash, item.metadata.name, item.metadata.mtime,
                item.raw_content, item.process_version, session.requests)

    assert fetch(parse_html, Item, ItemMetadata) == fetch(jax_html, JaxItem, JaxMetadata)


def test_reprocess_html_article_matches_jax():
    raw = parse_html.compress_raw(PAGE.encode())
    assert raw == jax_html.compress_raw(PAGE.encode())
    for content, name in (("stale", "old"), (None, None)):
        p = Item(external_id="https://x.test/a", content=content, raw_content=raw, metadata=ItemMetadata(name=name))
        j = JaxItem(external_id="https://x.test/a", content=content, raw_content=raw, metadata=JaxMetadata(name=name))
        assert parse_html.reprocess_html_article(p).value == jax_html.reprocess_html_article(j).value
        assert (p.content, p.metadata.name, p.process_version) == (j.content, j.metadata.name, j.process_version)
    assert parse_html.reprocess_html_article(Item(external_id="u")).value == "unchanged"


URLS = ["http://a.com/x#frag", "https://a.com/x/", "https://a.com/", "notaurl", "https://[::1]:8080/p?q=1#f",
        "http://user@h.org:81/a/b/?c", "https://", "file:///etc/passwd", "https://[bad"]
SKIPS = [([], "https://accounts.google.com/login"), (["example.com"], "https://sub.example.com/x"),
         (["example.com"], "https://example.org/x"), (["x.com"], "https://phonetix.com/"),
         ([".example.com"], "https://a.example.com/"), ([], "https://console.cloud.google.com/a"),
         (["b.org"], "https://b.org"), ([], "notaurl")]


def test_url_helpers_match_jax():
    for url in URLS:
        assert normalize_url(url) == jax_normalize_url(url), url
    for skip, url in SKIPS:
        assert parse_html.should_skip(skip, url) == jax_html.should_skip(skip, url), (skip, url)
    for us in (0, WEBKIT_2023, WEBKIT_2023 + 999_999, 13_000_000_000_000_000):
        assert webkit_to_unix(us) == jax_webkit_to_unix(us)
