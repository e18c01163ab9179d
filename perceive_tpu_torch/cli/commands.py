"""CLI command handlers: port of perceive_tpu/cli/commands.py.

Each handler takes (state, args) from the argparse tree in main.py.  Fixes
over the reference are the JAX package's: working unhide (cmd/hide.rs:16
always hid), working `model set` (cmd/model.rs:30-32 stub), working
`refresh` (cmd.rs:31 stub) and `source edit` (cmd/source.rs:114 stub).
"""

from __future__ import annotations

import json
import sys
import threading
import time
from typing import Optional

from ..db import add_source, get_source, update_source, update_source_status
from ..index.searcher import MAX_K, SearchResult
from ..models import ModelType
from ..sources import ScanStats, prune_missing_items, scan_source
from ..sources.fs import decompress_raw
from ..sources.reprocess import reprocess_source
from ..types import ItemCompareStrategy, Source, SourceStatus, SourceTypeTag

BOLD = "\x1b[1m"
RESET = "\x1b[0m"


# -- source ------------------------------------------------------------------


def source_add(state, args) -> None:
    kind = args.source_type
    if kind == "fs":
        config = {"type": "fs", "globs": args.glob or []}
    elif kind == "browser-history":
        config = {"type": "chromium_history", "skip": args.skip or []}
    elif kind == "bookmarks":
        config = {"type": "chromium_bookmarks", "skip": args.skip or []}
    else:
        raise ValueError(f"unknown source type {kind}")
    if getattr(args, "chunk_tokens", None) is not None:
        # store explicit 0 too — it's the documented head-truncation opt-out
        # (chunk_config treats a MISSING key as "chunk at the wrap budget")
        config["chunk_tokens"] = args.chunk_tokens
    state.refresh_sources()
    if any(s.name == args.name for s in state.sources):
        # every name-based path (scan/search --source/remove) resolves to ONE
        # row; a second source under the same name would be unreachable
        raise ValueError(f"source named {args.name!r} already exists")
    if args.name.isdigit():
        # all-digit names collide with the id fallback in name resolution
        # (source_by_name/get_source) — `source remove 2` must never be
        # ambiguous between a NAME and an id
        raise ValueError("source names may not be all digits (ambiguous with ids)")
    src = Source(
        name=args.name,
        config=config,
        location=args.location,
        compare_strategy=ItemCompareStrategy(args.compare_strategy),
        status=SourceStatus.ready(0, 0),
    )
    src = add_source(state.db, src)
    state.refresh_sources()
    print(f"Added source {src.name} (id {src.id})")


def source_list(state, args) -> None:
    state.refresh_sources()
    for s in state.sources:
        st = s.status
        extra = (
            f"scanned {st.scanned} in {st.duration}s" if st.status == "ready"
            else st.error if st.status == "error" else "indexing"
        )
        print(f"{s.id:4d}  {s.name:24s} {s.source_type:18s} {s.location}  [{st.status}: {extra}]")


def _progress_ticker(stats: ScanStats, stop: threading.Event) -> None:
    """10 Hz live progress line (reference cmd/source.rs:254-281); suppressed
    when stderr is not a terminal (piped output would repeat the line)."""
    if not sys.stderr.isatty():
        stop.wait()
        return
    while not stop.wait(0.1):
        s = stats.summary()
        line = (
            f"\rscanned {s['scanned']} | fetched {s['fetched']} | encoded {s['encoded']} | "
            f"new {s['added']} changed {s['changed']} unchanged {s['unchanged']}"
        )
        print(line, end="", flush=True, file=sys.stderr)
    print(file=sys.stderr)


def _run_scan(
    state, src: Source, compare_strategy: Optional[ItemCompareStrategy], prune: bool,
    quiet: bool = False,
):
    """Bump index_version, Indexing -> scan -> Ready (cmd/source.rs:237-314).
    The searcher updates incrementally through on_embeddings instead of the
    reference's full per-source HNSW rebuild.  ``quiet`` silences the
    ticker and the summary prints (serve's background refresh)."""
    src.index_version += 1
    src.status = SourceStatus.indexing(int(time.time()))
    # status/version-only write: updating the FULL row here would revert a
    # concurrent `source edit` from another process with this process's
    # stale copy (the error and success paths already re-read
    # before writing for exactly this reason)
    update_source_status(state.db, src.id, src.status, index_version=src.index_version)

    stats = ScanStats()
    stop = threading.Event()
    ticker = None
    if not quiet:
        ticker = threading.Thread(target=_progress_ticker, args=(stats, stop), daemon=True)
        ticker.start()
    start = time.time()
    on_emb, on_rm = (
        state.searcher.pipeline_hooks() if state.searcher else (None, None)
    )
    ok = False
    try:
        stats, ok = scan_source(
            state.db, state.model, src, stats=stats, compare_strategy=compare_strategy,
            on_embeddings=on_emb, on_removed=on_rm,
        )
    except BaseException as e:
        # an exception BEFORE the stages start (bad config, scanner ctor)
        # must not leave the source stuck in status "indexing" forever; a
        # user interrupt is labeled as such, not as a source failure.
        # Re-read the row first: writing the stale pre-scan copy would
        # revert a concurrent `source edit` (same guard as the success path)
        msg = str(e) or type(e).__name__
        if isinstance(e, KeyboardInterrupt):
            msg = "interrupted"
        fresh = get_source(state.db, src.id) or src
        fresh.status = SourceStatus.err(msg)
        update_source(state.db, fresh)
        raise
    finally:
        stop.set()
        if ticker is not None:
            ticker.join()
    duration = int(time.time() - start)

    # re-read the row and update only scan-owned fields so a concurrent
    # `source edit` from another process isn't reverted by this stale copy
    fresh = get_source(state.db, src.id) or src
    fresh.index_version = src.index_version
    if ok:
        fresh.status = SourceStatus.ready(stats.scanned.value, duration)
        fresh.last_indexed = int(time.time())
    else:
        fresh.status = SourceStatus.err("scan failed; see stderr")
    update_source(state.db, fresh)
    src.status, src.last_indexed = fresh.status, fresh.last_indexed

    removed = []
    if ok and prune:
        if stats.embed_failed.value:
            # a poisoned embed batch leaves its CHANGED items at the old
            # version; pruning on version would delete LIVE files
            if not quiet:
                print(
                    f"skipping prune: {stats.embed_failed.value} items failed to embed this scan",
                    file=sys.stderr,
                )
        else:
            removed = prune_missing_items(state.db, src)
            if state.searcher and removed:
                state.searcher.remove_items(removed)
            if removed and not quiet:
                print(f"Pruned {len(removed)} vanished items")

    s = stats.summary()
    if not quiet:
        print(
            f"Finished in {duration} seconds: {s['scanned']} scanned, {s['added']} new, "
            f"{s['changed']} changed, {s['unchanged']} unchanged "
            f"(scan {s['scan_time']}s read {s['read_time']}s encode {s['encode_time']}s "
            f"write {s['write_time']}s)"
        )
    # persist only when the scan changed the index: a periodic refresh of an
    # unchanged corpus must not rewrite the snapshot every tick
    if ok and (s["added"] or s["changed"] or removed):
        _autosave_snapshot(state)
    return ok


# Persist the device matrix after scans once the corpus is big enough that a
# cold rebuild (a full BLOB scan) is slower than a snapshot load.
SNAPSHOT_MIN_ROWS = 50_000


def _snapshot_path(state) -> str:
    from ..paths import data_dir

    return str(data_dir() / f"matrix-{state.model.model_id}-{state.model.model_version}.npz")


def _autosave_snapshot(state, min_rows: Optional[int] = None) -> None:
    # the module global is read at call time, so the threshold stays tunable
    min_rows = SNAPSHOT_MIN_ROWS if min_rows is None else min_rows
    if state.searcher is None or len(state.searcher.matrix) < min_rows:
        return
    try:
        state.searcher.save_snapshot(state.db, _snapshot_path(state))
    except Exception as e:  # noqa: BLE001 — a snapshot is an optimization
        print(f"snapshot save failed: {e}", file=sys.stderr)


def import_db(state, args) -> None:
    """Import a reference perceive (or perceive-tpu) database: items,
    embeddings and tags transfer with no re-scan or re-embed; vectors for
    the active model stream straight into the device matrix."""
    import os

    from ..db.import_reference import import_reference_db

    if not os.path.exists(args.path):
        raise SystemExit(f"no such file: {args.path}")
    # deferred-maintenance hook: the import streams vectors inside its write
    # transaction; retier/audit run after commit (pipeline_hooks contract)
    hook = state.searcher.pipeline_hooks()[0] if state.searcher else None
    hook_model = (state.model.model_id, state.model.model_version) if state.model else None
    hook_dim = state.searcher.matrix.dim if state.searcher else None
    stats = import_reference_db(state.db, args.path, hook, hook_model, hook_dim)
    state.refresh_sources()
    print(
        f"Imported {stats['sources']} sources, {stats['items']} items, "
        f"{stats['embeddings']} embeddings, {stats['tags']} tags "
        f"from {args.path}"
    )
    if stats["dim_mismatch"]:
        print(
            f"warning: {stats['dim_mismatch']} embeddings share model id "
            f"{hook_model and hook_model[0]} but have a different dimension — "
            "imported to the store, NOT streamed to the index",
            file=sys.stderr,
        )
    if stats["embeddings"] and state.searcher is None:
        print("(searcher not built; vectors will load on next startup)")
    if stats["streamed"]:  # only rewrite the snapshot when the matrix changed
        _autosave_snapshot(state)


def snapshot_cmd(state, args) -> None:
    """Save the device matrix for a fast startup."""
    if state.searcher is None:
        print("searcher not built", file=sys.stderr)
        return
    path = args.path or _snapshot_path(state)
    state.searcher.save_snapshot(state.db, path)
    print(f"Saved {len(state.searcher.matrix)} vectors to {path}")


def source_scan(state, args) -> None:
    src = state.source_by_name(args.name)
    if src is None:
        raise SystemExit(f"No source named {args.name}")
    compare = None
    if getattr(args, "force", False):
        compare = ItemCompareStrategy.FORCE
    elif getattr(args, "by_content", False):
        compare = ItemCompareStrategy.CONTENT
    ok = _run_scan(state, src, compare, getattr(args, "prune", False))
    state.refresh_sources()
    if not ok:
        # automation (cron `scan || notify`) must see a nonzero exit; the
        # stage errors were already printed to stderr by the pipeline
        raise SystemExit(f"scan of {src.name} failed; see errors above")


def _due_sources(state, now: Optional[int] = None) -> list[Source]:
    """Sources whose index_interval has elapsed since last_indexed.

    Uses the schema's index_interval column (present but unused in the
    reference, 00001_init.sql); sources without an interval are always due.
    """
    now = now if now is not None else int(time.time())
    state.refresh_sources()
    due = []
    for src in state.sources:
        if src.index_interval is None or now - src.last_indexed >= src.index_interval:
            due.append(src)
    return due


def refresh(state, args) -> None:
    """Scan sources (the reference's top-level `refresh` was a stub).

    One-shot: scans every source (--due-only gates on index_interval).
    --watch SECONDS: loops, scanning only due sources each tick; Ctrl-C
    exits cleanly even mid-scan."""
    watch = getattr(args, "watch", None)
    due_only = watch is not None or getattr(args, "due_only", False)
    failed: list[str] = []
    try:
        while True:
            targets = _due_sources(state) if due_only else state.sources
            if due_only and not targets:
                print("no sources due")
            for src in targets:
                print(f"== {src.name}")
                try:  # one broken source must not stop the others
                    if not _run_scan(state, src, None, getattr(args, "prune", False)):
                        failed.append(src.name)
                except KeyboardInterrupt:
                    raise
                except Exception as e:  # noqa: BLE001
                    print(f"{src.name}: {e}", file=sys.stderr)
                    failed.append(src.name)
            if watch is None:
                if failed:  # one-shot refresh reports failure to automation
                    raise SystemExit(f"refresh failed for: {', '.join(failed)}")
                return
            failed.clear()
            time.sleep(watch)
    except KeyboardInterrupt:
        print("\nrefresh interrupted")
        return


def source_reprocess(state, args) -> None:
    src = state.source_by_name(args.name)
    if src is None:
        raise SystemExit(f"No source named {args.name}")
    on_emb, on_rm = (
        state.searcher.pipeline_hooks() if state.searcher else (None, None)
    )
    stats, ok = reprocess_source(
        state.db, state.model, src, on_embeddings=on_emb, on_removed=on_rm
    )
    s = stats.summary()
    print(f"Reprocessed {s['scanned']} items, {s['fetched']} changed, {s['encoded']} re-encoded")
    if not ok:
        raise SystemExit(f"reprocess of {src.name} failed; see errors above")


def source_rebuild_search(state, args) -> None:
    src = state.source_by_name(args.name)
    if src is None or state.searcher is None:
        print(f"No source named {args.name}", file=sys.stderr)
        return
    start = time.time()
    n = state.searcher.rebuild_source(state.db, src.id)
    print(f"Rebuilt source search ({n} rows) in {time.time() - start:.1f} seconds")


def source_remove(state, args) -> None:
    """Delete a source with its items/embeddings (cascade) and evict its
    rows from the device matrix.  The reference had no removal path."""
    src = state.source_by_name(args.name)
    if src is None:
        print(f"No source named {args.name}", file=sys.stderr)
        return
    if not getattr(args, "yes", False):
        print(f"Refusing to delete source {src.name!r} without --yes", file=sys.stderr)
        return
    n = state.db.read().execute(
        "SELECT COUNT(*) FROM items WHERE source_id = ?", (src.id,)
    ).fetchone()[0]
    with state.db.write() as conn:
        conn.execute("DELETE FROM sources WHERE id = ?", (src.id,))
    if state.searcher is not None:
        state.searcher.matrix.remove_source(src.id)
    state.refresh_sources()
    print(f"Removed source {src.name} and {n} items")


def _matrix_device_bytes(m) -> int:
    """Bytes the matrix holds on its devices: the stored vectors (at int2 the
    coarse codes and the companion), their scales and the source ids (every
    shard's, for a sharded matrix)."""

    def tensors(x):
        if isinstance(x, (tuple, list)):
            return [t for part in x for t in tensors(part)]
        return [] if x is None else [x]

    return sum(t.numel() * t.element_size() for t in tensors(m.device_view()))


def stats_cmd(state, args) -> None:
    """Index statistics (items, embeddings per model, device matrix)."""
    db = state.db
    n_items = db.read().execute("SELECT COUNT(*) FROM items").fetchone()[0]
    n_hidden = db.read().execute("SELECT COUNT(*) FROM items WHERE hidden_at IS NOT NULL").fetchone()[0]
    n_skipped = db.read().execute("SELECT COUNT(*) FROM items WHERE skipped IS NOT NULL").fetchone()[0]
    print(f"items: {n_items} ({n_hidden} hidden, {n_skipped} skipped)")
    for mid, mv, cnt in db.read().execute(
        "SELECT model_id, model_version, COUNT(*) FROM item_embeddings GROUP BY 1, 2"
    ):
        print(f"embeddings model {mid} v{mv}: {cnt}")
    if state.searcher is None:
        return
    m = state.searcher.matrix
    # the port has one engine, its kernels: the line names the device instead
    print(
        f"device matrix: {len(m)} vectors, capacity {m.capacity} x {m.padded_dim} "
        f"({m.tier_name}, ~{_matrix_device_bytes(m) / 1e6:.1f} MB device memory), device {m.device}"
    )
    if state.searcher.scan_calls:
        print(
            f"scans this session: {state.searcher.scan_calls} "
            f"({state.searcher.escalations} floor escalations)"
        )
    audit = state.searcher.coarse_audit
    if audit is not None and m.packed2:
        # the verdict from the LIVE matrix flag, not the recorded dict: the
        # flag is what routing consults
        fine = f"int{m.fine_bits}"
        verdict = "coarse pass serving" if m.coarse_trusted else (
            f"coarse pass DEMOTED to the {fine} fine sweep (dense ties)"
        )
        print(
            f"int2 coarse self-audit: top-{audit.get('k', 10)} overlap "
            f"{audit['overlap']:.4f} (min {audit.get('min_overlap', audit['overlap']):.4f}) "
            f"over {audit['queries']} sampled vectors at {audit['rows']} rows "
            f"(select {audit.get('select', 'exact')}, fetch "
            f"{audit.get('fetch', 0) or 'default'}, "
            f"{audit.get('strata', 1)} strata) — {verdict}"
        )


def source_edit(state, args) -> None:
    """Working version of the reference's unimplemented `source edit`."""
    src = state.source_by_name(args.name)
    if src is None:
        print(f"No source named {args.name}", file=sys.stderr)
        return
    if args.new_name:
        if args.new_name != src.name and any(
            s.name == args.new_name for s in state.sources
        ):
            # same uniqueness invariant as source_add (a rename
            # could silently shadow an existing source forever)
            raise SystemExit(f"source named {args.new_name!r} already exists")
        if args.new_name.isdigit():
            raise SystemExit("source names may not be all digits (ambiguous with ids)")
        src.name = args.new_name
    if getattr(args, "interval", None) is not None:
        src.index_interval = args.interval if args.interval > 0 else None
    if args.compare_strategy:
        src.compare_strategy = ItemCompareStrategy(args.compare_strategy)
    if args.glob is not None and src.source_type == "fs":
        src.config["globs"] = args.glob
    if args.skip is not None and src.source_type in ("chromium_history", "chromium_bookmarks"):
        src.config["skip"] = args.skip
    update_source(state.db, src)
    state.refresh_sources()
    print(f"Updated source {src.id}")


# -- search ------------------------------------------------------------------


class UnknownSource(KeyError):
    """--source names a source that doesn't exist."""


def resolve_source_filter(state, source: Optional[str], type_tag: Optional[str]) -> Optional[list[int]]:
    """source name / type tag -> source-id list (cmd/search.rs:40-57).

    The ONE filter resolver shared by the CLI and the HTTP API (serve.py) so
    their semantics can't drift.  Raises UnknownSource / ValueError (bad
    tag); returns None for "no filter".  [] means "matches nothing" (zero
    results), NOT "no filter": the reference returns empty for a tag with
    no sources."""
    if source:
        src = state.source_by_name(source)
        if src is None:
            raise UnknownSource(source)
        return [src.id]
    if type_tag:
        tag = SourceTypeTag(type_tag)  # ValueError on a bad tag
        return [s.id for s in state.sources if s.matches_tag(tag)]
    return None


def _resolve_source_filter(state, args) -> Optional[list[int]]:
    try:
        return resolve_source_filter(state, getattr(args, "source", None), getattr(args, "type", None))
    except UnknownSource as e:
        raise SystemExit(f"No source named {e.args[0]}") from e


# seconds per relative-time unit accepted by parse_when; "mo" is the mean
# Gregorian month and "y" the Julian year: close enough for search windows
_WHEN_UNITS = {
    "s": 1, "min": 60, "h": 3600, "d": 86400, "w": 604800,
    "mo": 2629800, "y": 31557600,
}


def parse_when(text: str, *, now: Optional[float] = None) -> int:
    """Parse a user-supplied point in time into unix seconds.

    Accepted forms (the `search --after/--before` filter; items carry
    mtime/atime as unix seconds, types.py):

    * relative: ``7d``, ``12h``, ``30min``, ``2w``, ``3mo``, ``1y``: that
      long before *now*;
    * absolute: anything ``datetime.fromisoformat`` takes (``2026-01-15``,
      ``2026-01-15T09:30``, with offset); naive values are LOCAL time,
      matching what `print` shows and users think in;
    * a raw unix timestamp (9+ digits, so date-like digit strings never
      collide with epochs).

    Raises ValueError with the accepted forms on anything else.
    """
    import re
    from datetime import datetime

    s = text.strip()
    if re.fullmatch(r"\d{9,}", s):
        return int(s)
    m = re.fullmatch(r"(\d+)\s*(s|min|h|d|w|mo|y)", s)
    if m:
        t = time.time() if now is None else now
        return int(t - int(m.group(1)) * _WHEN_UNITS[m.group(2)])
    try:
        return int(datetime.fromisoformat(s).timestamp())
    except ValueError:
        raise ValueError(
            f"can't parse time {text!r}: use a relative offset (7d, 12h, 30min, "
            "2w, 3mo, 1y), an ISO date/datetime (2026-01-15[T09:30]), or a unix "
            "timestamp"
        ) from None


def item_time(item) -> Optional[int]:
    """The timestamp an item is filtered and sorted by: mtime (fs files,
    pages with Last-Modified) falling back to atime (bookmark/history visit
    or fetch time).  None when the connector recorded neither."""
    m = item.metadata
    return m.mtime if m.mtime is not None else m.atime


def filter_results_by_time(results: list, after: Optional[int], before: Optional[int]) -> list:
    """Keep results whose item_time lies in [after, before).  Items with no
    timestamp at all are dropped: a time filter asks for provably-in-range
    items.  Shared by the CLI and serve so semantics can't drift (same
    contract as resolve_source_filter)."""
    if after is None and before is None:
        return results
    out = []
    for r in results:
        t = item_time(r.item)
        if t is None:
            continue
        if after is not None and t < after:
            continue
        if before is not None and t >= before:
            continue
        out.append(r)
    return out


def format_result(r: SearchResult, highlight: Optional[str]) -> str:
    title = r.item.metadata.name or r.item.external_id
    lines = [f"{r.source_name} ({r.item.id}): {BOLD}{title}{RESET}  [{r.score:.4f}]"]
    if highlight:
        lines.append("  " + highlight.replace("\n", " • "))
    return "\n".join(lines)


def search(state, args) -> list[SearchResult]:
    if state.searcher is None:
        print("searcher not built", file=sys.stderr)
        return []
    source_ids = _resolve_source_filter(state, args)
    k = args.num_results

    tag_items = None
    if getattr(args, "tag", None):
        from ..db import items_with_tag

        tag_items = items_with_tag(state.db, args.tag)
        if tag_items is None:
            raise SystemExit(f"no tag named {args.tag}")
    try:
        after = parse_when(args.after) if getattr(args, "after", None) else None
        before = parse_when(args.before) if getattr(args, "before", None) else None
    except ValueError as e:
        raise SystemExit(str(e)) from e
    # tag/time filtering is a host-side post-filter; over-fetch to keep k
    # results.  Stay under the searcher's user-facing cap: -n 300 --tag must
    # not explode just because the post-filter over-fetch would exceed MAX_K
    post_filter = tag_items is not None or after is not None or before is not None
    fetch_k = min(4 * k, MAX_K) if post_filter else k

    hl_q = None  # highlight-model query embedding, from the fused search
    if getattr(args, "like", None):
        vec = state.searcher.stored_embedding(state.db, int(args.like))
        if vec is None:
            raise SystemExit(f"item {args.like} has no stored embedding")
        results = state.searcher.search_vector_and_retrieve(state.db, vec, fetch_k, source_ids)
    else:
        query = " ".join(args.query)
        if not query:
            raise SystemExit("search needs a query or --like <item-id>")
        hits, hl_q = state.searcher.search_fused(
            state.model, query, fetch_k, source_ids, aux_model=state.highlights_model
        )
        results = state.searcher.retrieve(state.db, hits)

    if tag_items is not None:
        results = [r for r in results if r.item.id in tag_items]
    results = filter_results_by_time(results, after, before)[:k]
    if getattr(args, "sort", None) == "time":
        # top-k stays relevance-selected; --sort time only reorders the
        # DISPLAY of those k by recency (newest first, untimed last)
        results.sort(key=lambda r: item_time(r.item) or -1, reverse=True)

    docs = [r.item.content or "" for r in results]
    query_text = " ".join(args.query) if args.query else ""
    highlights = (
        state.highlights_model.highlight(query_text, docs, query_emb=hl_q)
        if query_text and docs
        else [None] * len(docs)
    )
    for r, h in zip(results, highlights):
        r.highlight = h
    if getattr(args, "json", False):
        print(
            json.dumps(
                [
                    {
                        "id": r.item.id,
                        "score": r.score,
                        "title": r.item.metadata.name,
                        "url": r.item.external_id,
                        "source": r.source_name,
                        "snippet": r.highlight,
                        "time": item_time(r.item),
                    }
                    for r in results
                ]
            )
        )
    else:
        for r in results:
            print(format_result(r, r.highlight))
    return results


# -- item commands -----------------------------------------------------------


def print_item(state, args) -> None:
    """(reference cmd/print.rs:16-56)"""
    item = state.db.read_item(int(args.item_id))
    if item is None:
        print(f"No item {args.item_id}", file=sys.stderr)
        return
    m = item.metadata
    print(f"id: {item.id}\nsource: {item.source_id}\nexternal_id: {item.external_id}")
    for k, v in (
        ("name", m.name), ("author", m.author), ("description", m.description),
        ("mtime", m.mtime), ("atime", m.atime), ("skipped", item.skipped),
        ("process_version", item.process_version),
    ):
        if v is not None:
            print(f"{k}: {v}")
    print("---")
    print(item.content or "")
    if args.raw and item.raw_content:
        print("--- raw ---")
        try:
            print(decompress_raw(item.raw_content).decode("utf-8", "replace"))
        except Exception as e:  # noqa: BLE001
            print(f"(raw decode failed: {e})")


def hide(state, args) -> None:
    """Hide or unhide; the reference parsed --unhide but always hid
    (cmd/hide.rs:11-16).  Hiding tombstones the item's rows in the device
    matrix; unhiding upserts every chunk row back."""
    item_id = int(args.item_id)
    unhide = getattr(args, "unhide", False)
    state.db.set_item_hidden(item_id, not unhide)
    if state.searcher is not None:
        if unhide:
            import numpy as np

            item = state.db.read_item(item_id)
            chunks = state.searcher.stored_embeddings(state.db, item_id)
            if item is not None and chunks:
                # restore EVERY chunk row, not just chunk 0 (a chunk-embedded
                # document must come back with all its vectors)
                keys = [(item_id, ci) for ci, _ in chunks]
                vecs = np.stack([v for _, v in chunks])
                state.searcher.upsert_embeddings(keys, [item.source_id] * len(keys), vecs)
        else:
            state.searcher.remove_items([item_id])
    print(("Unhid" if unhide else "Hid") + f" item {item_id}")


def tag_cmd(state, args) -> None:
    """Tag management: the reference created the tags tables but never used
    them (migrations/00002_tags.sql)."""
    from ..db import list_tags, tag_item, untag_item

    if args.tag_action == "add":
        tag_item(state.db, int(args.item_id), args.tag_name)
        print(f"Tagged item {args.item_id} with {args.tag_name!r}")
    elif args.tag_action == "rm":
        if untag_item(state.db, int(args.item_id), args.tag_name):
            print(f"Untagged item {args.item_id} from {args.tag_name!r}")
        else:
            print("no such tag on that item", file=sys.stderr)
    elif args.tag_action == "list":
        for tid, name, count in list_tags(state.db):
            print(f"{tid:4d}  {name:24s} {count} items")


# -- model -------------------------------------------------------------------


def model_cmd(state, args) -> None:
    if args.model_action == "list":
        current = state.model.name
        for mt in ModelType:
            marker = " *" if mt.value in current else ""
            print(f"{mt.model_id}: {mt.value}{marker}")
    elif args.model_action == "set":
        mt = ModelType.parse(args.model_name)
        with state.db.write() as conn:
            conn.execute(
                "INSERT INTO config (key, value) VALUES ('model', ?) "
                "ON CONFLICT (key) DO UPDATE SET value = excluded.value",
                (mt.value,),
            )
        print(
            f"Default model set to {mt.value} (id {mt.model_id}). "
            "Restart to load it; re-scan sources to embed under the new model."
        )
