"""CLI command handlers: the ``source`` commands, ``refresh`` and ``search``
of perceive_tpu/cli/commands.py.

Fixes over the reference are the JAX package's: working `refresh`
(cmd.rs:31 stub) and `source edit` (cmd/source.rs:114 stub).
"""

from __future__ import annotations

import json
import sys
import threading
import time
from typing import Optional

from ..db import add_source, get_source, update_source, update_source_status
from ..index.searcher import SearchResult
from ..sources import ScanStats, prune_missing_items, scan_source
from ..sources.reprocess import reprocess_source
from ..types import ItemCompareStrategy, Source, SourceStatus

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


def _run_scan(state, src: Source, compare_strategy: Optional[ItemCompareStrategy], prune: bool):
    """Bump index_version, Indexing -> scan -> Ready (cmd/source.rs:237-314).
    The searcher updates incrementally through on_embeddings instead of the
    reference's full per-source HNSW rebuild."""
    src.index_version += 1
    src.status = SourceStatus.indexing(int(time.time()))
    # status/version-only write: updating the FULL row here would revert a
    # concurrent `source edit` from another process with this process's
    # stale copy (the error and success paths already re-read
    # before writing for exactly this reason)
    update_source_status(state.db, src.id, src.status, index_version=src.index_version)

    stats = ScanStats()
    stop = threading.Event()
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
            print(
                f"skipping prune: {stats.embed_failed.value} items failed to embed this scan",
                file=sys.stderr,
            )
        else:
            removed = prune_missing_items(state.db, src)
            if state.searcher and removed:
                state.searcher.remove_items(removed)
            if removed:
                print(f"Pruned {len(removed)} vanished items")

    s = stats.summary()
    print(
        f"Finished in {duration} seconds: {s['scanned']} scanned, {s['added']} new, "
        f"{s['changed']} changed, {s['unchanged']} unchanged "
        f"(scan {s['scan_time']}s read {s['read_time']}s encode {s['encode_time']}s "
        f"write {s['write_time']}s)"
    )
    # no _autosave_snapshot(state) here as in the JAX package: the port has no snapshots yet
    return ok


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


def _due_sources(state) -> list[Source]:
    """Sources whose index_interval has elapsed since last_indexed.

    Uses the schema's index_interval column (present but unused in the
    reference, 00001_init.sql); sources without an interval are always due.
    """
    now = int(time.time())
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


def item_time(item) -> Optional[int]:
    """The item's mtime, falling back to its atime (None when neither)."""
    m = item.metadata
    return m.mtime if m.mtime is not None else m.atime


def _resolve_source_filter(state, args) -> Optional[list[int]]:
    """--source NAME -> [source id]; None for no filter."""
    if not getattr(args, "source", None):
        return None
    src = state.source_by_name(args.source)
    if src is None:
        raise SystemExit(f"No source named {args.source}")
    return [src.id]


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
    hl_q = None  # highlight-model query embedding, from the fused search
    if getattr(args, "like", None):
        vec = state.searcher.stored_embedding(state.db, int(args.like))
        if vec is None:
            raise SystemExit(f"item {args.like} has no stored embedding")
        results = state.searcher.search_vector_and_retrieve(state.db, vec, k, source_ids)
    else:
        query = " ".join(args.query)
        if not query:
            raise SystemExit("search needs a query or --like <item-id>")
        hits, hl_q = state.searcher.search_fused(
            state.model, query, k, source_ids, aux_model=state.highlights_model
        )
        results = state.searcher.retrieve(state.db, hits)
    results = results[:k]

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
