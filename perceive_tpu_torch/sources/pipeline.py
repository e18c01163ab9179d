"""The 5-stage ingest pipeline: scan -> match -> read -> device embed -> write.

Port of perceive_tpu/sources/pipeline.py; the stored bytes are the JAX
package's (``serialize_embedding`` BLOBs, ``seq`` numbered from MAX(seq),
chunk keys item_id * 4096 + chunk_idx).  On a CUDA model the embed stage
runs the encoder on the card, and every batch whose sequence bucket is at
least ``ops.attention.KERNEL_MIN_SEQ`` launches the attention kernel
(``csrc/attention.cu``).

Host feeder with the same stage/queue/backpressure structure as the reference
(crates/perceive-core/sources/pipeline/import.rs:12-116):
bounded queues between stages so a slow stage throttles the ones above it.
The embed stage is the device boundary and differs by design:

  * batches are large (default 1024 vs the reference's 64,
    pipeline.rs:76) and padded to bucket shapes, as in the JAX package;
  * encodes are double-buffered — batch i+1 tokenizes on the host while
    batch i runs on the card (Model.encode_dispatch / materialize), which
    replaces the reference's single-threaded model worker channel
    (model.rs:161-190) with the device queue itself;
  * an embed failure poisons only its batch (new items written without
    embeddings and changed items left at their previous row, both
    re-embedded next scan), not the whole scan — the reference
    aborted the stage (calculate_embeddings.rs error path).

Stage-death safety: every stage wrapper drains its input on error so bounded
queues never deadlock the remaining stages.
"""

from __future__ import annotations

import os
import queue
import sys
import threading
import traceback
from typing import Callable, Optional, Sequence

import numpy as np

from ..db import Database, json_ids
from ..index.matrix import serialize_embedding
from ..types import Item, ItemCompareStrategy, SkipReason, Source
from ..utils import BatchSender, dispatchmeter
from .scanner import (
    FoundItem,
    ReadResult,
    ScanItem,
    ScanItemState,
    ScanStats,
    SourceScanner,
    create_scanner,
)

SCAN_BATCH_SIZE = 64  # items per scanner batch (reference fs.rs:116)


def _env_int(name: str, default: int) -> int:
    """Int env var; a non-numeric typo falls back to the default instead of
    crashing module import / a mid-scan stage."""
    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        print(f"{name} is not an integer; using {default}", file=sys.stderr)
        return default


# Device batch (the reference used 64, pipeline.rs:76).  The default and the
# env name are inherited from the JAX package and not yet measured on the
# card; env-tunable for ops, clamped to the model dispatch limit so a typo
# can't poison every batch.
EMBED_BATCH_SIZE = min(max(1, _env_int("PERCEIVE_TPU_EMBED_BATCH", 1024)), 1024)
READ_PARALLELISM = 8  # reference import.rs:60
MATCH_QUEUE = 256
EMBED_QUEUE_BATCHES = 8
# hard cap on chunk windows per document: chunk_idx lives in a
# CHUNK_STRIDE=4096 keyspace inside the matrix chunk key (index/matrix.py)
MAX_CHUNKS_PER_DOC = 4096

_SENTINEL = None


def _drain_queue(q: queue.Queue):
    while True:
        v = q.get()
        if v is _SENTINEL:
            # mark on the queue itself: a stage that fails AFTER its main
            # loop consumed the sentinel (e.g. the embed stage's final
            # flush) must NOT re-drain — the error-path drain would block
            # forever on a queue nobody will ever put to again
            q.sentinel_seen = True
            return
        yield v


class _Stage(threading.Thread):
    """Runs ``fn``; on error, logs, flags, and drains ``in_q`` so upstream
    producers never block forever (reference pipeline.rs:133-158 logged and
    aborted; we additionally keep the pipe flowing)."""

    def __init__(self, name: str, fn: Callable[[], None], in_q: Optional[queue.Queue], errors: list):
        super().__init__(name=name, daemon=True)
        self._fn = fn
        self._in_q = in_q
        self._errors = errors
        # the scan's dispatch attribution (serve's background refresh)
        # follows it into its stage threads
        self._site = dispatchmeter.current_site()

    def run(self) -> None:
        try:
            with dispatchmeter.attributed(self._site):
                self._fn()
        except Exception as e:  # noqa: BLE001 — stage isolation boundary
            print(f"stage {self.name} failed: {e}", file=sys.stderr)
            traceback.print_exc()
            self._errors.append((self.name, e))
            if self._in_q is not None and not getattr(
                self._in_q, "sentinel_seen", False
            ):
                for _ in _drain_queue(self._in_q):
                    pass


# -- stage 2: match against existing rows ------------------------------------


def _match_stage(
    db: Database,
    model_id: int,
    model_version: int,
    source_id: int,
    compare_strategy: ItemCompareStrategy,
    in_q: queue.Queue,
    out_q: queue.Queue,
) -> None:
    """Batch SQL lookup + New/Changed/Found/Unchanged classification
    (reference match_existing_items.rs:9-112; decision table :81-96)."""
    compare_mtime = compare_strategy.should_compare_mtime
    mtime_sufficient = compare_strategy is ItemCompareStrategy.MTIME
    want_content = compare_strategy.should_compare_content
    # Even when the strategy doesn't compare content, rows MISSING a vector
    # for the active model need their stored content loaded: the web
    # connectors' read gate re-embeds from it without a re-fetch
    # (chromium_history._stale_read_check), and with '' there the item
    # would be downgraded UNCHANGED and never indexed under a new model.
    content_col = (
        "content" if want_content else "CASE WHEN ie.item_id IS NULL THEN content ELSE '' END"
    )
    conn = db.read()
    sql = f"""
        SELECT external_id, id, hash, modified, last_accessed, skipped,
               {content_col}, ie.item_id IS NOT NULL
        FROM items
        LEFT JOIN item_embeddings ie ON ie.item_id = items.id
          AND ie.model_id = ? AND ie.model_version = ? AND ie.chunk_idx = 0
        WHERE source_id = ? AND external_id IN (SELECT value FROM json_each(?))
    """

    for batch in _drain_queue(in_q):
        rows = conn.execute(
            sql, (model_id, model_version, source_id, json_ids(i.external_id for i in batch))
        ).fetchall()
        found = {
            r[0]: (
                r[1],
                FoundItem(
                    hash=r[2] or "",
                    modified=r[3],
                    last_accessed=r[4],
                    skipped=SkipReason.parse(r[5]),
                    content=r[6] or "",
                    has_embedding=bool(r[7]),
                ),
            )
            for r in rows
        }
        for item in batch:
            hit = found.pop(item.external_id, None)
            if hit is None:
                out_q.put(ScanItem(state=ScanItemState.NEW, item=item))
                continue
            row_id, existing = hit
            same_time = None
            if compare_mtime and item.metadata.mtime is not None and existing.modified is not None:
                same_time = item.metadata.mtime == existing.modified
            force = compare_strategy is ItemCompareStrategy.FORCE or not existing.has_embedding
            if force:
                state = ScanItemState.CHANGED
            elif same_time is False:
                state = ScanItemState.CHANGED
            elif same_time is True:
                state = ScanItemState.UNCHANGED if mtime_sufficient else ScanItemState.FOUND
            else:  # no mtime info or not comparing mtime
                state = ScanItemState.FOUND
            item.id = row_id
            out_q.put(ScanItem(state=state, item=item, existing=existing))


# -- stage 3: read content ---------------------------------------------------


def _read_stage(
    stats: ScanStats,
    compare_strategy: ItemCompareStrategy,
    scanner: SourceScanner,
    in_q: queue.Queue,
    out_q: queue.Queue,
) -> None:
    """(reference read_items.rs:6-70)

    The ``out_q.put`` calls sit OUTSIDE the read_time window: under embed
    backpressure they block on queue space, and billing that wait to "read"
    misattributes the scan wall (a bench run measured read_time 6.06 s of a
    7.14 s wall while the actual read work cost ~0.6 s — the stage was
    waiting on the device, not reading).  read_time now means time spent
    fetching/parsing content, matching encode_time/write_time semantics.
    """
    for si in _drain_queue(in_q):
        if si.state is ScanItemState.UNCHANGED:
            out_q.put(si)  # pure passthrough: no read work to bill
            continue
        forward = False
        with stats.read_time.track():
            stats.reading.add()
            try:
                result = scanner.read(si.existing, compare_strategy, si.item)
            except Exception as e:  # noqa: BLE001 — per-item isolation
                print(f"{si.item.external_id}: {e}", file=sys.stderr)
                result = None
                if si.item.id >= 0:
                    # existing row: forward UNCHANGED so its version is
                    # bumped — dropping it here would make prune_missing_items
                    # delete a live item after a transient read error
                    si.state = ScanItemState.UNCHANGED
                    if si.existing is not None and si.existing.last_accessed is not None:
                        # keep the STORED access time: stamping the fresh
                        # visit time would make the web connectors'
                        # freshness gate treat the FAILED fetch as done and
                        # never retry it until the next user visit
                        si.item.metadata.atime = si.existing.last_accessed
                    forward = True
            finally:
                stats.reading.sub()
                stats.fetched.add()

            if result is not None and result is not ReadResult.OMIT:
                state = ScanItemState.UNCHANGED if result is ReadResult.UNCHANGED else si.state

                if state is ScanItemState.FOUND:
                    # settle changed-ness by content comparison
                    if si.existing is None:
                        state = ScanItemState.NEW
                    elif si.item.skipped is not None:
                        # a skip discovered at read time (404, non-text, ...)
                        # must PERSIST: classifying UNCHANGED would drop the
                        # skip on the floor and leave stale vectors searchable
                        # (the write stage's skip branch needs != UNCHANGED)
                        state = ScanItemState.CHANGED
                    elif (
                        compare_strategy.should_compare_content
                        and si.existing.content != (si.item.content or "")
                    ):
                        state = ScanItemState.CHANGED
                    else:
                        state = ScanItemState.UNCHANGED
                si.state = state
                forward = True
        if forward:
            out_q.put(si)


# -- stage 4: device embed ---------------------------------------------------


def build_document(item: Item) -> Optional[str]:
    """Document text = name + description + content, newline-joined, skipping
    blanks (reference calculate_embeddings.rs:55-74)."""
    meta = item.metadata
    if meta.name is None and meta.description is None:
        doc = (item.content or "").strip()
        return doc or None
    parts = [p for p in (meta.name, meta.description, item.content) if p and p.strip()]
    doc = "\n".join(parts)
    return doc or None


def chunk_token_windows_batch(
    tokenizer, texts: Sequence[str], chunk_tokens: int, overlap: int
) -> list[list[list[int]]]:
    """Split documents into overlapping chunk_tokens-sized token-id windows
    (one window list per document), tokenizing the whole batch in ONE
    tokenizer call.

    The long-context strategy: instead of the
    reference's head-truncation at max_seq_length (model/tokenize.rs:64-71),
    every chunk is embedded and indexed, so matches deep in long documents
    are findable.  Each document is tokenized exactly ONCE: windows are id
    slices of the untruncated encoding (specials excluded), re-wrapped with
    the model's special tokens at dispatch (tokenize.pack_token_windows) —
    never re-tokenized text, so chunk boundaries are token-exact.  Batch
    tokenization matters because the host tokenizer's CPU time bounds
    ingest throughput.
    """
    # clamp to what the model can actually encode after the special-token
    # wrap — a chunk_tokens at or above max_seq_length would otherwise have
    # its tail silently dropped by pack_token_windows, breaking the overlap
    # scheme's full-coverage guarantee (tokenize.pack_token_windows).  The
    # overlap clamps to HALF the (possibly clamped) window: a configured
    # overlap >= the clamped window would collapse the stride to 1 and emit
    # one window per token (~450x the embed work, silently).
    chunk_tokens = min(chunk_tokens, tokenizer.wrap_budget)
    overlap = min(overlap, chunk_tokens // 2)
    step = max(chunk_tokens - overlap, 1)
    out: list[list[list[int]]] = []
    # fast=True: this path reads only ids + special mask (no offsets)
    for enc in tokenizer.encode_untruncated(list(texts), fast=True):
        ids = [i for i, m in zip(enc.ids, enc.special_tokens_mask) if not m]
        if len(ids) <= chunk_tokens:
            out.append([ids])
            continue
        windows = []
        start = 0
        while start < len(ids):
            windows.append(ids[start : start + chunk_tokens])
            if len(windows) >= MAX_CHUNKS_PER_DOC:
                # chunk_idx must stay below the CHUNK_STRIDE keyspace
                # (matrix chunk keys are item_id * 4096 + chunk_idx); a
                # pathological multi-megabyte document indexes its first
                # ~2M tokens rather than corrupting the NEXT item's rows
                break
            if start + chunk_tokens >= len(ids):
                break
            start += step
        out.append(windows)
    return out


def chunk_token_windows(
    tokenizer, text: str, chunk_tokens: int, overlap: int
) -> list[list[int]]:
    """Single-document convenience wrapper over chunk_token_windows_batch."""
    return chunk_token_windows_batch(tokenizer, [text], chunk_tokens, overlap)[0]


class _PendingItem:
    """Chunks of one item in flight across device batches."""

    __slots__ = ("si", "expected", "chunks")

    def __init__(self, si: ScanItem, expected: int):
        self.si = si
        self.expected = expected
        self.chunks: list = []


def _embed_stage(
    stats: ScanStats,
    model,
    in_q: queue.Queue,
    out_q: queue.Queue,
    batch_size: int,
    chunk_tokens: int = 0,
    chunk_overlap: int = 0,
) -> None:
    """Double-buffered device encode (reference calculate_embeddings.rs:38-100
    restructured for async dispatch).  With chunk_tokens > 0 each document
    becomes one entry per chunk; an item is released downstream only when all
    its chunk vectors have materialized."""
    buf: list[tuple[_PendingItem, int]] = []
    texts: list[str] = []
    # in-flight dispatches: depth 1 = classic double buffering (dispatch
    # batch i+1, then materialize batch i).  The default of 1 is inherited
    # from the JAX package and not yet measured on the card.
    pending: list = []
    PIPELINE_DEPTH = max(1, _env_int("PERCEIVE_TPU_PIPELINE_DEPTH", 1))
    # passthrough items batch up so the write stage isn't fed one-item
    # transactions during mostly-unchanged rescans
    passthrough: list = []

    def release(done: list):
        passthrough.extend(done)
        if len(passthrough) >= SCAN_BATCH_SIZE:
            flush_passthrough()

    def flush_passthrough():
        nonlocal passthrough
        if passthrough:
            out_q.put(passthrough)
            passthrough = []

    def collect(entries, embs) -> None:
        done = []
        by_item: dict[int, _PendingItem] = {}
        for (pi, ci), emb in zip(entries, [None] * len(entries) if embs is None else embs):
            pi.chunks.append((ci, None if embs is None else emb))
            by_item[id(pi)] = pi
        for pi in by_item.values():
            if len(pi.chunks) == pi.expected:
                if any(e is None for _, e in pi.chunks):
                    stats.embed_failed.add(1)
                    done.append((pi.si, None))  # batch failure poisons the item
                else:
                    pi.chunks.sort(key=lambda t: t[0])
                    stats.encoded.add(1)
                    done.append((pi.si, pi.chunks))
        release(done)

    def materialize(p):
        dispatched, entries = p
        with stats.encode_time.track():
            try:
                embs = model.materialize(dispatched)
            except Exception as e:  # noqa: BLE001 — batch isolation
                print(f"embed batch failed: {e}", file=sys.stderr)
                embs = None
        stats.embedding.sub(len(entries))
        collect(entries, embs)

    def dispatch():
        nonlocal buf, texts
        entries, batch_texts = buf, texts
        buf, texts = [], []
        stats.embedding.add(len(entries))
        with stats.encode_time.track():
            try:
                if chunk_tokens > 0:  # entries are token-id windows
                    d = model.encode_dispatch_token_windows(batch_texts)
                else:
                    d = model.encode_dispatch(batch_texts)
            except Exception as e:  # noqa: BLE001
                print(f"embed dispatch failed: {e}", file=sys.stderr)
                stats.embedding.sub(len(entries))
                collect(entries, None)
                return
        pending.append((d, entries))
        if len(pending) > PIPELINE_DEPTH:
            materialize(pending.pop(0))

    def enqueue_parts(si, parts):
        pi = _PendingItem(si, len(parts))
        for ci, part in enumerate(parts):
            buf.append((pi, ci))
            texts.append(part)
            if len(buf) >= batch_size:
                dispatch()

    # documents awaiting chunk-window tokenization batch up so the (single-
    # core) host tokenizes TOK_BATCH docs per tokenizer call instead of one
    tok_buf: list = []
    TOK_BATCH = 64

    def flush_tok():
        nonlocal tok_buf
        if not tok_buf:
            return
        pending_docs, tok_buf = tok_buf, []
        windows = chunk_token_windows_batch(
            model.tokenizer, [d for _, d in pending_docs], chunk_tokens, chunk_overlap
        )
        for (si, _), parts in zip(pending_docs, windows):
            enqueue_parts(si, parts)

    for si in _drain_queue(in_q):
        if (
            si.state in (ScanItemState.UNCHANGED, ScanItemState.FOUND)
            or si.item.skipped is not None
        ):
            release([(si, None)])
            continue
        doc = build_document(si.item)
        if doc is None:
            # changed/new item with no document text: [] clears any stored
            # embeddings (None means "embed failed, keep what exists")
            release([(si, [])])
            continue
        if chunk_tokens > 0:
            tok_buf.append((si, doc))
            if len(tok_buf) >= TOK_BATCH:
                flush_tok()
        else:
            enqueue_parts(si, [doc])
    flush_tok()
    if buf:
        dispatch()
    while pending:
        materialize(pending.pop(0))
    flush_passthrough()


# -- stage 5: write ----------------------------------------------------------


def _write_stage(
    stats: ScanStats,
    db: Database,
    model_id: int,
    model_version: int,
    index_version: int,
    in_q: queue.Queue,
    on_embeddings: Optional[Callable],
    on_removed: Optional[Callable] = None,
) -> None:
    """Single writer, one transaction per batch (reference update_db.rs:8-139).
    ``on_embeddings`` receives (keys, source_ids, vectors) after each commit
    — keys are (item_id, chunk_idx) pairs — the incremental device-matrix
    update hook the HNSW never had.

    Hooks carrying an ``after_commit`` attribute (Searcher.pipeline_hooks)
    get it invoked once per batch AFTER the transaction closes: expensive
    index maintenance (retier restage, coarse audit) must never run while
    the DB write lock is held."""
    after_commit = [
        ac
        for ac in {
            getattr(h, "after_commit", None) for h in (on_embeddings, on_removed)
        }
        if ac is not None
    ]
    for batch in _drain_queue(in_q):
        with stats.write_time.track(), db.write() as conn:
            new = changed = unchanged = 0
            dev_ids: list[tuple[int, int]] = []
            dev_srcs: list[int] = []
            dev_vecs: list[np.ndarray] = []
            removed_ids: list[int] = []
            # single-writer discipline makes the seq counter safe to assign
            # host-side; one MAX() per batch replaces a correlated subquery
            # per embedding row
            seq_base = conn.execute(
                "SELECT COALESCE(MAX(seq),0) FROM item_embeddings"
            ).fetchone()[0]
            emb_rows: list[tuple] = []
            for si, embs in batch:
                item = si.item
                meta = item.metadata
                if (
                    embs is None
                    and si.state is ScanItemState.CHANGED
                    and item.skipped is None
                ):
                    # embed FAILED for a changed document (None = poisoned
                    # batch; unchanged/skipped passthroughs are also None but
                    # never CHANGED).  Writing the new content/mtime here
                    # would make the next scan classify it UNCHANGED with the
                    # STALE pre-change vector pinned forever; skipping the
                    # write keeps row+vector consistently old and the change
                    # re-detected (and re-embedded) on the next scan.
                    continue
                if si.state is ScanItemState.UNCHANGED:
                    conn.execute(
                        "UPDATE items SET version = ?, last_accessed = ? WHERE id = ?",
                        (index_version, meta.atime, item.id),
                    )
                    unchanged += 1
                    item_id = item.id
                elif si.state is ScanItemState.NEW:
                    cur = conn.execute(
                        """INSERT INTO items (source_id, external_id, version, hash,
                             content, raw_content, process_version, name, author,
                             description, modified, last_accessed, skipped)
                           VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?)""",
                        (
                            item.source_id,
                            item.external_id,
                            index_version,
                            item.hash or "",
                            item.content or "",
                            item.raw_content,
                            item.process_version,
                            meta.name,
                            meta.author,
                            meta.description,
                            meta.mtime,
                            meta.atime,
                            str(item.skipped) if item.skipped else None,
                        ),
                    )
                    item.id = item_id = cur.lastrowid
                    new += 1
                else:  # FOUND or CHANGED: full row update
                    conn.execute(
                        """UPDATE items SET version=?, hash=?, content=?,
                             raw_content=?, process_version=?, name=?, author=?,
                             description=?, modified=?, last_accessed=?, skipped=?
                           WHERE id=?""",
                        (
                            index_version,
                            item.hash or "",
                            item.content or "",
                            item.raw_content,
                            item.process_version,
                            meta.name,
                            meta.author,
                            meta.description,
                            meta.mtime,
                            meta.atime,
                            str(item.skipped) if item.skipped else None,
                            item.id,
                        ),
                    )
                    changed += 1
                    item_id = item.id
                if embs is not None:
                    for chunk_idx, emb in embs:
                        seq_base += 1
                        emb_rows.append(
                            (item_id, chunk_idx, index_version,
                             serialize_embedding(emb), model_id, model_version,
                             seq_base)
                        )
                        dev_ids.append((item_id, chunk_idx))
                        dev_srcs.append(item.source_id)
                        dev_vecs.append(np.asarray(emb, dtype=np.float32))
                    # drop stale chunk rows past the new count (doc shrank;
                    # len 0 = document became empty, all rows go).  Freshly
                    # inserted items can have no stale rows to drop.
                    if si.state is not ScanItemState.NEW:
                        conn.execute(
                            """DELETE FROM item_embeddings
                               WHERE item_id=? AND model_id=? AND model_version=?
                                 AND chunk_idx >= ?""",
                            (item_id, model_id, model_version, len(embs)),
                        )
                    if not embs:
                        removed_ids.append(item_id)
                if si.state is not ScanItemState.UNCHANGED and item.skipped is not None:
                    # item became skipped: its old vectors must leave the index
                    conn.execute(
                        """DELETE FROM item_embeddings
                           WHERE item_id=? AND model_id=? AND model_version=?""",
                        (item_id, model_id, model_version),
                    )
                    removed_ids.append(item_id)
            if emb_rows:
                conn.executemany(
                    """INSERT INTO item_embeddings
                         (item_id, chunk_idx, item_index_version, embedding,
                          model_id, model_version, seq)
                       VALUES (?,?,?,?,?,?,?)
                       ON CONFLICT (item_id, chunk_idx, model_id, model_version)
                       DO UPDATE
                         SET item_index_version=excluded.item_index_version,
                             embedding=excluded.embedding,
                             seq=excluded.seq""",
                    emb_rows,
                )
            # device hooks INSIDE the transaction: anything committed is
            # already in the matrix, so snapshots recording MAX(seq) can
            # never reference rows the matrix is missing
            if on_embeddings is not None and dev_ids:
                # HIDDEN items keep their DB rows current (unhide restores
                # from them) but must NOT re-enter the live matrix — a
                # rescan/reprocess would otherwise undo `hide` until the
                # next restart (match/reprocess SQL doesn't filter
                # hidden_at; the matrix build does, searcher.py:301)
                hidden = {
                    r[0]
                    for r in conn.execute(
                        """SELECT id FROM items WHERE hidden_at IS NOT NULL
                           AND id IN (SELECT value FROM json_each(?))""",
                        (json_ids({k[0] for k in dev_ids}),),
                    )
                }
                if hidden:
                    kept = [i for i, k in enumerate(dev_ids) if k[0] not in hidden]
                    dev_ids = [dev_ids[i] for i in kept]
                    dev_srcs = [dev_srcs[i] for i in kept]
                    dev_vecs = [dev_vecs[i] for i in kept]
            if on_embeddings is not None and dev_ids:
                on_embeddings(dev_ids, dev_srcs, np.stack(dev_vecs))
            if on_removed is not None and removed_ids:
                on_removed(removed_ids)
        for ac in after_commit:  # txn closed: run deferred maintenance
            ac()
        stats.added.add(new)
        stats.changed.add(changed)
        stats.unchanged.add(unchanged)


def chunk_config(source: Source, tokenizer=None) -> tuple[int, int]:
    """(chunk_tokens, chunk_overlap) from the source config.

    Default (no ``chunk_tokens`` key): chunk-embed at the model's wrap
    budget, so documents longer than max_seq_length index EVERY window
    instead of just the head (on by default).  An explicit
    ``chunk_tokens: 0`` opts back into the reference's
    head-truncation (model/tokenize.rs:64-71); any other value is clamped to
    the wrap budget at window time (chunk_token_windows)."""
    raw = source.config.get("chunk_tokens")
    if raw is None and tokenizer is not None:
        ct = tokenizer.wrap_budget
    else:
        ct = int(raw or 0)
    co = int(source.config.get("chunk_overlap", ct // 8) or 0) if ct else 0
    return ct, co


# -- orchestration -----------------------------------------------------------


def scan_source(
    db: Database,
    model,
    source: Source,
    *,
    stats: Optional[ScanStats] = None,
    compare_strategy: Optional[ItemCompareStrategy] = None,
    scanner: Optional[SourceScanner] = None,
    on_embeddings: Optional[Callable] = None,
    on_removed: Optional[Callable] = None,
    embed_batch_size: int = EMBED_BATCH_SIZE,
) -> tuple[ScanStats, bool]:
    """Run the full scan pipeline for one source (reference import.rs:12-116).

    Returns (stats, ok).  ``on_embeddings(keys, source_ids, vectors)`` fires
    inside each write transaction for live device-matrix updates;
    ``on_removed(item_ids)`` fires for items whose vectors left the index
    (document emptied or became skipped).
    """
    stats = stats or ScanStats()
    scanner = scanner or create_scanner(source)
    strategy = compare_strategy or source.compare_strategy
    # non-zero model versions (upgrades, the random-fallback reserved
    # version) must exist in model_versions before the write stage inserts
    # embeddings, or the FK kills every transaction
    db.ensure_model_version(model.model_id, model.model_version)
    from ..models.model import BATCH_BUCKETS

    # clamp to the device dispatch limit; an explicit argument deliberately
    # overrides the PERCEIVE_TPU_EMBED_BATCH env default
    embed_batch_size = min(embed_batch_size, BATCH_BUCKETS[-1])
    errors: list = []

    q_items: queue.Queue = queue.Queue(MATCH_QUEUE)  # backpressure on the scanner too
    q_matched: queue.Queue = queue.Queue(MATCH_QUEUE)
    q_content: queue.Queue = queue.Queue(embed_batch_size)
    q_embedded: queue.Queue = queue.Queue(EMBED_QUEUE_BATCHES)

    def scan_fn():
        class _UntrackedPutQueue:
            """Queue facade whose put() pauses scan_time: blocking on
            downstream queue space is backpressure wait, not scan work
            (same attribution rule as _read_stage's out_q.put).  The lock
            serializes the end/begin pair — today emit is single-threaded,
            but BatchSender supports concurrent adds and an interleaved
            pair would drive the tracker's active count negative."""

            _plock = threading.Lock()

            def put(self, batch):
                with self._plock:
                    stats.scan_time.end()
                    try:
                        q_items.put(batch)
                    finally:
                        stats.scan_time.begin()

        with stats.scan_time.track():
            sender: BatchSender[Item] = BatchSender(_UntrackedPutQueue(), SCAN_BATCH_SIZE)

            def emit(item: Item) -> None:
                stats.scanned.add()
                sender.add(item)

            try:
                scanner.scan(emit)
            finally:
                sender.close()

    t_scan = _Stage("scanner", scan_fn, None, errors)
    t_match = _Stage(
        "match_existing",
        lambda: _match_stage(
            db, model.model_id, model.model_version, source.id, strategy, q_items, q_matched
        ),
        q_items,
        errors,
    )
    readers = [
        _Stage(
            f"read_items_{i}",
            lambda: _read_stage(stats, strategy, scanner, q_matched, q_content),
            q_matched,
            errors,
        )
        for i in range(READ_PARALLELISM)
    ]
    chunk_tokens, chunk_overlap = chunk_config(source, model.tokenizer)
    t_embed = _Stage(
        "embed",
        lambda: _embed_stage(
            stats, model, q_content, q_embedded, embed_batch_size,
            chunk_tokens, chunk_overlap,
        ),
        q_content,
        errors,
    )
    t_write = _Stage(
        "update_db",
        lambda: _write_stage(
            stats,
            db,
            model.model_id,
            model.model_version,
            source.index_version,
            q_embedded,
            on_embeddings,
            on_removed,
        ),
        q_embedded,
        errors,
    )

    for t in (t_scan, t_match, *readers, t_embed, t_write):
        t.start()
    t_scan.join()
    q_items.put(_SENTINEL)
    t_match.join()
    for _ in readers:
        q_matched.put(_SENTINEL)  # one per reader; each consumes exactly one
    for r in readers:
        r.join()
    q_content.put(_SENTINEL)
    t_embed.join()
    q_embedded.put(_SENTINEL)
    t_write.join()

    return stats, not errors


def prune_missing_items(db: Database, source: Source) -> list[int]:
    """Delete items of ``source`` whose version was not bumped to the current
    index_version (they vanished from the source).  The reference left this
    as a TODO (import.rs:110-114); here it is an explicit opt-in step whose
    removed ids are also evicted from the device matrix by the caller.
    """
    rows = db.read().execute(
        "SELECT id FROM items WHERE source_id = ? AND version < ?",
        (source.id, source.index_version),
    ).fetchall()
    ids = [r[0] for r in rows]
    if ids:
        with db.write() as conn:
            conn.execute(
                "DELETE FROM items WHERE id IN (SELECT value FROM json_each(?))",
                (json_ids(ids),),
            )
    return ids
