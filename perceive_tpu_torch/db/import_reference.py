"""A copy of perceive_tpu/db/import_reference.py, so that the port imports
nothing of the JAX package (tests/test_torch_cli_commands.py holds the two
imports equal).

Import a reference (dimfeld/perceive) SQLite database.

Lets a reference user switch WITHOUT re-scanning or
re-embedding: the reference stores embeddings as little-endian f32 BLOBs
keyed (model_id, model_version, item_id)
(crates/perceive-core/migrations/00001_init.sql:64-72),
produced by the same sentence-transformers checkpoints this framework's
converter loads — so the vectors transfer verbatim into the same scoring
space.  Source configs are key-compatible too (``{"type": "fs", "globs":
[...]}`` / ``{"skip": [...]}``, sources.rs:33-41 serde snake_case), as are
compare_strategy strings and the status JSON.

Also accepts another perceive-tpu database (detects the extra
chunk_idx/seq columns and preserves chunk rows).

Ids are remapped: sources and items are inserted fresh and every
cross-reference (item_embeddings, item_tags) follows the old->new map, so
imports can land in a database that already has its own content.
"""

from __future__ import annotations

import sqlite3
from typing import Callable, Optional

import numpy as np

from .database import Database

# Stream embeddings to the device-matrix hook in batches of this many rows.
HOOK_BATCH = 2048

ITEM_COLS = (
    "source_id, external_id, version, hash, content, raw_content, "
    "process_version, name, author, description, modified, last_accessed, "
    "skipped, hidden_at"
)


def _columns(conn: sqlite3.Connection, table: str) -> set:
    return {r[1] for r in conn.execute(f"PRAGMA table_info({table})")}


def _unique_name(taken: set, name: str) -> str:
    """First free source name: ``name``, then ``name-imported``, ``-2``…

    ``taken`` is the caller-maintained set of names already in use (fetched
    once before the sources loop, updated as names are assigned — re-running
    the SELECT per source made the pass O(S^2))."""
    cand = name
    if cand in taken:
        cand = f"{name}-imported"
        i = 2
        while cand in taken:
            cand = f"{name}-imported-{i}"
            i += 1
    taken.add(cand)
    return cand


def import_reference_db(
    db: Database,
    path: str,
    on_embeddings: Optional[Callable] = None,
    hook_model: Optional[tuple] = None,
    hook_dim: Optional[int] = None,
) -> dict:
    """Copy sources, items, embeddings, and tags from ``path`` into ``db``.

    ``on_embeddings(keys, source_ids, vectors)`` — the same hook signature
    the scan pipeline uses — is invoked in batches for embedding rows whose
    (model_id, model_version) equals ``hook_model``, streaming the imported
    vectors straight into a live device matrix.  ``hook_dim`` guards the
    stream: BLOBs of any other dimensionality come from a different encoder
    that happens to share the numeric model id, and must not pollute the
    index (they still import into SQLite).  Returns a stats dict.
    """
    src = sqlite3.connect(f"file:{path}?mode=ro", uri=True)
    try:
        have = {r[0] for r in src.execute(
            "SELECT name FROM sqlite_master WHERE type='table'"
        )}
        for required in ("sources", "items", "item_embeddings"):
            if required not in have:
                raise ValueError(f"{path}: not a perceive database (no {required} table)")
        emb_cols = _columns(src, "item_embeddings")
        has_chunks = "chunk_idx" in emb_cols

        stats = {
            "sources": 0, "items": 0, "embeddings": 0, "tags": 0,
            "item_tags": 0, "streamed": 0, "dim_mismatch": 0,
        }
        source_map: dict[int, int] = {}
        item_map: dict[int, int] = {}
        item_source: dict[int, int] = {}
        # hook batches accumulate here and flush at the END of the
        # transaction, INSIDE it — the same invariant as the scan write
        # stage (pipeline.py): anything committed is already in the matrix,
        # so a snapshot recording MAX(seq) can never reference rows the
        # matrix is missing (post-commit streaming left a window
        # where a snapshot permanently hid the imported rows).  A failure
        # mid-stream rolls the import back; any partially-streamed vectors
        # are healed by the searcher's live-key reconcile on next build.
        hook_batches: list[tuple[list, list, np.ndarray]] = []

        with db.write() as conn:
            # -- sources (fresh ids; names de-conflicted) --
            taken_names = {r[0] for r in conn.execute("SELECT name FROM sources")}
            for row in src.execute(
                "SELECT id, name, config, location, compare_strategy, status,"
                " last_indexed, index_version, index_interval FROM sources"
            ):
                (old_id, name, config, location, compare, status,
                 last_indexed, index_version, index_interval) = row
                cur = conn.execute(
                    """INSERT INTO sources (name, config, location, compare_strategy,
                         status, last_indexed, index_version, index_interval)
                       VALUES (?,?,?,?,?,?,?,?)""",
                    (_unique_name(taken_names, name), config, location, compare,
                     status, last_indexed, index_version, index_interval),
                )
                source_map[old_id] = cur.lastrowid
                stats["sources"] += 1

            # -- items --
            for row in src.execute(f"SELECT id, {ITEM_COLS} FROM items"):
                old_id, old_source = row[0], row[1]
                new_source = source_map.get(old_source)
                if new_source is None:
                    continue  # orphaned row; FK would reject it anyway
                cur = conn.execute(
                    f"INSERT INTO items ({ITEM_COLS}) VALUES "
                    f"({','.join('?' * 14)})",
                    (new_source,) + tuple(row[2:]),
                )
                item_map[old_id] = cur.lastrowid
                skipped, hidden_at = row[13], row[14]
                if skipped is None and hidden_at is None:
                    # only live rows stream to the device matrix (the
                    # searcher's own build query excludes hidden/skipped)
                    item_source[cur.lastrowid] = new_source
                stats["items"] += 1

            # -- model_versions the embeddings reference (FK) --
            for mid, mver in src.execute(
                "SELECT DISTINCT model_id, model_version FROM item_embeddings"
            ):
                conn.execute(
                    "INSERT OR IGNORE INTO models (id, name, model_type, created_at)"
                    " VALUES (?,?,?,0)",
                    (mid, f"imported-{mid}", f"imported-{mid}"),
                )
                conn.execute(
                    "INSERT OR IGNORE INTO model_versions"
                    " (model_id, version, status, weights_filename, created_at)"
                    " VALUES (?,?, 'ready', '', 0)",
                    (mid, mver),
                )

            # -- embeddings (chunk_idx 0 for reference rows; fresh seq) --
            seq = conn.execute(
                "SELECT COALESCE(MAX(seq),0) FROM item_embeddings"
            ).fetchone()[0]
            chunk_sel = "chunk_idx" if has_chunks else "0"
            hook_keys: list[tuple[int, int]] = []
            hook_srcs: list[int] = []
            hook_vecs: list[np.ndarray] = []

            def flush_hook():
                if hook_keys and on_embeddings is not None:
                    hook_batches.append(
                        (list(hook_keys), list(hook_srcs),
                         np.stack(hook_vecs).astype(np.float32))
                    )
                hook_keys.clear(); hook_srcs.clear(); hook_vecs.clear()

            for row in src.execute(
                f"SELECT model_id, model_version, item_id, {chunk_sel},"
                " item_index_version, embedding FROM item_embeddings"
            ):
                mid, mver, old_item, chunk_idx, iiv, blob = row
                new_item = item_map.get(old_item)
                if new_item is None:
                    continue
                seq += 1
                conn.execute(
                    """INSERT OR REPLACE INTO item_embeddings
                         (model_id, model_version, item_id, chunk_idx,
                          item_index_version, embedding, seq)
                       VALUES (?,?,?,?,?,?,?)""",
                    (mid, mver, new_item, chunk_idx, iiv, blob, seq),
                )
                stats["embeddings"] += 1
                if (
                    on_embeddings is not None
                    and (mid, mver) == hook_model
                    and new_item in item_source
                ):
                    if hook_dim is not None and len(blob) != 4 * hook_dim:
                        stats["dim_mismatch"] += 1
                        continue
                    hook_keys.append((new_item, chunk_idx))
                    hook_srcs.append(item_source[new_item])
                    hook_vecs.append(np.frombuffer(blob, dtype="<f4"))
                    if len(hook_keys) >= HOOK_BATCH:
                        flush_hook()
            flush_hook()

            # -- tags (merge by name) + item_tags --
            if "tags" in have:
                tag_map: dict[int, int] = {}
                for old_id, name, desc, color in src.execute(
                    "SELECT id, name, description, color FROM tags"
                ):
                    existing = conn.execute(
                        "SELECT id FROM tags WHERE name = ?", (name,)
                    ).fetchone()
                    if existing:
                        tag_map[old_id] = existing[0]
                    else:
                        cur = conn.execute(
                            "INSERT INTO tags (name, description, color) VALUES (?,?,?)",
                            (name, desc, color),
                        )
                        tag_map[old_id] = cur.lastrowid
                        stats["tags"] += 1
                for old_item, old_tag in src.execute(
                    "SELECT item_id, tag_id FROM item_tags"
                ):
                    new_item, new_tag = item_map.get(old_item), tag_map.get(old_tag)
                    if new_item is None or new_tag is None:
                        continue
                    conn.execute(
                        "INSERT OR IGNORE INTO item_tags (item_id, tag_id) VALUES (?,?)",
                        (new_item, new_tag),
                    )
                    stats["item_tags"] += 1
            # stream vectors into the live matrix INSIDE the transaction
            # (see hook_batches comment): commit implies matrix-present
            for keys, srcs, vecs in hook_batches:
                on_embeddings(keys, srcs, vecs)
                stats["streamed"] += len(keys)
        # txn closed: run any deferred index maintenance (retier/audit must
        # never hold the DB write lock — Searcher.pipeline_hooks contract)
        after_commit = getattr(on_embeddings, "after_commit", None)
        if after_commit is not None:
            after_commit()
        return stats
    finally:
        src.close()
