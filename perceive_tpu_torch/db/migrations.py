"""A copy of perceive_tpu/db/migrations.py, so that the port imports nothing of the JAX
package (tests/test_torch_db.py holds the two schemas equal).

SQLite schema migrations.

Logical schema matches the reference (crates/perceive-core/
migrations/00001_init.sql:1-90, 00002_tags.sql, 00003_model_7.sql): tables
config, models, model_versions, sources, items, item_embeddings, tags,
item_tags.  Embeddings are stored as little-endian f32 BLOBs keyed by
(model_id, model_version, item_id).

One deliberate fix: the reference's seed rows for `models` disagree with the
ids its own code uses to key embeddings (configs.rs `model_id()` maps
AllMiniLmL6V2->0, MsMarcoDistilbertDotV5->5, while 00001_init.sql seeds
0='AllMiniLmL12V2', 5='MsMarcoDistilbertBaseV4').  We seed `models` with the
`model_id()` mapping, which is what actually keys `item_embeddings` rows.

Migration 4 is ours: a `vector_shards` snapshot-manifest table so the
device-matrix loader can memory-map a previously built bf16/int8 matrix
instead of rescanning every embedding BLOB at startup.
"""

from __future__ import annotations

import sqlite3

MIGRATIONS: list[str] = [
    # -- 1: init (schema parity with reference 00001_init.sql) --
    """
    CREATE TABLE config (
      key TEXT PRIMARY KEY,
      value TEXT
    );

    CREATE TABLE models (
      id INTEGER PRIMARY KEY,
      name TEXT NOT NULL,
      model_type TEXT NOT NULL,
      created_at BIGINT NOT NULL
    );

    CREATE TABLE model_versions (
      model_id INT NOT NULL REFERENCES models(id) ON DELETE CASCADE,
      version INT NOT NULL DEFAULT 0,
      status TEXT NOT NULL,
      weights_filename TEXT NOT NULL,
      created_at BIGINT NOT NULL,
      PRIMARY KEY(model_id, version)
    );

    CREATE TABLE sources (
      id INTEGER PRIMARY KEY,
      name TEXT NOT NULL,
      config TEXT,
      location TEXT NOT NULL,
      compare_strategy TEXT NOT NULL,
      status TEXT NOT NULL,
      last_indexed BIGINT NOT NULL DEFAULT 0,
      index_version BIGINT NOT NULL DEFAULT 0,
      index_interval BIGINT
    );

    CREATE TABLE items (
      id INTEGER PRIMARY KEY,
      source_id INTEGER NOT NULL REFERENCES sources(id) ON DELETE CASCADE,
      external_id TEXT NOT NULL,
      version INTEGER NOT NULL DEFAULT 0,
      hash TEXT NOT NULL,
      content TEXT NOT NULL,
      raw_content BLOB,
      process_version INTEGER NOT NULL DEFAULT 0,
      name TEXT,
      author TEXT,
      description TEXT,
      modified BIGINT,
      last_accessed BIGINT,
      skipped TEXT,
      hidden_at BIGINT
    );

    CREATE INDEX items_source_external_id_idx ON items(source_id, external_id);

    CREATE TABLE item_embeddings (
      model_id INT NOT NULL,
      model_version INT NOT NULL,
      item_id BIGINT NOT NULL REFERENCES items(id) ON DELETE CASCADE,
      item_index_version BIGINT NOT NULL,
      embedding BLOB NOT NULL,
      FOREIGN KEY(model_id, model_version)
        REFERENCES model_versions(model_id, version) ON DELETE CASCADE,
      PRIMARY KEY (model_id, model_version, item_id)
    );

    INSERT INTO models (id, name, model_type, created_at) VALUES
      (0, 'AllMiniLmL6V2', 'AllMiniLmL6V2', 0),
      (1, 'AllMiniLmL12V2', 'AllMiniLmL12V2', 0),
      (2, 'DistiluseBaseMultilingualCased', 'DistiluseBaseMultilingualCased', 0),
      (3, 'AllDistilrobertaV1', 'AllDistilrobertaV1', 0),
      (4, 'ParaphraseAlbertSmallV2', 'ParaphraseAlbertSmallV2', 0),
      (5, 'MsMarcoDistilbertDotV5', 'MsMarcoDistilbertDotV5', 0),
      (6, 'MsMarcoDistilbertBaseTasB', 'MsMarcoDistilbertBaseTasB', 0);

    INSERT INTO model_versions (model_id, version, status, weights_filename, created_at) VALUES
      (0, 0, 'ready', '', 0),
      (1, 0, 'ready', '', 0),
      (2, 0, 'ready', '', 0),
      (3, 0, 'ready', '', 0),
      (4, 0, 'ready', '', 0),
      (5, 0, 'ready', '', 0),
      (6, 0, 'ready', '', 0);
    """,
    # -- 2: tags (parity with 00002_tags.sql) --
    """
    CREATE TABLE tags (
      id INTEGER PRIMARY KEY,
      name TEXT NOT NULL,
      description TEXT,
      color TEXT NOT NULL
    );

    CREATE INDEX tags_name_idx ON tags(name);

    CREATE TABLE item_tags (
      item_id BIGINT NOT NULL REFERENCES items(id) ON DELETE CASCADE DEFERRABLE,
      tag_id BIGINT NOT NULL REFERENCES tags(id) ON DELETE CASCADE DEFERRABLE,
      PRIMARY KEY (item_id, tag_id)
    );

    CREATE INDEX item_tags_item_id_idx ON item_tags(item_id);
    CREATE INDEX item_tags_tag_id_idx ON item_tags(tag_id);
    """,
    # -- 3: model 7 (parity with 00003_model_7.sql) --
    """
    INSERT INTO models (id, name, model_type, created_at) VALUES
      (7, 'MsMarcoBertBaseDotV5', 'MsMarcoBertBaseDotV5', 0);

    INSERT INTO model_versions (model_id, version, status, weights_filename, created_at) VALUES
      (7, 0, 'ready', '', 0);
    """,
    # -- 4: device-matrix snapshot manifest (TPU-native addition) --
    """
    CREATE TABLE vector_shards (
      model_id INT NOT NULL,
      model_version INT NOT NULL,
      -- Path of the snapshot file (bf16/int8 matrix + row->item map).
      path TEXT NOT NULL,
      -- Max items.id included; rows added later are loaded incrementally.
      max_item_id BIGINT NOT NULL,
      rows INT NOT NULL,
      dim INT NOT NULL,
      dtype TEXT NOT NULL,
      created_at BIGINT NOT NULL,
      PRIMARY KEY (model_id, model_version)
    );
    """,
    # -- 5: monotonic embedding write sequence (TPU-native addition) --
    # Every embedding insert/update stamps a global seq so a device-matrix
    # snapshot records max(seq) and startup only replays rows written after
    # it, instead of rescanning every BLOB.
    """
    ALTER TABLE item_embeddings ADD COLUMN seq BIGINT NOT NULL DEFAULT 0;
    CREATE INDEX item_embeddings_seq_idx ON item_embeddings(seq);
    """,
    # -- 6: chunk embeddings (TPU-native addition) --
    # Long documents can be embedded as overlapping chunks (one vector per
    # chunk, chunk_idx 0..N-1) instead of the reference's head-truncation
    # (model/tokenize.rs:64-71) — the matrix indexes every chunk and search
    # dedupes back to items.  PK gains chunk_idx (table rebuild: SQLite
    # can't alter PKs in place).
    """
    CREATE TABLE item_embeddings_new (
      model_id INT NOT NULL,
      model_version INT NOT NULL,
      item_id BIGINT NOT NULL REFERENCES items(id) ON DELETE CASCADE,
      chunk_idx INT NOT NULL DEFAULT 0,
      item_index_version BIGINT NOT NULL,
      embedding BLOB NOT NULL,
      seq BIGINT NOT NULL DEFAULT 0,
      FOREIGN KEY(model_id, model_version)
        REFERENCES model_versions(model_id, version) ON DELETE CASCADE,
      PRIMARY KEY (model_id, model_version, item_id, chunk_idx)
    );
    INSERT INTO item_embeddings_new
      (model_id, model_version, item_id, chunk_idx, item_index_version, embedding, seq)
      SELECT model_id, model_version, item_id, 0, item_index_version, embedding, seq
      FROM item_embeddings;
    DROP TABLE item_embeddings;
    ALTER TABLE item_embeddings_new RENAME TO item_embeddings;
    CREATE INDEX item_embeddings_seq_idx ON item_embeddings(seq);
    """,
    # -- 7: unique tag names (TPU-native addition) --
    # tags.name had only a plain index; concurrent `tag add` could create
    # duplicate rows that silently split a tag.  Databases written by such
    # a build may already hold duplicates, so merge them into the lowest-id
    # tag per name FIRST — creating the unique index over existing dupes
    # would fail the migration and brick every subsequent open.
    """
    UPDATE OR IGNORE item_tags SET tag_id = (
      SELECT MIN(t2.id) FROM tags t2
      WHERE t2.name = (SELECT t3.name FROM tags t3 WHERE t3.id = item_tags.tag_id)
    ) WHERE tag_id NOT IN (SELECT MIN(id) FROM tags GROUP BY name);
    DELETE FROM item_tags
      WHERE tag_id NOT IN (SELECT MIN(id) FROM tags GROUP BY name);
    DELETE FROM tags WHERE id NOT IN (SELECT MIN(id) FROM tags GROUP BY name);
    DROP INDEX tags_name_idx;
    CREATE UNIQUE INDEX tags_name_idx ON tags(name);
    """,
]


def _statements(script: str):
    """Split a migration script into complete statements (executescript
    autocommits per statement, which would leave a half-applied migration
    behind a crash; we run each script inside ONE explicit transaction)."""
    buf = ""
    for line in script.splitlines():
        buf += line + "\n"
        if sqlite3.complete_statement(buf):
            stmt = buf.strip()
            if stmt and stmt != ";":
                yield stmt
            buf = ""
    tail = buf.strip()
    if tail and tail != ";":
        yield tail


def migrate(conn: sqlite3.Connection) -> None:
    """Apply outstanding migrations atomically, tracked via user_version:
    either a migration fully applies (including its version bump) or the
    database is untouched."""
    (current,) = conn.execute("PRAGMA user_version").fetchone()
    for i, sql in enumerate(MIGRATIONS[current:], start=current + 1):
        # BEGIN IMMEDIATE + an in-transaction re-check: two processes
        # opening the same database concurrently (serve + a CLI scan) both
        # read the pre-migration version; a deferred BEGIN would let both
        # apply the same migration and crash the loser with 'table already
        # exists' (review r3).  IMMEDIATE serializes them, and the re-check
        # makes the loser skip what the winner already applied.
        conn.execute("BEGIN IMMEDIATE")
        try:
            (now,) = conn.execute("PRAGMA user_version").fetchone()
            if now >= i:
                conn.execute("COMMIT")
                continue
            for stmt in _statements(sql):
                conn.execute(stmt)
            conn.execute(f"PRAGMA user_version = {i}")
            conn.execute("COMMIT")
        except BaseException:
            conn.execute("ROLLBACK")
            raise
