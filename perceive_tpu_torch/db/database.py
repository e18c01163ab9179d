"""A copy of perceive_tpu/db/database.py, so that the port imports nothing of the JAX
package (tests/test_torch_db.py holds the two schemas equal).

SQLite store: one mutex-guarded write connection + per-thread read
connections.

Mirrors the reference's discipline (crates/perceive-core/
db.rs:43-109): WAL journal, synchronous=NORMAL, migrations at open, a single
writer (SQLite only supports one anyway) and a pool of read-only connections.
The reference's `rarray` virtual table (batch IN-list binds) maps to SQLite's
built-in ``json_each`` here.
"""

from __future__ import annotations

import json
import sqlite3
import threading
import time
from pathlib import Path
from typing import Iterable, Optional, Sequence

from ..types import Item, ItemMetadata, SkipReason
from . import migrations

# Column list used by every item SELECT, kept in one place like the
# reference's ITEM_COLUMNS (db.rs:144-151).
ITEM_COLUMNS = (
    "id, source_id, external_id, hash, content, raw_content, process_version, "
    "name, author, description, modified, last_accessed, skipped"
)


def deserialize_item_row(row: Sequence) -> Item:
    """Build an Item from a row SELECTed with ITEM_COLUMNS
    (reference: db.rs:153-178)."""
    return Item(
        id=row[0],
        source_id=row[1],
        external_id=row[2],
        hash=row[3],
        content=row[4],
        raw_content=row[5],
        process_version=row[6] or 0,
        metadata=ItemMetadata(
            name=row[7],
            author=row[8],
            description=row[9],
            mtime=row[10],
            atime=row[11],
        ),
        skipped=SkipReason.parse(row[12]),
    )


def json_ids(values: Iterable) -> str:
    """Serialize a batch key list for ``IN (SELECT value FROM json_each(?))``
    — our analog of the reference's rarray vtab binds (db.rs:79-85)."""
    return json.dumps(list(values))


class Database:
    """Open (creating + migrating if needed) the store at ``path``.

    Thread model: ``write`` is a context manager serializing transactional
    writes through one connection; ``read()`` hands out a thread-local
    read-only connection so stages/threads never contend.
    """

    def __init__(self, path: str | Path, wal: bool = True):
        self.path = str(path)
        self._write_lock = threading.RLock()
        self._wal = wal
        self._write_conn = sqlite3.connect(
            self.path, check_same_thread=False, isolation_level=None
        )
        self._configure_write_connection(self._write_conn)
        migrations.migrate(self._write_conn)
        self._local = threading.local()
        # (owner thread, connection) pairs; read() prunes dead threads
        self._read_conns: list[tuple] = []
        self._conns_lock = threading.Lock()

    def _configure_write_connection(self, conn: sqlite3.Connection) -> None:
        # reference: db.rs:93-98
        if self._wal:
            conn.execute("PRAGMA journal_mode = WAL")
        conn.execute("PRAGMA synchronous = NORMAL")
        conn.execute("PRAGMA foreign_keys = ON")
        conn.execute("PRAGMA busy_timeout = 30000")

    # -- connections ------------------------------------------------------

    def read(self) -> sqlite3.Connection:
        """Thread-local read connection (read-only URI open)."""
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(
                f"file:{self.path}?mode=ro",
                uri=True,
                check_same_thread=False,
                isolation_level=None,
            )
            # readers wait for WAL checkpoints instead of failing with
            # "database is locked" under write load
            conn.execute("PRAGMA busy_timeout = 30000")
            self._local.conn = conn
            with self._conns_lock:
                if getattr(self, "_closed", False):
                    # close() already swapped the registry: registering here
                    # would leak this fd forever (review r3)
                    conn.close()
                    raise sqlite3.ProgrammingError("database is closed")
                # prune connections whose owner thread died — each scan's
                # short-lived pipeline threads would otherwise leak one open
                # sqlite fd apiece until close() (long-running serve
                # --refresh processes accumulate hundreds)
                live, dead = [], []
                for t, c in self._read_conns:
                    (live if t.is_alive() else dead).append((t, c))
                self._read_conns = live
                self._read_conns.append((threading.current_thread(), conn))
            for _, c in dead:
                try:
                    c.close()
                except sqlite3.Error:
                    pass
        return conn

    class _WriteTxn:
        def __init__(self, db: "Database"):
            self.db = db

        def __enter__(self) -> sqlite3.Connection:
            self.db._write_lock.acquire()
            try:
                self.db._write_conn.execute("BEGIN")
            except BaseException:
                self.db._write_lock.release()  # else every later writer deadlocks
                raise
            return self.db._write_conn

        def __exit__(self, exc_type, exc, tb) -> None:
            try:
                if exc_type is None:
                    try:
                        self.db._write_conn.execute("COMMIT")
                    except BaseException:
                        # a failed COMMIT leaves the txn open; roll back so
                        # the next BEGIN doesn't raise "within a transaction"
                        try:
                            self.db._write_conn.execute("ROLLBACK")
                        except sqlite3.Error:
                            pass
                        raise
                else:
                    self.db._write_conn.execute("ROLLBACK")
            finally:
                self.db._write_lock.release()

    def write(self) -> "_WriteTxn":
        """One transaction per ``with db.write() as conn`` block."""
        return Database._WriteTxn(self)

    def close(self) -> None:
        # take the write lock: closing under a writer mid-transaction would
        # kill its COMMIT with ProgrammingError (review r3)
        with self._write_lock:
            self._write_conn.close()
        with self._conns_lock:
            self._closed = True  # read() stops registering new connections
            conns, self._read_conns = self._read_conns, []
        for _, conn in conns:  # read conns from EVERY thread, not just ours
            try:
                conn.close()
            except sqlite3.ProgrammingError:
                pass  # another thread may be mid-query at shutdown
        self._local = threading.local()

    # -- item helpers (reference: db.rs:111-139) --------------------------

    def read_item(self, item_id: int) -> Optional[Item]:
        row = self.read().execute(
            f"SELECT {ITEM_COLUMNS} FROM items WHERE id = ?", (item_id,)
        ).fetchone()
        return deserialize_item_row(row) if row else None

    def ensure_model_version(self, model_id: int, version: int) -> None:
        """Make sure (model_id, version) exists in models/model_versions so
        item_embeddings FK inserts succeed.  Migration 1 only seeds version
        0 for the 8 reference model types; non-zero versions — a model
        upgrade, or the random-fallback encoder's reserved
        RANDOM_FALLBACK_VERSION (cli/state.py) — must register before the
        first scan writes an embedding, or every write txn dies on the FK
        (found by an end-to-end drive of a fresh no-checkpoint install)."""
        with self.write() as conn:
            conn.execute(
                "INSERT OR IGNORE INTO models (id, name, model_type, created_at)"
                " VALUES (?, ?, ?, ?)",
                (model_id, f"model-{model_id}", f"model-{model_id}",
                 int(time.time())),
            )
            conn.execute(
                "INSERT OR IGNORE INTO model_versions"
                " (model_id, version, status, weights_filename, created_at)"
                " VALUES (?, ?, 'ready', '', ?)",
                (model_id, version, int(time.time())),
            )

    def set_item_hidden(self, item_id: int, hidden: bool) -> None:
        """Hide/unhide an item.  The reference parsed an --unhide flag but
        always hid (cmd/hide.rs:16); here unhide actually clears hidden_at."""
        with self.write() as conn:
            conn.execute(
                "UPDATE items SET hidden_at = ? WHERE id = ?",
                (int(time.time()) if hidden else None, item_id),
            )
