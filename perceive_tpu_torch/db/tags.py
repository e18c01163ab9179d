"""A copy of perceive_tpu/db/tags.py, so that the port imports nothing of the JAX
package (tests/test_torch_db.py holds the two schemas equal).

Tag CRUD + item tagging.

The reference created tags/item_tags tables (migrations/00002_tags.sql) but
shipped no code using them; here they work: create/list tags, tag/untag
items, filter search results by tag (cli `tag` commands and `search --tag`).
"""

from __future__ import annotations

from typing import Optional

from .database import Database


def ensure_tag(db: Database, name: str, color: str = "#888888") -> int:
    row = db.read().execute("SELECT id FROM tags WHERE name = ?", (name,)).fetchone()
    if row:
        return row[0]
    with db.write() as conn:
        # atomic against concurrent taggers (tags.name is UNIQUE, migration 7)
        conn.execute(
            "INSERT INTO tags (name, color) VALUES (?, ?) ON CONFLICT (name) DO NOTHING",
            (name, color),
        )
        return conn.execute("SELECT id FROM tags WHERE name = ?", (name,)).fetchone()[0]


def list_tags(db: Database) -> list[tuple[int, str, int]]:
    """[(id, name, item_count)]"""
    return db.read().execute(
        """SELECT tags.id, tags.name, COUNT(item_tags.item_id)
           FROM tags LEFT JOIN item_tags ON item_tags.tag_id = tags.id
           GROUP BY tags.id ORDER BY tags.name"""
    ).fetchall()


def tag_item(db: Database, item_id: int, tag_name: str) -> None:
    tag_id = ensure_tag(db, tag_name)
    with db.write() as conn:
        conn.execute(
            "INSERT OR IGNORE INTO item_tags (item_id, tag_id) VALUES (?, ?)",
            (item_id, tag_id),
        )


def untag_item(db: Database, item_id: int, tag_name: str) -> bool:
    row = db.read().execute("SELECT id FROM tags WHERE name = ?", (tag_name,)).fetchone()
    if not row:
        return False
    with db.write() as conn:
        cur = conn.execute(
            "DELETE FROM item_tags WHERE item_id = ? AND tag_id = ?", (item_id, row[0])
        )
        return cur.rowcount > 0


def items_with_tag(db: Database, tag_name: str) -> Optional[set[int]]:
    """Item ids carrying the tag, or None if the tag doesn't exist."""
    row = db.read().execute("SELECT id FROM tags WHERE name = ?", (tag_name,)).fetchone()
    if not row:
        return None
    return {
        r[0]
        for r in db.read().execute(
            "SELECT item_id FROM item_tags WHERE tag_id = ?", (row[0],)
        )
    }
