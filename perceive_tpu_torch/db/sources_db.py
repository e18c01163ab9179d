"""A copy of perceive_tpu/db/sources_db.py, so that the port imports nothing of the JAX
package (tests/test_torch_db.py holds the two schemas equal).

Source CRUD (reference: crates/perceive-core/sources/
db.rs:9-83).  Config and status are JSON text columns; compare_strategy is the
snake_case enum string."""

from __future__ import annotations

import json
from typing import Optional

from ..types import ItemCompareStrategy, Source, SourceStatus
from .database import Database

_SOURCE_COLUMNS = (
    "id, name, config, location, compare_strategy, status, last_indexed, "
    "index_version, index_interval"
)


def _row_to_source(row) -> Source:
    return Source(
        id=row[0],
        name=row[1],
        config=json.loads(row[2]) if row[2] else {},
        location=row[3],
        compare_strategy=ItemCompareStrategy(row[4]),
        status=SourceStatus.from_json(row[5]),
        last_indexed=row[6] or 0,
        index_version=row[7] or 0,
        index_interval=row[8],
    )


def list_sources(db: Database) -> list[Source]:
    rows = db.read().execute(f"SELECT {_SOURCE_COLUMNS} FROM sources").fetchall()
    return [_row_to_source(r) for r in rows]


def get_source(db: Database, name_or_id: str | int) -> Optional[Source]:
    # NAME takes precedence for strings: a source literally named "2024"
    # must stay reachable (review r3: the isdigit branch hid it behind
    # whatever row happened to have id 2024); all-digit strings fall back
    # to an id lookup only when no such name exists.
    if isinstance(name_or_id, str):
        row = db.read().execute(
            f"SELECT {_SOURCE_COLUMNS} FROM sources WHERE name = ?", (name_or_id,)
        ).fetchone()
        if row is None and name_or_id.isdigit():
            row = db.read().execute(
                f"SELECT {_SOURCE_COLUMNS} FROM sources WHERE id = ?", (int(name_or_id),)
            ).fetchone()
    else:
        row = db.read().execute(
            f"SELECT {_SOURCE_COLUMNS} FROM sources WHERE id = ?", (int(name_or_id),)
        ).fetchone()
    return _row_to_source(row) if row else None


def add_source(db: Database, source: Source) -> Source:
    with db.write() as conn:
        cur = conn.execute(
            """INSERT INTO sources
               (name, config, location, compare_strategy, status, last_indexed,
                index_version, index_interval)
               VALUES (?, ?, ?, ?, ?, ?, ?, ?)""",
            (
                source.name,
                json.dumps(source.config),
                source.location,
                str(source.compare_strategy),
                source.status.to_json(),
                source.last_indexed,
                source.index_version,
                source.index_interval,
            ),
        )
        source.id = cur.lastrowid
    return source


def update_source(db: Database, source: Source) -> None:
    with db.write() as conn:
        conn.execute(
            """UPDATE sources SET name = ?, config = ?, location = ?,
               compare_strategy = ?, status = ?, last_indexed = ?,
               index_version = ?, index_interval = ?
               WHERE id = ?""",
            (
                source.name,
                json.dumps(source.config),
                source.location,
                str(source.compare_strategy),
                source.status.to_json(),
                source.last_indexed,
                source.index_version,
                source.index_interval,
                source.id,
            ),
        )


def update_source_status(
    db: Database,
    source_id: int,
    status: SourceStatus,
    index_version: Optional[int] = None,
) -> None:
    """Scan-owned-fields-only write (status, optionally index_version):
    scan start/end must never write a session's full stale Source row —
    that would revert a concurrent `source edit` from another process
    (review r3)."""
    with db.write() as conn:
        if index_version is None:
            conn.execute(
                "UPDATE sources SET status = ? WHERE id = ?",
                (status.to_json(), source_id),
            )
        else:
            conn.execute(
                "UPDATE sources SET status = ?, index_version = ? WHERE id = ?",
                (status.to_json(), index_version, source_id),
            )
