"""The port's copy of the SQLite store against the JAX package's: the same
schema after both packages' migrations, and a database written by either
package is searched by the other with the same hits (f32 tier: scores
within 1e-5 relative, f32 sums in another order)."""

import re
import sqlite3

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceive_tpu import db as jax_db
from perceive_tpu import types as jax_types
from perceive_tpu.index.searcher import Searcher as JaxSearcher
from perceive_tpu_torch import db as port_db
from perceive_tpu_torch import types as port_types
from perceive_tpu_torch.index.matrix import serialize_embedding
from perceive_tpu_torch.index.searcher import Searcher
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)

DIM = 32
PACKAGES = {"jax": (jax_db, jax_types), "port": (port_db, port_types)}


def _schema(path):
    conn = sqlite3.connect(path)
    try:
        return conn.execute(
            "SELECT type, name, tbl_name, sql FROM sqlite_master ORDER BY type, name"
        ).fetchall(), conn.execute("PRAGMA user_version").fetchone()
    finally:
        conn.close()


def test_migrations_give_the_same_schema(tmp_path):
    schemas = {}
    for name, (db, _) in PACKAGES.items():
        path = tmp_path / f"{name}.sqlite3"
        d = db.Database(path)
        d.close()
        schemas[name] = _schema(path)
    assert schemas["port"] == schemas["jax"]
    assert len(schemas["port"][0]) > 8


def _write(db_mod, types_mod, path, rng):
    """Two sources, 60 items with one embedding each, one hidden item."""
    d = db_mod.Database(path)
    srcs = [db_mod.add_source(d, types_mod.Source(name=n, config={"type": "fs"}, location=f"/{n}"))
            for n in ("alpha", "beta")]
    vecs = rng.standard_normal((60, DIM)).astype(np.float32)
    with d.write() as conn:
        for i in range(60):
            conn.execute(
                """INSERT INTO items (id, source_id, external_id, version, hash, content,
                     process_version, name) VALUES (?,?,?,?,?,?,?,?)""",
                (i + 1, srcs[i % 2].id, f"f{i}", 1, "", f"text {i}", 0, f"item {i}"),
            )
            conn.execute(
                """INSERT INTO item_embeddings (item_id, chunk_idx, item_index_version, embedding,
                     model_id, model_version, seq) VALUES (?,?,?,?,?,?,?)""",
                (i + 1, 0, 1, serialize_embedding(vecs[i]), 0, 0, i + 1),
            )
        conn.execute("UPDATE items SET hidden_at = 1 WHERE id = 7")
    return d, srcs, vecs


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_database_written_by_one_package_searches_in_the_other(tmp_path, writer):
    rng = np.random.default_rng(5)
    db_mod, types_mod = PACKAGES[writer]
    d, srcs, vecs = _write(db_mod, types_mod, tmp_path / "db.sqlite3", rng)
    d.close()
    jdb, pdb = jax_db.Database(tmp_path / "db.sqlite3"), port_db.Database(tmp_path / "db.sqlite3")
    try:
        assert [s.name for s in port_db.list_sources(pdb)] == [s.name for s in jax_db.list_sources(jdb)]
        jsr = JaxSearcher.build(jdb, 0, 0, DIM, dtype=jnp.float32, engine="xla", use_snapshot=False)
        psr = Searcher.build(pdb, 0, 0, DIM, device="cpu", dtype=torch.float32)
        assert len(psr.matrix) == len(jsr.matrix) == 59
        for qi in range(4):
            q = vecs[qi * 7] + 0.1 * rng.standard_normal(DIM).astype(np.float32)
            for filt in (None, [srcs[1].id]):
                got = psr.search_vector(q, 8, filt)
                want = jsr.search_vector(q, 8, filt)
                assert [i for i, _ in got] == [i for i, _ in want]
                np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=1e-5)
        got = psr.retrieve(pdb, psr.search_vector(vecs[2], 5))
        want = jsr.retrieve(jdb, jsr.search_vector(vecs[2], 5))
        assert [(r.item.id, r.item.content, r.source_name) for r in got] == [
            (r.item.id, r.item.content, r.source_name) for r in want
        ]
    finally:
        jdb.close()
        pdb.close()


def test_cold_load_keeps_jax_bookkeeping(tmp_path, monkeypatch, capsys):
    """A cold build over single- and multi-chunk items, blobs of another
    width and a hidden item, read a few rows at a time: the port's matrix
    holds the JAX package's keys, rows, groups and vectors, and both warn of
    the same skipped rows."""
    rng = np.random.default_rng(9)
    path = tmp_path / "db.sqlite3"
    d = port_db.Database(path)
    src = port_db.add_source(d, port_types.Source(name="s", config={"type": "fs"}, location="/s"))
    seq = 0
    with d.write() as conn:
        for i in range(1, 41):
            conn.execute(
                "INSERT INTO items (id, source_id, external_id, hash, content) VALUES (?,?,?,?,?)",
                (i, src.id, f"f{i}", "", "c"),
            )
            # items 5, 10, ... have three chunks (written last chunk first)
            # and every 7th one blob of another width
            for c in ((2, 1, 0) if i % 5 == 0 else (0,)):
                seq += 1
                dim = 2 * DIM if (i + c) % 7 == 0 else DIM
                conn.execute(
                    """INSERT INTO item_embeddings (item_id, chunk_idx, item_index_version, embedding,
                         model_id, model_version, seq) VALUES (?,?,?,?,?,?,?)""",
                    (i, c, 1, serialize_embedding(rng.standard_normal(dim).astype(np.float32)), 0, 0, seq),
                )
        conn.execute("UPDATE items SET hidden_at = 1 WHERE id = 3")
    d.close()
    monkeypatch.setattr(Searcher, "_LOAD_DB_CHUNK_ROWS", 6)
    monkeypatch.setattr(JaxSearcher, "_LOAD_DB_CHUNK_ROWS", 6, raising=False)
    jdb, pdb = jax_db.Database(path), port_db.Database(path)
    try:
        jm = JaxSearcher.build(jdb, 0, 0, DIM, dtype=jnp.float32, engine="xla", use_snapshot=False).matrix
        jwarn = capsys.readouterr().err
        pm = Searcher.build(pdb, 0, 0, DIM, device="cpu", dtype=torch.float32, use_snapshot=False).matrix
        pwarn = capsys.readouterr().err
    finally:
        jdb.close()
        pdb.close()
    skipped = [re.findall(r"skipped (\d+) stored embeddings", w) for w in (pwarn, jwarn)]
    assert skipped[0] == skipped[1] == ["8"]
    assert pm.row_of == jm.row_of and len(pm) == len(jm) > 30
    assert {k: sorted(v) for k, v in pm.groups.items()} == {k: sorted(v) for k, v in jm.groups.items()}
    assert pm.multi_chunk_groups == jm.multi_chunk_groups > 0
    assert pm.item_ids.tolist() == np.asarray(jm.item_ids).tolist()
    assert pm.source_ids.tolist() == np.asarray(jm.source_ids).tolist()
    np.testing.assert_array_equal(pm._host_vectors[: pm.rows, :DIM], np.asarray(jm._host_vectors)[: jm.rows, :DIM])


def test_memory_mapped_reads_see_every_write(tmp_path, monkeypatch):
    """The port's read connections map the file (``READ_MMAP_BYTES``, a
    divergence from the JAX package's copy): a cold build through one equals
    a build through plain reads, also after rows written and checkpointed
    into the mapped file while that connection stayed open."""
    rng = np.random.default_rng(9)
    d, srcs, _ = _write(port_db, port_types, tmp_path / "db.sqlite3", rng)
    assert d.read().execute("PRAGMA mmap_size").fetchone()[0] > 0
    assert len(Searcher.build(d, 0, 0, DIM, device="cpu", dtype=torch.float32).matrix) == 59
    more = rng.standard_normal((40, DIM)).astype(np.float32)
    with d.write() as conn:
        for i in range(40):
            conn.execute(
                """INSERT INTO items (id, source_id, external_id, version, hash, content, process_version)
                   VALUES (?,?,?,?,?,?,?)""", (1000 + i, srcs[0].id, f"more{i}", 1, "", f"more {i}", 0))
            conn.execute(
                """INSERT INTO item_embeddings (item_id, chunk_idx, item_index_version, embedding,
                     model_id, model_version, seq) VALUES (?,?,?,?,?,?,?)""",
                (1000 + i, 0, 1, serialize_embedding(more[i]), 0, 0, 1000 + i))
    d._write_conn.execute("PRAGMA wal_checkpoint(TRUNCATE)")
    mapped = Searcher.build(d, 0, 0, DIM, device="cpu", dtype=torch.float32)
    d.close()
    monkeypatch.setattr(port_db.database, "READ_MMAP_BYTES", 0)
    plain_db = port_db.Database(tmp_path / "db.sqlite3")
    try:
        assert plain_db.read().execute("PRAGMA mmap_size").fetchone()[0] == 0
        plain = Searcher.build(plain_db, 0, 0, DIM, device="cpu", dtype=torch.float32)
    finally:
        plain_db.close()
    assert len(mapped.matrix) == len(plain.matrix) == 99
    q = more[3]
    assert mapped.search_vector(q, 10) == plain.search_vector(q, 10)
    assert mapped.search_vector(q, 1)[0][0] == 1003
