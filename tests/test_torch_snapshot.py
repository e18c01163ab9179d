"""The port's snapshots (format v2) against the JAX package's, on the CPU.

The same rows, made from a seed with numpy, go into an EmbeddingMatrix of
each package at each of six tier configurations (bf16, f32, int8, int4,
int2 with its int8 companion, int2 with its int4 companion).  A base
written by either package holds the same bytes in every member but
``base_token``, and the other package adopts it: the same host state,
and device tensors equal to the JAX package's staged payload over the
stored rows and, in full, to the port's own staging of the same rows.
Deltas cross both ways; ``apply_snapshot_delta``'s stale (0) and unusable
(-1) outcomes agree; ``Searcher.build`` over one database and one manifest
gives the same hits in both packages after rows were added, hidden,
unhidden and removed since the save.  Then the port's own copies of the
JAX package's race tests, its fallbacks, and the CLI's ``snapshot`` and
post-scan autosave.
"""

import contextlib
import io
import os
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceive_tpu.db import Database as JaxDatabase
from perceive_tpu.index.matrix import INT2 as JAX_INT2
from perceive_tpu.index.matrix import INT4 as JAX_INT4
from perceive_tpu.index.matrix import EmbeddingMatrix as JaxMatrix
from perceive_tpu.index.searcher import Searcher as JaxSearcher
from perceive_tpu_torch.cli import AppState, main
from perceive_tpu_torch.cli import commands
from perceive_tpu_torch.db import Database, add_source
from perceive_tpu_torch.index import matrix as port_matrix
from perceive_tpu_torch.index.matrix import (
    INT2,
    INT4,
    EmbeddingMatrix,
    SnapshotDeviceError,
    chunk_key,
    serialize_embedding,
)
from perceive_tpu_torch.index.searcher import Searcher
from perceive_tpu_torch.models import EncoderArch, HeadConfig, Model, TextTokenizer, tiny_test_vocab
from perceive_tpu_torch.types import Source, SourceStatus
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)

DIM = 40  # padded to 128
# (id, JAX dtype, port dtype, PERCEIVE_TPU_INT2_FINE)
TIERS = [
    ("bf16", jnp.bfloat16, torch.bfloat16, None),
    ("f32", jnp.float32, torch.float32, None),
    ("int8", jnp.int8, torch.int8, None),
    ("int4", JAX_INT4, INT4, None),
    ("int2+int8", JAX_INT2, INT2, "int8"),
    ("int2+int4", JAX_INT2, INT2, "int4"),
]
TIER_IDS = [t[0] for t in TIERS]


@pytest.fixture(params=TIERS, ids=TIER_IDS)
def tier(request, monkeypatch):
    name, jd, pd, fine = request.param
    if fine is None:
        monkeypatch.delenv("PERCEIVE_TPU_INT2_FINE", raising=False)
    else:
        monkeypatch.setenv("PERCEIVE_TPU_INT2_FINE", fine)
    return name, jd, pd


def _fill(m, *, n=60, seed=0):
    """n items, every 5th with two more chunk rows, three sources; three
    keys tombstoned (a chunk-0 pair and one chunk of a group)."""
    rng = np.random.default_rng(seed)
    keys, srcs = [], []
    for i in range(n):
        ks = [chunk_key(i + 1)] + ([chunk_key(i + 1, 1), chunk_key(i + 1, 2)] if i % 5 == 0 else [])
        keys += ks
        srcs += [1 + i % 3] * len(ks)
    m.upsert(keys, srcs, rng.standard_normal((len(keys), DIM)).astype(np.float32))
    m.remove([chunk_key(2), chunk_key(3), chunk_key(6, 1)])
    m.sync()
    return m, rng


def _pair(jd, pd, **kw):
    return _fill(JaxMatrix(DIM, dtype=jd), **kw)[0], _fill(EmbeddingMatrix(DIM, dtype=pd, device="cpu"), **kw)[0]


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def _host_state(m, sort_free=False):
    return {
        "rows": m.rows, "capacity": m.capacity, "row_of": dict(m.row_of),
        "groups": {k: sorted(v) for k, v in m.groups.items()}, "multi": m.multi_chunk_groups,
        "free": sorted(m._free) if sort_free else list(m._free),
        "item_ids": m.item_ids[: m.rows].tolist(), "source_ids": m.source_ids[: m.rows].tolist(),
        "scale_hw": np.float32(m.scale_hw), "norm_hw": np.float32(m.norm_hw),
    }


def _flat(view):
    """(vectors, source ids, scales) of device_view as a flat list of numpy
    arrays (the int2 tier's pairs unpacked; None scales dropped)."""
    vecs, src, scales = view
    vecs = list(vecs) if isinstance(vecs, tuple) else [vecs]
    scales = list(scales) if isinstance(scales, tuple) else ([] if scales is None else [scales])
    out = []
    for a in vecs + [src] + scales:
        a = a.float() if isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16 else a
        out.append(a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a).astype(
            np.float32 if np.asarray(a).dtype == jnp.bfloat16 else np.asarray(a).dtype))
    return out


def _prefix(a, n, transposed):
    return a[:, :n] if transposed else a[:n]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_base_bytes_and_adopt_cross(tier, writer, tmp_path):
    """Bytes equal but base_token; the other package (and the writer's own)
    adopts the base into the writer's host state; the port's adopted
    device tensors equal the JAX package's staged payload over the stored
    rows and the port's own staging in full."""
    name, jd, pd = tier
    jm, pm = _pair(jd, pd)
    jpath, ppath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    assert jm.save_snapshot(jpath) == "full" and pm.save_snapshot(ppath) == "full"
    a, b = _members(jpath), _members(ppath)
    assert sorted(a) == sorted(b)
    assert [k for k in a if k != "base_token.npy" and a[k] != b[k]] == []
    assert a["base_token.npy"] != b["base_token.npy"]
    assert str(np.load(ppath)["tier"]) == pm.dtype_name == {"int2+int8": "int2", "int2+int4": "int2"}.get(name, jm.dtype_name)

    path = jpath if writer == "jax" else ppath
    ja, pa = JaxMatrix(DIM, dtype=jd), EmbeddingMatrix(DIM, dtype=pd, device="cpu")
    assert ja.adopt_snapshot(path) and pa.adopt_snapshot(path)
    assert _host_state(pa) == _host_state(ja)
    assert _host_state(pa, sort_free=True) == _host_state(pm, sort_free=True)
    np.testing.assert_array_equal(pa._host_vectors, pm._host_vectors)
    n = pa.rows
    transposed = pa.packed2 or pa.packed4
    got, jax_staged, port_staged = _flat(pa.device_view()), _flat(ja.device_view()), _flat(pm.device_view())
    assert len(got) == len(jax_staged) == len(port_staged)
    for i, (g, j, p) in enumerate(zip(got, jax_staged, port_staged)):
        t = transposed and g.ndim == 2
        assert g.dtype == p.dtype and g.shape == p.shape
        np.testing.assert_array_equal(_prefix(g, n, t), _prefix(j, n, t), err_msg=f"array {i}")
        np.testing.assert_array_equal(g, p, err_msg=f"array {i}")
    if pa.packed2:
        assert pa.tier_name == pm.tier_name and pa.fine_bits == pm.fine_bits


@pytest.mark.parametrize("direction", ["jax base, port delta", "port base, jax delta"])
def test_delta_cross(tier, direction, tmp_path):
    """A base of one package, adopted and changed by the other, which saves
    the delta; the first package loads base + delta into the live state."""
    _, jd, pd = tier
    jm, pm = _pair(jd, pd)
    port_changes = direction.startswith("jax")
    snap = str(tmp_path / "snap.npz")
    assert (jm if port_changes else pm).save_snapshot(snap) == "full"
    m = EmbeddingMatrix(DIM, dtype=pd, device="cpu") if port_changes else JaxMatrix(DIM, dtype=jd)
    assert m.adopt_snapshot(snap)
    rng = np.random.default_rng(3)
    m.upsert([chunk_key(4), chunk_key(900), chunk_key(901, 1)], [2, 1, 1],
             rng.standard_normal((3, DIM)).astype(np.float32))
    m.remove([chunk_key(7), chunk_key(11, 2)])
    assert m.save_snapshot(snap) == "delta"
    if port_changes:
        back = JaxMatrix.load_snapshot(snap, dtype=jd)
    else:
        back = EmbeddingMatrix.load_snapshot(snap, device="cpu", dtype=pd)
    assert isinstance(m, EmbeddingMatrix) is port_changes and isinstance(back, EmbeddingMatrix) is not port_changes
    assert set(back.row_of) == set(m.row_of)
    for key, row in m.row_of.items():
        np.testing.assert_array_equal(back.host_vectors_for([back.row_of[key]]), m.host_vectors_for([row]))
        assert back.source_ids[back.row_of[key]] == m.source_ids[row]


def _delta_case(case, tmp_path, make):
    """Files for one apply_snapshot_delta outcome, written by ``make`` (a
    matrix factory): (base path, base token or None)."""
    rng = np.random.default_rng(5)
    snap, other = str(tmp_path / "base.npz"), str(tmp_path / "other.npz")
    m = make(DIM)
    m.upsert([1, 2, 3], [0] * 3, rng.standard_normal((3, DIM)).astype(np.float32))
    m.save_snapshot(snap)
    if case == "stale":  # the delta of another base
        o = make(DIM)
        o.upsert([9], [0], rng.standard_normal((1, DIM)).astype(np.float32))
        o.save_snapshot(other)
        o.upsert([10], [0], rng.standard_normal((1, DIM)).astype(np.float32))
        assert o.save_snapshot(other) == "delta"
        os.replace(other + ".delta", snap + ".delta")
    elif case == "corrupt":
        with open(snap + ".delta", "wb") as f:
            f.write(b"PK\x03\x04 not a zip")
    elif case == "dim":
        o = make(DIM + 8)
        o.upsert([9], [0], rng.standard_normal((1, DIM + 8)).astype(np.float32))
        o.save_snapshot(other)
        o.upsert([10], [0], rng.standard_normal((1, DIM + 8)).astype(np.float32))
        o.save_snapshot(other)
        os.replace(other + ".delta", snap + ".delta")
    else:  # tokenless: a legacy base cannot prove the delta stale
        m.upsert([4], [0], rng.standard_normal((1, DIM)).astype(np.float32))
        assert m.save_snapshot(snap) == "delta"
        with zipfile.ZipFile(snap) as zin, zipfile.ZipFile(snap + ".strip", "w") as zout:
            for info in zin.infolist():
                if info.filename != "base_token.npy":
                    zout.writestr(info, zin.read(info.filename))
        os.replace(snap + ".strip", snap)
    return snap


@pytest.mark.parametrize("case,want", [("stale", 0), ("corrupt", -1), ("dim", -1), ("tokenless", -1)])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_apply_delta_outcomes(case, want, writer, tmp_path):
    """Both packages give the same outcome on the same files, whichever
    wrote them; the loader raises on an unusable delta."""
    make = (lambda d: JaxMatrix(d, dtype=jnp.float32)) if writer == "jax" else (
        lambda d: EmbeddingMatrix(d, dtype=torch.float32, device="cpu"))
    snap = _delta_case(case, tmp_path, make)
    pm, jm = EmbeddingMatrix(DIM, dtype=torch.float32, device="cpu"), JaxMatrix(DIM, dtype=jnp.float32)
    assert pm.apply_snapshot_delta(snap) == jm.apply_snapshot_delta(snap) == want
    if want < 0:
        with pytest.raises(ValueError, match="unusable"):
            EmbeddingMatrix.load_snapshot(snap, device="cpu", dtype=torch.float32)
    else:
        assert set(EmbeddingMatrix.load_snapshot(snap, device="cpu", dtype=torch.float32).row_of) == {1, 2, 3}


# -- Searcher.build over one database ------------------------------------------

SDIM = 24


def _insert(db, source_id, ext, vec, chunk_idx=0, item_id=None):
    with db.write() as conn:
        if item_id is None:
            item_id = conn.execute(
                "INSERT INTO items (source_id, external_id, hash, content) VALUES (?,?,?,?)",
                (source_id, ext, "", f"content {ext}"),
            ).lastrowid
        conn.execute(
            """INSERT INTO item_embeddings (item_id, chunk_idx, item_index_version, embedding,
                 model_id, model_version, seq)
               VALUES (?,?,?,?,?,?, (SELECT COALESCE(MAX(seq),0)+1 FROM item_embeddings))""",
            (item_id, chunk_idx, 1, serialize_embedding(vec), 0, 0),
        )
    return item_id


def _seeded_db(path, n=300):
    db = Database(path)
    src = add_source(db, Source(name="s", config={"type": "fs"}, location="/x", status=SourceStatus.ready(0, 0)))
    rng = np.random.default_rng(0)
    ids = [_insert(db, src.id, f"doc{i}", rng.standard_normal(SDIM).astype(np.float32)) for i in range(n)]
    for iid in ids[:40:8]:  # a few chunk-embedded items
        _insert(db, src.id, "", rng.standard_normal(SDIM).astype(np.float32), chunk_idx=1, item_id=iid)
    return db, src, ids, rng


# (writer, writer tier, reader tier): the reader adopts where the tiers
# match, else streams the base's f32 rows (the v1 route)
BUILD_CASES = [
    ("jax", "int8", "int8"), ("port", "int8", "int8"), ("jax", "int2", "int2"), ("port", "int2", "int2"),
    ("port", "int8", "bf16"), ("jax", "int2", "int4"),
]
PORT_TIER = {"int8": torch.int8, "int2": INT2, "int4": INT4, "bf16": torch.bfloat16}
JAX_TIER = {"int8": jnp.int8, "int2": JAX_INT2, "int4": JAX_INT4, "bf16": jnp.bfloat16}


@pytest.mark.parametrize("writer,wtier,rtier", BUILD_CASES, ids=["-".join(c) for c in BUILD_CASES])
def test_searcher_build_from_snapshot_matches_jax(writer, wtier, rtier, tmp_path, monkeypatch):
    monkeypatch.delenv("PERCEIVE_TPU_INT2_FINE", raising=False)
    db, src, ids, rng = _seeded_db(tmp_path / "db.sqlite3")
    jdb = JaxDatabase(tmp_path / "db.sqlite3")
    db.set_item_hidden(ids[5], True)
    snap = str(tmp_path / "snap.npz")
    if writer == "jax":
        JaxSearcher.build(jdb, 0, 0, SDIM, dtype=JAX_TIER[wtier], engine="xla").save_snapshot(jdb, snap)
    else:
        Searcher.build(db, 0, 0, SDIM, device="cpu", dtype=PORT_TIER[wtier]).save_snapshot(db, snap)
    # after the save: rows added, hidden, unhidden, deleted, one re-embedded
    new = [_insert(db, src.id, f"new{i}", rng.standard_normal(SDIM).astype(np.float32)) for i in range(3)]
    db.set_item_hidden(ids[0], True)
    db.set_item_hidden(ids[5], False)
    with db.write() as conn:
        conn.execute("DELETE FROM items WHERE id = ?", (ids[1],))
        conn.execute(
            "UPDATE item_embeddings SET embedding = ?, seq = (SELECT MAX(seq)+1 FROM item_embeddings) "
            "WHERE item_id = ?", (serialize_embedding(np.full(SDIM, 0.5, np.float32)), ids[9]))

    adopted = []
    orig = EmbeddingMatrix._adopt_snapshot_fh
    monkeypatch.setattr(EmbeddingMatrix, "_adopt_snapshot_fh",
                        lambda self, path, fh: adopted.append(orig(self, path, fh)) or adopted[-1])
    port = Searcher.build(db, 0, 0, SDIM, device="cpu", dtype=PORT_TIER[rtier])
    monkeypatch.undo()
    assert adopted == [wtier == rtier]
    cold = Searcher.build(db, 0, 0, SDIM, device="cpu", dtype=PORT_TIER[rtier], use_snapshot=False)
    ref = JaxSearcher.build(jdb, 0, 0, SDIM, dtype=JAX_TIER[rtier], engine="xla")
    keys = set(cold.matrix.row_of)
    assert set(port.matrix.row_of) == keys == set(ref.matrix.row_of)
    assert {chunk_key(new[0]), chunk_key(ids[5])} <= keys and chunk_key(ids[0]) not in keys
    assert chunk_key(ids[1]) not in keys
    np.testing.assert_array_equal(port.matrix.host_vectors_for([port.matrix.row_of[chunk_key(ids[9])]])[0],
                                  np.full(SDIM, 0.5, np.float32))
    for _ in range(4):
        q = rng.standard_normal(SDIM).astype(np.float32)
        got, want, jax_hits = port.search_vector(q, 10), cold.search_vector(q, 10), ref.search_vector(q, 10)
        assert [i for i, _ in got] == [i for i, _ in want] == [i for i, _ in jax_hits]
        tol = 2e-2 if rtier == "bf16" else 1e-5
        np.testing.assert_allclose([s for _, s in got], [s for _, s in jax_hits], atol=tol, rtol=0)
    jdb.close()
    db.close()


@pytest.mark.parametrize("stored,now,adopts", [("int8", "int4", False), ("int4", "int8", False),
                                               ("int4", "int4", True)])
def test_int2_companion_width_gates_adopt(stored, now, adopts, tmp_path, monkeypatch):
    """A base whose int2 companion is not the width this device's policy
    gives is refused by both packages; the build then streams its f32 rows
    and stages the companion the policy gives."""
    db, src, ids, rng = _seeded_db(tmp_path / "db.sqlite3")
    monkeypatch.setenv("PERCEIVE_TPU_INT2_FINE", stored)
    snap = str(tmp_path / "snap.npz")
    Searcher.build(db, 0, 0, SDIM, device="cpu", dtype=INT2).save_snapshot(db, snap)
    monkeypatch.setenv("PERCEIVE_TPU_INT2_FINE", now)
    assert EmbeddingMatrix(SDIM, dtype=INT2, device="cpu").adopt_snapshot(snap) is adopts
    assert JaxMatrix(SDIM, dtype=JAX_INT2).adopt_snapshot(snap) is adopts
    s = Searcher.build(db, 0, 0, SDIM, device="cpu", dtype=INT2)
    assert s.matrix.fine_bits == int(now[3:])
    cold = Searcher.build(db, 0, 0, SDIM, device="cpu", dtype=INT2, use_snapshot=False)
    assert set(s.matrix.row_of) == set(cold.matrix.row_of)
    q = rng.standard_normal(SDIM).astype(np.float32)
    assert s.search_vector(q, 10) == cold.search_vector(q, 10)
    db.close()


@pytest.mark.parametrize("fault", ["truncated", "missing", "device copy"])
def test_build_fallbacks(fault, tmp_path, monkeypatch):
    """A truncated or missing snapshot falls back to the load from SQLite;
    a failed device copy of an adopted payload raises instead."""
    db, src, ids, rng = _seeded_db(tmp_path / "db.sqlite3", n=40)
    snap = str(tmp_path / "snap.npz")
    Searcher.build(db, 0, 0, SDIM, device="cpu", dtype=torch.int8).save_snapshot(db, snap)
    if fault == "truncated":
        data = open(snap, "rb").read()
        with open(snap, "wb") as f:
            f.write(data[: len(data) // 2])
    elif fault == "missing":
        os.unlink(snap)
    else:
        def broken(arr, device):
            raise SnapshotDeviceError("out of memory")

        monkeypatch.setattr(port_matrix, "_to_device", broken)
        with pytest.raises(SnapshotDeviceError, match="out of memory"):
            Searcher.build(db, 0, 0, SDIM, device="cpu", dtype=torch.int8)
        return
    s = Searcher.build(db, 0, 0, SDIM, device="cpu", dtype=torch.int8)
    assert len(s.matrix) == 45
    db.close()


# -- the JAX package's race tests, on the port ---------------------------------


def _m(n=30, seed=11):
    rng = np.random.default_rng(seed)
    m = EmbeddingMatrix(16, dtype=torch.float32, device="cpu")
    m.upsert(list(range(1, n + 1)), [0] * n, rng.standard_normal((n, 16)).astype(np.float32))
    return m, rng


@pytest.mark.parametrize("race", ["remove", "overflow"])
def test_race_between_delta_decision_and_write(race, tmp_path, monkeypatch):
    """tests/test_snapshot.py:284 and :317.  A remove between the delta
    decision and the write reaches removed_keys (one lock captures sets
    and rows); tracking overflowing there demotes the save to a full base
    instead of crashing on sorted(None)."""
    m, rng = _m()
    snap = str(tmp_path / "race.npz")
    assert m.save_snapshot(snap) == "full"
    m.upsert([31], [0], rng.standard_normal((1, 16)).astype(np.float32))
    orig_info = EmbeddingMatrix._snapshot_base_info
    fired = []

    def racing_info(path):
        info = orig_info(path)
        if not fired and info[0] is not None:
            fired.append(1)
            if race == "remove":
                m.remove([5])
            else:
                m._delta_rows, m._delta_removed = None, set()
        return info

    monkeypatch.setattr(EmbeddingMatrix, "_snapshot_base_info", staticmethod(racing_info))
    assert m.save_snapshot(snap) == ("delta" if race == "remove" else "full")
    monkeypatch.setattr(EmbeddingMatrix, "_snapshot_base_info", staticmethod(orig_info))
    assert fired
    m2 = EmbeddingMatrix.load_snapshot(snap, device="cpu", dtype=torch.float32)
    assert set(m2.row_of) == set(m.row_of) and 31 in m2.row_of
    assert (5 in m2.row_of) is (race == "overflow")


@pytest.mark.parametrize("race", ["remove", "reuse"])
def test_race_during_full_stream(race, tmp_path, monkeypatch):
    """tests/test_snapshot.py:345 and :379.  A remove during the streamed
    full write reaches the next delta (the sets swap at capture); a
    tombstone reuse during it keeps the attempt from being published over
    the good base, and the swapped-out delta sets come back."""
    m, rng = _m(20 if race == "reuse" else 30)
    snap = str(tmp_path / "stream.npz")
    if race == "reuse":
        assert m.save_snapshot(snap) == "full"
        good = EmbeddingMatrix._snapshot_token(snap)
        m.upsert([21], [0], rng.standard_normal((1, 16)).astype(np.float32))
        with m._lock:
            pre = set(m._delta_rows)
        assert pre
    orig = np.ascontiguousarray
    fired = []

    def racing_copy(a, *args, **kw):
        if race == "reuse":
            with m._lock:
                m.reuse_gen += 1
        elif not fired:
            fired.append(1)
            m.remove([5])
        return orig(a, *args, **kw)

    monkeypatch.setattr(port_matrix.np, "ascontiguousarray", racing_copy)
    if race == "reuse":
        assert m._write_full_snapshot(snap, locked=False, token="bad") is False
    else:
        assert m.save_snapshot(snap) == "full"
    monkeypatch.setattr(port_matrix.np, "ascontiguousarray", orig)
    if race == "reuse":
        assert EmbeddingMatrix._snapshot_token(snap) == good
        with m._lock:
            assert pre <= m._delta_rows
    else:
        assert fired
        m.upsert([31], [0], rng.standard_normal((1, 16)).astype(np.float32))
    assert m.save_snapshot(snap) == "delta"
    m2 = EmbeddingMatrix.load_snapshot(snap, device="cpu", dtype=torch.float32)
    assert set(m2.row_of) == set(m.row_of) and len(m2) == len(m)
    if race == "remove":
        assert 5 not in m2.row_of, "the mid-save remove was lost: the load resurrected it"


def test_clear_forces_full_snapshot_and_bumps_reuse_gen(tmp_path):
    """tests/test_snapshot.py:420."""
    m, rng = _m(20)
    snap = str(tmp_path / "clr.npz")
    assert m.save_snapshot(snap) == "full"
    m.remove([5])
    gen = m.reuse_gen
    m.clear()
    assert m.reuse_gen > gen and len(m) == 0
    keys = [k for k in range(1, 21) if k != 5]
    m.upsert(keys, [0] * len(keys), rng.standard_normal((len(keys), 16)).astype(np.float32))
    assert m.save_snapshot(snap) == "full"
    m2 = EmbeddingMatrix.load_snapshot(snap, device="cpu", dtype=torch.float32)
    assert 5 not in m2.row_of and len(m2) == 19


def test_unhide_after_snapshot_returns_at_startup(tmp_path):
    """tests/test_snapshot.py:449: unhiding bumps no seq, so the load's
    reconcile must reload live keys missing from the base."""
    db, src, ids, rng = _seeded_db(tmp_path / "db.sqlite3", n=10)
    db.set_item_hidden(ids[0], True)
    s1 = Searcher.build(db, 0, 0, SDIM, device="cpu")
    assert chunk_key(ids[0]) not in s1.matrix.row_of
    s1.save_snapshot(db, str(tmp_path / "snap.npz"))
    db.set_item_hidden(ids[0], False)
    s2 = Searcher.build(db, 0, 0, SDIM, device="cpu")
    assert chunk_key(ids[0]) in s2.matrix.row_of
    s3 = Searcher.build(db, 0, 0, SDIM, device="cpu", use_snapshot=False)
    assert set(s2.matrix.row_of) == set(s3.matrix.row_of)
    db.close()


@pytest.mark.parametrize("case", ["copy", "worker error"])
def test_adopt_mirror_copy(case, tmp_path, monkeypatch):
    """tests/test_snapshot_adopt.py:302 and :326: the mirror pass over many
    small chunks on several workers copies every byte (the pad tail zero),
    and a worker's exception reaches the adopt's caller."""
    monkeypatch.setattr(port_matrix, "_MIRROR_COPY_CHUNK_BYTES", 256)
    monkeypatch.setenv("PERCEIVE_TPU_MIRROR_THREADS", "3" if case == "copy" else "2")
    m1, _ = _fill(EmbeddingMatrix(DIM, dtype=torch.int8, device="cpu"), n=67 if case == "copy" else 40)
    snap = str(tmp_path / "snap.npz")
    m1.save_snapshot(snap)
    m2 = EmbeddingMatrix(DIM, dtype=torch.int8, device="cpu")
    if case == "copy":
        assert m2.adopt_snapshot(snap)
        np.testing.assert_array_equal(m2._host_vectors[: m1.rows], m1._host_vectors[: m1.rows])
        assert not m2._host_vectors[: m1.rows, DIM:].any()
        return
    calls = []
    orig = m2._mirror.write

    def boom(rows, vals, dim):
        calls.append(rows)
        if len(calls) == 3:
            raise RuntimeError("disk gone")
        return orig(rows, vals, dim)

    monkeypatch.setattr(m2._mirror, "write", boom)
    with pytest.raises(RuntimeError, match="disk gone"):
        m2.adopt_snapshot(snap)


def test_random_ops_cross_load(tmp_path):
    """tests/test_snapshot.py:194 across the packages: random upserts,
    overwrites and removes on twin matrices, a save by one package after
    each round (full or delta) and a load by the other, equal live rows."""
    rng = np.random.default_rng(7)
    pm, jm = EmbeddingMatrix(12, dtype=torch.float32, device="cpu"), JaxMatrix(12, dtype=jnp.float32)
    psnap, jsnap = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    forms = set()
    next_key = 1
    for step in range(40):
        op = rng.integers(0, 10)
        if op < 5:
            n = int(rng.integers(1, 8))
            keys, next_key = list(range(next_key, next_key + n)), next_key + n
        elif op < 7 and pm.row_of:
            keys = [int(k) for k in rng.choice(sorted(pm.row_of), size=min(3, len(pm.row_of)), replace=False)]
        elif op < 9 and pm.row_of:
            keys = [int(k) for k in rng.choice(sorted(pm.row_of), size=min(2, len(pm.row_of)), replace=False)]
            assert pm.remove(keys) == jm.remove(keys)
            continue
        else:
            forms.add(pm.save_snapshot(psnap))
            forms.add(jm.save_snapshot(jsnap))
            a = JaxMatrix.load_snapshot(psnap, dtype=jnp.float32)
            b = EmbeddingMatrix.load_snapshot(jsnap, device="cpu", dtype=torch.float32)
            for got, want in ((a, pm), (b, jm)):
                assert set(got.row_of) == set(want.row_of), step
                for k in want.row_of:
                    np.testing.assert_array_equal(got.host_vectors_for([got.row_of[k]]),
                                                  want.host_vectors_for([want.row_of[k]]))
            continue
        v = rng.standard_normal((len(keys), 12)).astype(np.float32)
        pm.upsert(keys, [0] * len(keys), v)
        jm.upsert(keys, [0] * len(keys), v)
    assert forms == {"full", "delta"}


# -- the CLI ---------------------------------------------------------------------


def _model():
    vocab = tiny_test_vocab(["alpha", "beta", "gamma", "delta"])
    arch = EncoderArch(vocab_size=len(vocab), hidden_size=32, num_layers=1, num_heads=4,
                       intermediate_size=64, max_position_embeddings=32)
    tok = TextTokenizer.from_vocab(vocab, max_seq_length=32)
    return Model.random(arch, HeadConfig(normalize=True), tok, seed=0, device="cpu", model_id=0)


def _cli(state, *argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(list(argv), state=state)
    return rc, out.getvalue()


def test_cli_snapshot_and_autosave(tmp_path, monkeypatch):
    """``snapshot [path]`` writes the base and its manifest row; ``source
    scan`` autosaves to the data dir when it changed rows (the threshold
    monkeypatched low) and not when nothing changed; a fresh AppState then
    starts from the snapshot."""
    monkeypatch.setenv("PERCEIVE_TPU_DATA_DIR", str(tmp_path / "data"))
    monkeypatch.setattr(commands, "SNAPSHOT_MIN_ROWS", 3)
    tree = tmp_path / "tree"
    tree.mkdir()
    for i, text in enumerate(["alpha beta", "gamma delta", "beta gamma alpha", "delta"]):
        (tree / f"d{i}.txt").write_text(text)
    db = str(tmp_path / "db.sqlite3")
    model = _model()
    state = AppState(db, model=model, device="cpu")
    saves = []
    orig = Searcher.save_snapshot
    monkeypatch.setattr(Searcher, "save_snapshot", lambda self, d, p: saves.append(p) or orig(self, d, p))
    assert _cli(state, "source", "add", "fs", str(tree), "--name", "docs")[0] == 0
    assert _cli(state, "source", "scan", "docs")[0] == 0
    auto = commands._snapshot_path(state)
    assert saves == [auto] and os.path.exists(auto)
    assert auto == str(tmp_path / "data" / f"matrix-0-{model.model_version}.npz")
    assert _cli(state, "source", "scan", "docs")[0] == 0
    assert saves == [auto]  # nothing changed: no save
    (tree / "d4.txt").write_text("alpha gamma")
    assert _cli(state, "source", "scan", "docs")[0] == 0
    assert saves == [auto, auto]

    path = str(tmp_path / "explicit.npz")
    rc, out = _cli(state, "snapshot", path)
    assert rc == 0 and out == f"Saved 5 vectors to {path}\n"
    row = state.db.read().execute(
        "SELECT path, rows, dim, dtype, max_item_id FROM vector_shards WHERE model_id = 0").fetchone()
    max_seq = state.db.read().execute("SELECT MAX(seq) FROM item_embeddings").fetchone()[0]
    assert tuple(row) == (path, 5, model.dim, "bfloat16", max_seq)
    assert _cli(state, "snapshot")[1] == f"Saved 5 vectors to {auto}\n"
    state.close()

    loaded = []
    orig_load = Searcher._load_snapshot
    monkeypatch.setattr(Searcher, "_load_snapshot", lambda self, d: loaded.append(orig_load(self, d)) or loaded[-1])
    fresh = AppState(db, model=model, device="cpu")
    assert loaded == [True] and len(fresh.searcher.matrix) == 5
    rc, out = _cli(fresh, "search", "alpha gamma", "-n", "3", "--json")
    assert rc == 0 and out.strip().startswith("[")
    fresh.close()
