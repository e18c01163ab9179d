"""One ingest + serve step over a mesh at tiny shapes.

The port's counterpart of the JAX package's ``dryrun_multichip``
(``__graft_entry__.py``): the data- and tensor-parallel encode, a sharded
bf16 search, the fused text query, the int2 tier sharded, an adopt onto
another mesh shape, remove and compact, and ``rebuild_source`` against
SQLite, each checked as it runs.

    python -c "from perceive_tpu_torch.parallel.dryrun import dryrun_multichip; dryrun_multichip(4)"

runs over the first 4 visible CUDA devices; ``devices=[torch.device("cpu")]
* 8`` (or ``[torch.device("cuda:0")] * 4`` on one card) repeats slots of
one device.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch

from .mesh import make_mesh
from .search import ShardedSearcher


def _tiny_model(device, seq: int):
    from ..models import EncoderArch, HeadConfig, Model, TextTokenizer, tiny_test_vocab

    tok = TextTokenizer.from_vocab(tiny_test_vocab(["alpha", "beta", "gamma", "delta"]), max_seq_length=seq)
    arch = EncoderArch(vocab_size=len(tok.tokenizer.vocab), hidden_size=64, num_layers=2, num_heads=4,
                       intermediate_size=128, max_position_embeddings=seq)
    return Model.random(arch, HeadConfig(pooling="mean", normalize=True), tok, seed=0, device=device)


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None) -> dict:
    """Run the steps over an ``n_devices``-slot mesh (model-parallel 2 when
    n_devices is even and at least 4) and return what each produced;
    raises AssertionError at the first step that disagrees."""
    rng = np.random.default_rng(0)
    mp = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = make_mesh(n_devices, model_parallel=mp, devices=devices)
    dp_mesh = make_mesh(n_devices, devices=mesh.flat)
    lead = mesh.lead
    out: dict = {"mesh": mesh.shape}

    # step 1: the data- and tensor-parallel encode against the one-device one
    b = max(8, n_devices)
    b -= b % n_devices
    texts = [" ".join(rng.choice(["alpha", "beta", "gamma", "delta"], 6)) for _ in range(b)]
    one = _tiny_model(lead, 32)
    want = one.materialize(one.encode_dispatch(texts))
    for name, m in (("dp", dp_mesh), ("tp", mesh)):
        model = _tiny_model(lead, 32).shard_over(m)
        got = model.materialize(model.encode_dispatch(texts))
        assert got.shape == (b, 64) and np.isfinite(got).all(), got.shape
        assert np.allclose(got, want, rtol=1e-4, atol=1e-5), f"{name} encode differs: {np.abs(got - want).max()}"
    out["encode"] = got.shape

    # step 2: the row-sharded bf16 matrix, a self match and a filter
    d, n_rows = 384, 512 * n_devices
    vecs = rng.standard_normal((n_rows, d)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    ids, srcs = list(range(1, n_rows + 1)), [i % 3 for i in range(n_rows)]
    s1 = ShardedSearcher(0, 0, d, mesh, dtype=torch.bfloat16)
    s1.upsert_embeddings(ids, srcs, vecs)
    hits = s1.search_vector(vecs[0], 10)
    assert hits and hits[0][0] == 1, f"self-match failed: {hits[:3]}"
    assert all((i - 1) % 3 == 2 for i, _ in s1.search_vector(vecs[0], 10, source_ids=[2]))
    out["top1"] = hits[0]

    # step 3: the fused text query on the mesh, with the aux encode
    s2 = ShardedSearcher(0, 0, model.dim, mesh, dtype=torch.bfloat16)
    s2.upsert_embeddings(list(range(1, b + 1)), [0] * b, got)
    fhits = s2.search_fused(model, texts[0], 3)
    assert fhits and [i for i, _ in fhits] == [i for i, _ in s2.search(model, texts[0], 3)], fhits
    fhits2, aq = s2.search_fused(model, texts[0], 3, aux_model=model)
    assert fhits2 == fhits and aq is not None and aq.shape[-1] == model.dim
    out["fused_top1"] = fhits[0]

    # step 4: the int2 tier sharded, with its self-audit
    from ..index.matrix import INT2

    s3 = ShardedSearcher(0, 0, d, mesh, dtype=INT2)
    s3.upsert_embeddings(ids, srcs, vecs)
    assert s3.matrix.packed2
    if os.environ.get("PERCEIVE_TPU_COARSE_AUDIT", "12") != "0":
        assert s3.coarse_audit is not None
    i2hits = s3.search_vector(vecs[0], 10)
    assert i2hits and i2hits[0][0] == 1, f"int2 self-match failed: {i2hits[:3]}"
    out["int2_top1"] = i2hits[0]

    # step 5: a snapshot adopted onto another mesh shape, the same hits
    tmpd = tempfile.mkdtemp(prefix="dryrun_snap_")
    try:
        snap = os.path.join(tmpd, "base.npz")
        s3.matrix.save_snapshot(snap)
        half = max(n_devices // 2, 1)
        mesh2 = make_mesh(half, devices=mesh.flat[:half]) if mp == 1 else dp_mesh
        s4 = ShardedSearcher(0, 0, d, mesh2, dtype=INT2)
        assert s4.matrix.adopt_snapshot(snap), "the sharded adopt onto another mesh shape failed"
        a_src = [i for i, _ in s3.search_vector(vecs[0], 10)]
        a_dst = [i for i, _ in s4.search_vector(vecs[0], 10)]
        assert a_src == a_dst, f"adopt rank drift: {a_src} vs {a_dst}"
        out["adopt_mesh"] = mesh2.shape
    finally:
        shutil.rmtree(tmpd, ignore_errors=True)

    # step 6: remove and compact on the mesh
    n_rm = s3.remove_items([2, 3])
    assert n_rm == 2, n_rm
    assert all(i not in (2, 3) for i, _ in s3.search_vector(vecs[1], 10))
    s3.matrix.compact()
    c_hits = s3.search_vector(vecs[0], 10)
    assert c_hits and c_hits[0][0] == 1, f"post-compact: {c_hits[:3]}"
    out["removed"] = n_rm

    # step 7: rebuild_source against SQLite
    from ..db import Database, add_source
    from ..index.matrix import serialize_embedding
    from ..types import Source

    tmpd = tempfile.mkdtemp(prefix="dryrun_db_")
    try:
        db = Database(os.path.join(tmpd, "dry.sqlite3"))
        src = add_source(db, Source(name="a", config={"type": "fs"}, location="/x"))
        mid, mver = db.read().execute("SELECT model_id, version FROM model_versions ORDER BY model_id LIMIT 1").fetchone()
        dvecs = rng.standard_normal((24, d)).astype(np.float32)
        dvecs /= np.linalg.norm(dvecs, axis=1, keepdims=True)
        with db.write() as conn:
            for i in range(24):
                cur = conn.execute("INSERT INTO items (source_id, external_id, hash, content) VALUES (?,?,?,?)",
                                   (src.id, f"d{i}", "", "c"))
                conn.execute(
                    "INSERT INTO item_embeddings (model_id, model_version, item_id, chunk_idx, "
                    "item_index_version, embedding, seq) VALUES (?,?,?,0,0,?,?)",
                    (mid, mver, cur.lastrowid, serialize_embedding(dvecs[i]), i + 1))
        s5 = ShardedSearcher.build(db, mid, mver, d, mesh)
        assert len(s5.matrix) == 24
        with db.write() as conn:
            conn.execute("UPDATE item_embeddings SET embedding = ? WHERE item_id = "
                         "(SELECT id FROM items WHERE external_id = 'd0')", (serialize_embedding(-dvecs[0]),))
        s5.rebuild_source(db, src.id)
        rb = s5.search_vector(-dvecs[0], 3)
        assert rb and np.isclose(rb[0][1], 1.0, atol=1e-2), rb[:3]
        db.close()
        out["rebuild_top1"] = rb[0]
    finally:
        shutil.rmtree(tmpd, ignore_errors=True)
    return out
