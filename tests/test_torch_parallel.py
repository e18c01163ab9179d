"""The port's multi-device search and encode (perceive_tpu_torch/parallel)
against the JAX package's perceive_tpu/parallel, on the CPU.

JAX's mesh runs over the 8 virtual CPU devices tests/conftest.py gives it,
with ``engine="xla"``; the port's over 8 (or 4) CPU slots of one device,
through its kernels' plain versions.  The same seeded numpy inputs go to
both.  Tolerances: rows and ids equal everywhere; the integer tiers' sweep
scores (int8, int4, the int2 coarse floors and fine scores) bit for bit;
the f32 and bf16 sweeps' scores within 1e-5 (f32 sums in another order),
reranked scores within 1e-6 relative (both rerank in f32 on the host); the
encoder within rtol 1e-4, atol 1e-5 (the JAX package's own bound for its
sharded encode, tests/test_parallel.py).
"""

import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from perceive_tpu.index.matrix import INT2 as JAX_INT2
from perceive_tpu.index.matrix import INT4 as JAX_INT4
from perceive_tpu.index.matrix import EmbeddingMatrix as JaxMatrix
from perceive_tpu.index.searcher import Searcher as JaxSearcher
from perceive_tpu.parallel import ShardedSearcher as JaxShardedSearcher
from perceive_tpu.parallel import make_mesh as jax_make_mesh
from perceive_tpu.parallel import param_specs as jax_param_specs
from perceive_tpu.parallel import sharded_scan_topk as jax_sharded_scan_topk
from perceive_tpu.parallel.mesh import ROWS_AXES as JAX_ROWS
from perceive_tpu_torch.index import matrix as port_matrix
from perceive_tpu_torch.index.matrix import INT2, INT4, EmbeddingMatrix, ShardedEmbeddingMatrix, chunk_key
from perceive_tpu_torch.index.searcher import Searcher
from perceive_tpu_torch.ops import int2 as int2_ops
from perceive_tpu_torch.parallel import (
    ShardedSearcher,
    batch_sharding,
    make_mesh,
    param_specs,
    replicated,
    rows_1d_sharding,
    rows_sharding,
    sharded_scan_topk,
)
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)

CPU = torch.device("cpu")
ALLOW_ALL = -2


def slots(n):
    return [CPU] * n


def _unit(rng, n, d):
    v = rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _allowed(ids=None):
    a = np.full(16, -9, np.int32)
    if ids is None:
        a[0] = ALLOW_ALL
    else:
        a[: len(ids)] = ids
    return a


def _same_hits(got, want, rtol=1e-6, atol=1e-7):
    assert [i for i, _ in got] == [i for i, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=rtol, atol=atol)


# -- the mesh ------------------------------------------------------------------------


def test_mesh_shapes_and_param_specs():
    for n, mp in ((8, 1), (8, 2), (4, 1), (4, 4)):
        m = make_mesh(n, model_parallel=mp, devices=slots(8))
        assert m.shape == dict(jax_make_mesh(n, model_parallel=mp).shape)
        assert m.size == n and len(m.flat) == n and m.lead == CPU
        t = torch.arange(n * 3).reshape(n, 3)
        assert list(replicated(t, m)) == [CPU] and replicated(t, m)[CPU] is t
        parts = batch_sharding(t, m)
        assert len(parts) == m.shape["data"] and torch.equal(torch.cat(parts), t)
    for bad in (dict(n_devices=9), dict(n_devices=6, model_parallel=4)):
        with pytest.raises(ValueError):
            make_mesh(devices=slots(8), **bad)
    with pytest.raises(ValueError):
        jax_make_mesh(9)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_mesh()  # no CPU fallback
    from perceive_tpu.models.encoder import EncoderArch as JaxArch
    from perceive_tpu.models.encoder import HeadConfig as JaxHead
    from perceive_tpu.models.encoder import init_params as jax_init

    params = jax_init(jax.random.PRNGKey(0), JaxArch(vocab_size=50, hidden_size=32, num_layers=2, num_heads=4,
                                                     intermediate_size=64, max_position_embeddings=16),
                      JaxHead(pooling="mean", dense_dim=16))
    want = {g: {n: (tuple(s).index("model") if "model" in tuple(s) else None) for n, s in sub.items()}
            for g, sub in jax_param_specs(params).items()}
    assert param_specs(params) == want


# -- sharded_scan_topk ---------------------------------------------------------------


@pytest.mark.parametrize("filt", [None, [0, 2]], ids=["all", "filter"])
@pytest.mark.parametrize("tier", ["float32", "bfloat16", "int8", "int4"])
def test_sharded_scan_topk_matches_jax(tier, filt):
    n, d, nq, k = 4096, 64, 3, 16
    rng = np.random.default_rng(0)
    matrix = rng.standard_normal((n, d)).astype(np.float32)
    src = rng.integers(0, 4, n).astype(np.int32)
    src[::17] = -1
    q = rng.standard_normal((nq, d)).astype(np.float32)
    allowed = _allowed(filt)
    pmesh, jmesh = make_mesh(8, devices=slots(8)), jax_make_mesh(8)
    rows_spec, cols_spec = NamedSharding(jmesh, P(JAX_ROWS, None)), NamedSharding(jmesh, P(None, JAX_ROWS))
    one_d = NamedSharding(jmesh, P(JAX_ROWS))
    scales = jscales = None
    if tier in ("float32", "bfloat16"):
        pm = rows_sharding(torch.from_numpy(matrix).to(getattr(torch, tier)), pmesh)
        jm = jax.device_put(jnp.asarray(matrix, dtype=getattr(jnp, tier)), rows_spec)
    else:
        packed, sc = (port_matrix._quantize if tier == "int8" else port_matrix._quantize4)(matrix)
        if tier == "int4":  # the device layout is the (D/2, N) transpose
            packed = np.ascontiguousarray(packed.T)
        pm = rows_sharding(torch.from_numpy(packed), pmesh, axis=1 if tier == "int4" else 0)
        jm = jax.device_put(jnp.asarray(packed), cols_spec if tier == "int4" else rows_spec)
        scales, jscales = rows_1d_sharding(torch.from_numpy(sc), pmesh), jax.device_put(jnp.asarray(sc), one_d)
    vals, rows = sharded_scan_topk(pmesh, pm, rows_1d_sharding(torch.from_numpy(src), pmesh), torch.from_numpy(q),
                                   torch.from_numpy(allowed), k, scales=scales)
    wv, wr = jax_sharded_scan_topk(jmesh, jm, jax.device_put(jnp.asarray(src), one_d), jnp.asarray(q),
                                   jnp.asarray(allowed), k, engine="xla", scales=jscales)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(wr))
    if tier in ("int8", "int4"):
        np.testing.assert_array_equal(vals.numpy(), np.asarray(wv))
    else:
        np.testing.assert_allclose(vals.numpy(), np.asarray(wv), rtol=0, atol=1e-5)
    if filt is not None:
        assert np.isin(src[rows.numpy()[rows.numpy() >= 0]], filt).all()
    if scales is None:
        return
    with pytest.raises(ValueError):
        sharded_scan_topk(pmesh, pm, rows_1d_sharding(torch.from_numpy(src), pmesh), torch.from_numpy(q),
                          torch.from_numpy(allowed), k)


# -- ShardedSearcher end to end ---------------------------------------------------------

# (id, JAX dtype, port dtype, PERCEIVE_TPU_INT2_FINE)
TIERS = [
    ("f32", jnp.float32, torch.float32, None),
    ("bf16", jnp.bfloat16, torch.bfloat16, None),
    ("int8", jnp.int8, torch.int8, None),
    ("int4", JAX_INT4, INT4, None),
    ("int2+int8", JAX_INT2, INT2, "int8"),
    ("int2+int4", JAX_INT2, INT2, "int4"),
]


@pytest.fixture(params=TIERS, ids=[t[0] for t in TIERS])
def tier(request, monkeypatch):
    name, jd, pd, fine = request.param
    if fine is None:
        monkeypatch.delenv("PERCEIVE_TPU_INT2_FINE", raising=False)
    else:
        monkeypatch.setenv("PERCEIVE_TPU_INT2_FINE", fine)
    return name, jd, pd


def test_sharded_searcher_matches_jax(tier):
    """Single queries (filtered too), a batch of 8, upserts and removals, at
    each tier over 8 slots; at int2 the self-audit's verdict too."""
    name, jd, pd = tier
    rng = np.random.default_rng(2)
    n, d = 3000, 48
    vecs = _unit(rng, n, d)
    ids, srcs = list(range(1, n + 1)), [i % 3 for i in range(n)]
    p = ShardedSearcher(0, 0, d, make_mesh(8, devices=slots(8)), dtype=pd)
    j = JaxShardedSearcher(0, 0, d, jax_make_mesh(8), dtype=jd, engine="xla")
    for s in (p, j):
        s.upsert_embeddings(ids, srcs, vecs)
    assert p.matrix.capacity == j.matrix.capacity and p.matrix.n_local == p.matrix.capacity // 8
    if p.matrix.packed2:
        assert p.matrix.fine_bits == j.matrix.fine_bits
        for key in ("trusted", "overlap", "min_overlap", "fetch", "queries"):
            assert p.coarse_audit[key] == j.coarse_audit[key], key
    tol = dict(rtol=1e-5, atol=1e-5) if name in ("f32", "bf16") else {}
    qs = _unit(rng, 8, d)
    for q in qs[:3]:
        _same_hits(p.search_vector(q, 12), j.search_vector(q, 12), **tol)
        _same_hits(p.search_vector(q, 12, [1]), j.search_vector(q, 12, [1]), **tol)
    for g, w in zip(p.search_vectors_batch(qs, 10), j.search_vectors_batch(qs, 10)):
        _same_hits(g, w, **tol)
    for s in (p, j):
        s.remove_items([int(i) for i, _ in s.search_vector(qs[0], 3)])
        s.upsert_embeddings([5000], [1], qs[1:2])
    _same_hits(p.search_vector(qs[0], 10), j.search_vector(qs[0], 10), **tol)
    if tol == {}:  # the quantized tiers' rerank bookkeeping
        assert (p.escalations, p.scan_calls) == (j.escalations, j.scan_calls)
    assert p.search_vector(qs[1], 1)[0][0] == j.search_vector(qs[1], 1)[0][0] == 5000


def _clustered(rng, n_cluster, n_bg, d, spread):
    center = _unit(rng, 1, d)[0]
    cluster = center[None, :] + spread * _unit(rng, n_cluster, d)
    cluster /= np.linalg.norm(cluster, axis=1, keepdims=True)
    return np.concatenate([cluster, _unit(rng, n_bg, d)]).astype(np.float32)


@pytest.mark.parametrize("fine", ["int8", "int4"])
def test_int2_companions_floors_audit_and_ranks(fine, monkeypatch):
    """A dense-tie corpus over 4 slots: the self-audit's verdict (it
    demotes) equals JAX's; its global rank counts equal those of JAX's
    coarse scores over the joined shards; the coarse route's sweep equals
    JAX's, its floor bit for bit and equal to the max over each shard's own
    plain pipeline; the demoted hits equal JAX's.  The audit draws 8
    samples: JAX runs its sharded rank counts eagerly, about 10 s a batch
    of 8 on the CPU."""
    monkeypatch.setenv("PERCEIVE_TPU_INT2_FINE", fine)
    monkeypatch.setenv("PERCEIVE_TPU_COARSE_AUDIT", "8")
    rng = np.random.default_rng(2)
    d = 64
    rows = _clustered(rng, n_cluster=20_000, n_bg=4_576, d=d, spread=0.2)
    ids = list(range(1, len(rows) + 1))
    p = ShardedSearcher(0, 0, d, make_mesh(4, devices=slots(4)), dtype=INT2)
    j = JaxShardedSearcher(0, 0, d, jax_make_mesh(4), dtype=JAX_INT2, engine="xla")
    for s in (p, j):
        s.upsert_embeddings(ids, [0] * len(rows), rows)
    m = p.matrix
    assert m.fine_bits == j.matrix.fine_bits == (8 if fine == "int8" else 4)
    assert not p.coarse_audit["trusted"] and not m.coarse_trusted
    for key in ("trusted", "overlap", "min_overlap", "fetch"):
        assert p.coarse_audit[key] == j.coarse_audit[key], key
    q = rows[37] + 0.01 * _unit(rng, 1, d)[0]
    q /= np.linalg.norm(q)
    _same_hits(p.search_vector(q, 10), j.search_vector(q, 10))

    qp = p._pad_queries(_unit(rng, 2, d))
    allowed = p._allowed_arrays(None)[0]
    kb = 128
    pv, pr, pf = p._device_scan(qp, kb, allowed, use_coarse=True, force_coarse=True)
    jv, jr, jf = j._device_scan(qp, kb, allowed, "xla", use_coarse=True, force_coarse=True)
    np.testing.assert_array_equal(pr, jr)
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(pf, jf)
    (p2, fine_t), src, (s2, fs) = m.device_view()
    shard_floors = [
        int2_ops.scan_int2_coarse_fine_plain(p2[s], s2[s], fine_t[s], fs[s], src[s], torch.from_numpy(qp),
                                             torch.from_numpy(allowed), kb, fetch=m.coarse_fetch)[2].numpy()
        for s in range(4)
    ]
    np.testing.assert_array_equal(pf, np.max(shard_floors, axis=0))
    assert np.isfinite(pf).all()

    # the audit's global ranks against JAX's coarse scores over the joined
    # shards (its sharded rank counts run eagerly: ~10 s a call on the CPU)
    from perceive_tpu.ops.topk import quantize_queries as jax_quantize
    from perceive_tpu.ops.topk import xla_scores_int2

    ref_rows = np.stack([pr[0, :10], pr[1, :10]]).astype(np.int32)
    ref_rows[1, 7:] = -1
    qi8, qscale = jax_quantize(jnp.asarray(qp))
    coarse = np.array(xla_scores_int2(jnp.asarray(torch.cat(p2, 1).numpy()), jnp.asarray(torch.cat(s2).numpy()),
                                      qi8, qscale))
    coarse[:, torch.cat(src).numpy() < 0] = -np.inf
    thr = np.take_along_axis(coarse, np.maximum(ref_rows, 0), 1)
    want = np.stack([(coarse >= thr[:, c : c + 1]).sum(axis=1) for c in range(10)], axis=1)
    np.testing.assert_array_equal(p._audit_rank_counts(qp, ref_rows), np.where(ref_rows >= 0, want, 0))


def test_overfetch_deeper_than_a_shard():
    """600 rows over 4 slots (512 rows a shard): int8's over-fetch at k=200
    asks each shard for more candidates than it holds."""
    rng = np.random.default_rng(11)
    n, d = 600, 24
    vecs = _unit(rng, n, d)
    p = ShardedSearcher(0, 0, d, make_mesh(4, devices=slots(4)), dtype=torch.int8)
    j = JaxShardedSearcher(0, 0, d, jax_make_mesh(4), dtype=jnp.int8, engine="xla")
    one = Searcher(0, 0, d, device="cpu", dtype=torch.float32)
    for s in (p, j, one):
        s.upsert_embeddings(list(range(1, n + 1)), [0] * n, vecs)
    assert p.matrix.n_local == 512
    got = p.search_vector(vecs[77], 200)
    _same_hits(got, j.search_vector(vecs[77], 200))
    _same_hits(got, one.search_vector(vecs[77], 200), rtol=1e-5)


def test_retier_keys_on_one_shards_rows(monkeypatch):
    """The auto rule sees rows / slots, and a flip to int2 audits afresh,
    as in JAX; every shard's tensors are restaged in the new layout."""
    seen, jseen = [], []

    def fake(record):
        def auto(n, padded_dim=384):
            record.append(n)
            return "int2" if n >= 300 else (torch.int8 if record is seen else jnp.int8)
        return auto

    monkeypatch.setattr("perceive_tpu_torch.index.matrix.auto_matrix_dtype", fake(seen))
    monkeypatch.setattr("perceive_tpu.index.matrix.auto_matrix_dtype", fake(jseen))
    rng = np.random.default_rng(3)
    d = 32
    p = ShardedSearcher(0, 0, d, make_mesh(4, devices=slots(4)), dtype=torch.int8)
    j = JaxShardedSearcher(0, 0, d, jax_make_mesh(4), dtype=jnp.int8, engine="xla")
    for s in (p, j):
        s.auto_retier = True
    for lo in (1, 801):
        v = _unit(rng, 800, d)
        for s in (p, j):
            s.upsert_embeddings(list(range(lo, lo + 800)), [0] * 800, v)
        assert seen[-1] == jseen[-1] == (200 if lo == 1 else 400)
        assert p.matrix.packed2 == j.matrix.packed2 == (lo == 801)
    assert p.coarse_audit["trusted"] == j.coarse_audit["trusted"]
    (p2, fine), src, _ = p.matrix.device_view()
    nl = p.matrix.n_local
    assert [t.shape for t in p2] == [(p.matrix.padded_dim // 4, nl)] * 4 and [t.shape for t in src] == [(nl,)] * 4
    q = _unit(rng, 1, d)[0]
    _same_hits(p.search_vector(q, 10), j.search_vector(q, 10))


# -- snapshots across shard counts ------------------------------------------------------

SNAP_DIM = 40


def _fill(m, n=700, seed=0):
    """n items (every 5th with two more chunks), three sources, three keys
    tombstoned; grows past the first capacity."""
    rng = np.random.default_rng(seed)
    keys, srcs = [], []
    for i in range(n):
        ks = [chunk_key(i + 1)] + ([chunk_key(i + 1, 1), chunk_key(i + 1, 2)] if i % 5 == 0 else [])
        keys += ks
        srcs += [1 + i % 3] * len(ks)
    m.upsert(keys, srcs, rng.standard_normal((len(keys), SNAP_DIM)).astype(np.float32))
    m.remove([chunk_key(2), chunk_key(3), chunk_key(6, 1)])
    m.sync()
    return m


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist() if n != "base_token.npy"}


def _joined(view, transposed: bool, n: int) -> list:
    """A device_view as numpy arrays, shards joined along the capacity axis,
    cut to the first n rows."""
    def arr(x):
        if isinstance(x, list):
            x = torch.cat(x, dim=1 if transposed and x[0].dim() == 2 else 0)
        x = x.float() if x.dtype == torch.bfloat16 else x
        return x.numpy()

    out = []
    for part in view:
        for a in (part if isinstance(part, tuple) else (part,)):
            if a is not None:
                a = arr(a)
                out.append(a[:, :n] if transposed and a.ndim == 2 else a[:n])
    return out


def test_sharded_snapshot_bytes_and_adopt_across_shard_counts(tier, tmp_path):
    """A base written by the one-device matrix, by a 4-slot matrix, by the
    JAX package's matrix and by its 4-device sharded matrix: every member
    but base_token byte for byte the same; each adopts at 1, 2 and 8
    slots, with the host state and the device tensors (shards joined) of
    the one-device adopt."""
    name, jd, pd = tier
    writers = {
        "port": _fill(EmbeddingMatrix(SNAP_DIM, dtype=pd, device="cpu")),
        "port4": _fill(ShardedEmbeddingMatrix(SNAP_DIM, devices=slots(4), dtype=pd)),
        "jax": _fill(JaxMatrix(SNAP_DIM, dtype=jd)),
        "jax4": _fill(JaxShardedSearcher(0, 0, SNAP_DIM, jax_make_mesh(4), dtype=jd, engine="xla").matrix),
    }
    paths = {}
    for w, m in writers.items():
        paths[w] = str(tmp_path / f"{w}.npz")
        assert m.save_snapshot(paths[w]) == "full"
    base = _members(paths["port"])
    for w in writers:
        assert _members(paths[w]) == base, w
    ref = EmbeddingMatrix(SNAP_DIM, dtype=pd, device="cpu")
    assert ref.adopt_snapshot(paths["jax4"])
    n = ref.rows
    transposed = ref.packed2 or ref.packed4
    want = _joined(ref.device_view(), transposed, n)
    for w, path in paths.items():
        for s in (2, 8):
            m = ShardedEmbeddingMatrix(SNAP_DIM, devices=slots(s), dtype=pd)
            assert m.adopt_snapshot(path), (w, s)
            assert (m.rows, m.row_of, m._free) == (n, ref.row_of, ref._free)
            assert m.capacity % (512 * s) == 0
            got = _joined(m.device_view(), transposed, n)
            for g, r in zip(got, want):
                np.testing.assert_array_equal(g, r, err_msg=f"{w} at {s} slots")
            if m.packed2:
                assert m.fine_bits == ref.fine_bits


# -- the encode -------------------------------------------------------------------------

WORDS = ["alpha", "beta", "gamma", "delta", "search", "vector"]


def _models(seed=0, max_seq=32):
    """(JAX model, port model) with the same weights (the JAX package's
    tests/test_parallel.py tiny model)."""
    from perceive_tpu.models import EncoderArch as JaxArch
    from perceive_tpu.models import HeadConfig as JaxHead
    from perceive_tpu.models import Model as JaxModel
    from perceive_tpu.models import TextTokenizer as JaxTokenizer
    from perceive_tpu.models import tiny_test_vocab as jax_vocab
    from perceive_tpu_torch.models import EncoderArch, HeadConfig, Model, TextTokenizer, tiny_test_vocab
    from perceive_tpu_torch.models.convert import params_from_jax

    kw = dict(vocab_size=len(jax_vocab(WORDS)), hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
              max_position_embeddings=max_seq)
    jm = JaxModel.random(JaxArch(**kw), JaxHead(pooling="mean", normalize=True),
                         JaxTokenizer.from_vocab(jax_vocab(WORDS), max_seq_length=max_seq), seed=seed,
                         compute_dtype=jnp.float32, attention_impl="xla", model_id=0)
    pm = Model(params_from_jax(jax.tree.map(np.asarray, jm.params)), EncoderArch(**kw),
               HeadConfig(pooling="mean", normalize=True),
               TextTokenizer.from_vocab(tiny_test_vocab(WORDS), max_seq_length=max_seq), device="cpu",
               compute_dtype=torch.float32, model_id=0)
    return jm, pm


@pytest.mark.parametrize("model_parallel", [1, 2])
def test_shard_over_matches_jax(model_parallel):
    """Data-parallel (model axis 1) and data x tensor parallel (2) encodes
    over 8 slots equal JAX's shard_over and the port's one-device encode:
    a batch of 16, a single query (the lead path), token windows."""
    from perceive_tpu_torch.models.encoder import TensorParallelEncoder

    jm, pm = _models()
    _, one = _models()
    jm.shard_over(jax_make_mesh(8, model_parallel=model_parallel))
    pm.shard_over(make_mesh(8, model_parallel=model_parallel, devices=slots(8)))
    assert len(pm._data_slots) == 8 // model_parallel
    assert isinstance(pm.encoder, TensorParallelEncoder) == (model_parallel > 1)
    texts = [" ".join(np.random.default_rng(i).choice(WORDS, 5)) for i in range(16)]
    tol = dict(rtol=1e-4, atol=1e-5)
    got = pm.materialize(pm.encode_dispatch(texts))
    np.testing.assert_allclose(got, jm.materialize(jm.encode_dispatch(texts)), **tol)
    np.testing.assert_allclose(got, one.materialize(one.encode_dispatch(texts)), **tol)
    np.testing.assert_allclose(pm.encode_query("alpha beta"), jm.encode_query("alpha beta"), **tol)
    win = [[5, 6, 7], [6, 7]]
    np.testing.assert_allclose(pm.materialize(pm.encode_dispatch_token_windows(win)),
                               jm.materialize(jm.encode_dispatch_token_windows(win)), **tol)


def test_scan_through_a_sharded_model_into_a_sharded_searcher(tmp_path):
    """The ingest pipeline with the model spread over 8 slots feeding a
    ShardedSearcher's hooks, beside JAX's over its mesh: the same counts and
    the same hits by external id."""
    from perceive_tpu.db import Database as JaxDatabase
    from perceive_tpu.db import add_source as jax_add_source
    from perceive_tpu.sources import scan_source as jax_scan
    from perceive_tpu.types import Source as JaxSource
    from perceive_tpu_torch.db import Database, add_source
    from perceive_tpu_torch.sources import scan_source
    from perceive_tpu_torch.types import Source

    jm, pm = _models()
    jmesh, pmesh = jax_make_mesh(8), make_mesh(8, devices=slots(8))
    jm.shard_over(jmesh)
    pm.shard_over(pmesh)
    docs = tmp_path / "docs"
    docs.mkdir()
    rng = np.random.default_rng(0)
    for i in range(40):
        (docs / f"d{i}.txt").write_text(" ".join(rng.choice(WORDS, 12)))
    q = " ".join(rng.choice(WORDS, 12))
    found = []
    for db, add, src_t, scan, model, searcher in (
        (Database(tmp_path / "p.sqlite3"), add_source, Source, scan_source, pm,
         ShardedSearcher(0, 0, pm.dim, pmesh, dtype=torch.float32)),
        (JaxDatabase(tmp_path / "j.sqlite3"), jax_add_source, JaxSource, jax_scan, jm,
         JaxShardedSearcher(0, 0, jm.dim, jmesh, dtype=jnp.float32, engine="xla")),
    ):
        src = add(db, src_t(name="m", config={"type": "fs"}, location=str(docs)))
        stats, ok = scan(db, model, src, on_embeddings=searcher.upsert_embeddings, embed_batch_size=16)
        assert ok and stats.added.value == 40 and len(searcher.matrix) == 40
        ext = dict(db.read().execute("SELECT id, external_id FROM items").fetchall())
        found.append([(ext[i], s) for i, s in searcher.search_vector(model.encode_query(q), 5)])
        db.close()
    assert [e for e, _ in found[0]] == [e for e, _ in found[1]]
    np.testing.assert_allclose([s for _, s in found[0]], [s for _, s in found[1]], rtol=1e-4, atol=1e-5)


def test_appstate_takes_the_sharded_route(tmp_path, monkeypatch):
    """With more than one serving device (the count monkeypatched) AppState
    builds a ShardedSearcher over all of them and spreads the model's encode;
    its hits equal JAX's ShardedSearcher built from the same database, and
    the CLI's search runs through it.  With one device it stays a Searcher."""
    from perceive_tpu.db import Database as JaxDatabase
    from perceive_tpu_torch.cli import AppState, main
    from perceive_tpu_torch.cli import state as state_mod
    from perceive_tpu_torch.db import Database, add_source
    from perceive_tpu_torch.index.matrix import serialize_embedding
    from perceive_tpu_torch.types import Source

    _, pm = _models()
    path = tmp_path / "db.sqlite3"
    db = Database(path)
    src = add_source(db, Source(name="s", config={"type": "fs"}, location="/x"))
    rng = np.random.default_rng(5)
    vecs = _unit(rng, 300, pm.dim)
    with db.write() as conn:
        for i, v in enumerate(vecs):
            cur = conn.execute("INSERT INTO items (source_id, external_id, hash, content) VALUES (?,?,?,?)",
                               (src.id, f"d{i}", "", " ".join(rng.choice(WORDS, 6))))
            conn.execute("INSERT INTO item_embeddings (item_id, item_index_version, embedding, model_id, "
                         "model_version, seq) VALUES (?,?,?,0,0,?)", (cur.lastrowid, 1, serialize_embedding(v), i + 1))
    db.close()
    monkeypatch.setenv("PERCEIVE_TPU_MATRIX_DTYPE", "float32")
    monkeypatch.setattr(state_mod, "serving_devices", lambda dev: [dev] * 8)
    st = AppState(str(path), model=pm, highlights_model=pm, device="cpu")
    assert isinstance(st.searcher, ShardedSearcher) and st.searcher.mesh.size == 8
    assert len(pm._data_slots) == 8 and len(st.searcher.matrix) == 300
    jdb = JaxDatabase(path)
    j = JaxShardedSearcher.build(jdb, 0, 0, pm.dim, jax_make_mesh(8), dtype=jnp.float32, engine="xla")
    for q in vecs[[3, 150]]:
        _same_hits(st.searcher.search_vector(q, 10), j.search_vector(q, 10), rtol=1e-5, atol=1e-6)
    jdb.close()
    assert main(["--db", str(path), "search", "alpha beta", "--json"], state=st) == 0
    st.close()

    # the auto tier keys on one shard's rows
    seen = []
    monkeypatch.setenv("PERCEIVE_TPU_MATRIX_DTYPE", "auto")
    monkeypatch.setattr("perceive_tpu_torch.index.matrix.auto_matrix_dtype",
                        lambda n, padded_dim=384: seen.append(n) or torch.bfloat16)
    st = AppState(str(path), model=_models()[1], device="cpu")
    assert isinstance(st.searcher, ShardedSearcher) and seen[0] == -(-300 // 8)
    st.close()
    monkeypatch.undo()
    st = AppState(str(path), model=_models()[1], device="cpu")
    assert type(st.searcher) is Searcher and st.model._data_slots is None
    st.close()


def test_dryrun_multichip_at_8_slots():
    from perceive_tpu_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(8, devices=slots(8))
    assert out["mesh"] == dict(jax_make_mesh(8, model_parallel=2).shape)
    assert out["adopt_mesh"] == {"data": 8, "model": 1}
    assert out["top1"][0] == out["int2_top1"][0] == out["rebuild_top1"][0] == 1 and out["removed"] == 2
