"""The port's searcher at the int2 tier against the JAX package's
(``engine="xla"``, int8 companion), on the CPU.

Same seeded numpy inputs to both.  Tolerances: the same ids in the same
order, scores within 1e-6 relative (both rerank in f32 on the host), the
same escalation count; the fused text path within 1e-4 (the two encoders
round differently).  The self-audit: the same ``coarse_trusted`` and
``coarse_fetch`` verdicts and the same overlap (the port has no approximate
select, so the JAX audit's ``select`` string is not compared).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceive_tpu.index.matrix import INT2 as JAX_INT2
from perceive_tpu.index.searcher import Searcher as JaxSearcher
from perceive_tpu_torch.cli.state import storage_tier
from perceive_tpu_torch.index import BatchingSearchExecutor
from perceive_tpu_torch.index.matrix import INT2, INT4
from perceive_tpu_torch.index.searcher import RERANK_FACTOR, Searcher
from perceive_tpu_torch.ops import int2, topk
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _same_hits(got, want, rtol=1e-6):
    assert [i for i, _ in got] == [i for i, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=rtol, atol=1e-7)


@pytest.fixture(autouse=True)
def _int8_companion(monkeypatch):
    monkeypatch.setenv("PERCEIVE_TPU_INT2_FINE", "int8")


def _pair(d, keys, srcs, vecs):
    p = Searcher(0, 0, d, device="cpu", dtype=INT2)
    j = JaxSearcher(0, 0, d, dtype=JAX_INT2, engine="xla")
    for s in (p, j):
        s.upsert_embeddings(keys, srcs, vecs)
    return p, j


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(4)
    n, d = 8192, 64
    return rng, d, _unit(rng.standard_normal((n, d)))


def test_int2_searcher_matches_jax(corpus):
    """Q = 1 (the coarse path, filtered too), Q = 8 (the companion, K7's
    route) and Q = 256 (K8's), then upserts and removals; the audit's
    verdict on this isotropic corpus."""
    rng, d, vecs = corpus
    n, k = len(vecs), 10
    p, j = _pair(d, list(range(1, n + 1)), [i % 3 for i in range(n)], vecs)
    assert p.matrix.tier_name == "int2+int8fine" and p._first_fetch(k) == j._first_fetch(k) == RERANK_FACTOR * k
    assert p.coarse_audit["trusted"] and p.matrix.coarse_trusted == j.matrix.coarse_trusted
    assert p.matrix.coarse_fetch == j.matrix.coarse_fetch == 1024  # shallowed on an easy corpus
    assert p.coarse_audit["overlap"] == j.coarse_audit["overlap"]
    qs = _unit(rng.standard_normal((256, d)))
    int2.reset_launch_counts()
    for q in qs[:3]:
        _same_hits(p.search_vector(q, k), j.search_vector(q, k))
        _same_hits(p.search_vector(q, k, [1]), j.search_vector(q, k, [1]))
    assert set(int2.launch_counts().values()) == {0}  # CPU tensors: the plain versions ran
    for width in (8, 256):
        for g, w in zip(p.search_vectors_batch(qs[:width], k), j.search_vectors_batch(qs[:width], k)):
            _same_hits(g, w)
    for s in (p, j):
        s.upsert_embeddings([42, 9000], [0, 2], np.stack([qs[0], qs[1]]))
        s.remove_items([7, 8, 9])
    assert p.search_vector(qs[0], 1)[0][0] == j.search_vector(qs[0], 1)[0][0] == 42
    assert (p.escalations, p.scan_calls) == (j.escalations, j.scan_calls)


def test_int2_unnormalized_rows_match_jax():
    """Rows with a spread of norms (log-normal, sigma 0.3: a model without
    Normalize), queries likewise, a quarter near a stored row: the same
    audit verdict, the same top-10 (item, score) on the coarse path and in
    a batch, the same escalations."""
    rng = np.random.default_rng(18)
    n, d, k = 4096, 64, 10
    vecs = (_unit(rng.standard_normal((n, d))) * 8.0 * rng.lognormal(0.0, 0.3, (n, 1))).astype(np.float32)
    # half the rows crowd around 4 centres: close scores, which escalate
    vecs[: n // 2] = vecs[rng.integers(0, 4, n // 2)] + 0.3 * vecs[n // 2 :]
    p, j = _pair(d, list(range(1, n + 1)), [i % 3 for i in range(n)], vecs)
    assert p.matrix.coarse_trusted == j.matrix.coarse_trusted
    for key in ("overlap", "min_overlap", "fetch", "queries", "trusted"):
        assert p.coarse_audit[key] == j.coarse_audit[key], key
    qs = (_unit(rng.standard_normal((32, d))) * 8.0 * rng.lognormal(0.0, 0.3, (32, 1))).astype(np.float32)
    qs[:8] = vecs[rng.integers(0, n, 8)] + 0.4 * _unit(rng.standard_normal((8, d)))
    for q in qs[:6]:
        _same_hits(p.search_vector(q, k), j.search_vector(q, k))
    for g, w in zip(p.search_vectors_batch(qs, k), j.search_vectors_batch(qs, k)):
        _same_hits(g, w)
    assert (p.escalations, p.scan_calls) == (j.escalations, j.scan_calls)
    assert p.escalations > 0


def test_int2_coarse_path_routing(corpus, monkeypatch):
    """A single query takes the coarse pass (K5 -> K6 -> fine phase, with a
    floor); a batch of 8 sweeps the companion (K7); the depth rule leaves
    the coarse pass once a fetch reaches half its depth."""
    monkeypatch.setenv("PERCEIVE_TPU_COARSE_AUDIT", "0")  # trust the coarse pass unaudited
    _, d, vecs = corpus
    p = Searcher(0, 0, d, device="cpu", dtype=INT2)
    p.upsert_embeddings(list(range(1, 2049)), [0] * 2048, vecs[:2048])
    p.matrix.coarse_fetch = 512  # a coarse depth below the corpus: a finite floor
    calls = []
    for mod, name, tag in ((int2, "scan_int2_coarse_fine", "coarse"), (topk, "scan_topk_int8t_flat", "K7")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _tag=tag, **kw: calls.append(_tag) or _fn(*a, **kw))
    allowed = p._allowed_arrays(None)[0]
    _, _, floor = p._device_scan(p._pad_queries(vecs[:1]), 64, allowed)
    assert calls == ["coarse"] and floor.shape == (1,) and np.isfinite(floor).all()
    _, _, floor = p._device_scan(p._pad_queries(vecs[:8]), 64, allowed)
    assert calls[-1] == "K7" and floor is None
    assert p._coarse_pays(256) and not p._coarse_pays(512)


def _clustered(rng, n_cluster, n_bg, d, spread):
    """As tests/test_coarse_audit.py: one near-duplicate cluster wider than
    the coarse depth, plus isotropic background rows."""
    center = _unit(rng.standard_normal((1, d)))[0]
    cluster = center[None, :] + spread * _unit(rng.standard_normal((n_cluster, d)))
    return np.concatenate([_unit(cluster), _unit(rng.standard_normal((n_bg, d)))])


def test_int2_audit_demotes_dense_ties_like_jax():
    rng = np.random.default_rng(1)
    d = 64
    rows = _clustered(rng, 6_000, 2_192, d, 0.2)
    p, j = _pair(d, list(range(1, len(rows) + 1)), [0] * len(rows), rows)
    assert not p.matrix.coarse_trusted and not j.matrix.coarse_trusted
    for key in ("overlap", "min_overlap", "fetch", "queries", "trusted"):
        assert p.coarse_audit[key] == j.coarse_audit[key], key
    q = _unit(rows[37:38] + 0.01 * rng.standard_normal((1, d)))[0]
    _same_hits(p.search_vector(q, 10), j.search_vector(q, 10))


def test_storage_tier_picks_int2():
    for n in (4_000_001, 24_000_000):
        assert storage_tier("auto", n, 384) == INT2
    assert storage_tier("auto", 2_000_001, 768) == INT2
    assert storage_tier("auto", 24_000_001, 384) == INT4  # past the int2 tier: packed int4


def test_retier_into_int2_matches_jax(corpus, monkeypatch):
    """The auto rule moves a growing corpus from int8 to int2
    (thresholds lowered for the test) and audits the new tier."""
    from perceive_tpu.index import matrix as jax_matrix
    from perceive_tpu_torch.index import matrix as port_matrix

    monkeypatch.setattr(port_matrix, "auto_matrix_dtype", lambda n, padded_dim=384: INT2 if n > 4000 else torch.int8)
    monkeypatch.setattr(jax_matrix, "auto_matrix_dtype", lambda n, padded_dim=384: JAX_INT2 if n > 4000 else jnp.int8)
    rng, d, vecs = corpus
    p = Searcher(0, 0, d, device="cpu", dtype=torch.int8)
    j = JaxSearcher(0, 0, d, dtype=jnp.int8, engine="xla")
    for s in (p, j):
        s.auto_retier = True
        s.upsert_embeddings(list(range(1, 3001)), [0] * 3000, vecs[:3000])
        assert s.coarse_audit is None
        s.upsert_embeddings(list(range(3001, 6001)), [1] * 3000, vecs[3000:6000])
    assert p.matrix.packed2 and j.matrix.packed2 and p.coarse_audit["rows"] == 6000
    assert (p.matrix.scale_hw, p.matrix.norm_hw) == (j.matrix.scale_hw, j.matrix.norm_hw)
    for key in ("overlap", "fetch", "trusted"):
        assert p.coarse_audit[key] == j.coarse_audit[key], key
    q = _unit(rng.standard_normal((1, d)))[0]
    _same_hits(p.search_vector(q, 10), j.search_vector(q, 10))


def test_int2_executor_serves_batches(corpus):
    """The executor needs no int2 code of its own: its drains take the
    companion route and answer as search_vector does."""
    rng, d, vecs = corpus
    p = Searcher(0, 0, d, device="cpu", dtype=INT2)
    p.upsert_embeddings(list(range(1, 2049)), [0] * 2048, vecs[:2048])
    qs = _unit(rng.standard_normal((6, d)))
    ex = BatchingSearchExecutor(p)
    try:
        futs = [ex.submit(q, 5) for q in qs]
        got = [f.result(timeout=60) for f in futs]
    finally:
        ex.close()
    for g, q in zip(got, qs):
        _same_hits(g, p.search_vector(q, 5))


@pytest.fixture(scope="module")
def models():
    import jax

    from perceive_tpu.models import EncoderArch as JaxArch
    from perceive_tpu.models import HeadConfig as JaxHead
    from perceive_tpu.models import Model as JaxModel
    from perceive_tpu.models import TextTokenizer as JaxTokenizer
    from perceive_tpu.models.tokenize import tiny_test_vocab
    from perceive_tpu_torch.models import EncoderArch, HeadConfig, Model, TextTokenizer
    from perceive_tpu_torch.models.convert import params_from_jax

    words = "the a and search semantic music pizza river mountain notes kernel".split()
    vocab = tiny_test_vocab(words)
    arch_kw = dict(vocab_size=len(vocab), hidden_size=64, num_layers=2, num_heads=4,
                   intermediate_size=128, max_position_embeddings=64)
    jm = JaxModel.random(JaxArch(**arch_kw), JaxHead(pooling="mean", normalize=True),
                         JaxTokenizer.from_vocab(vocab, max_seq_length=64), seed=5)
    pm = Model(
        params_from_jax(jax.tree.map(np.asarray, jm.params)), EncoderArch(**arch_kw),
        HeadConfig(pooling="mean", normalize=True), TextTokenizer.from_vocab(vocab, max_seq_length=64),
        device="cpu", compute_dtype=torch.float32,
    )
    return pm, jm, words


def test_int2_search_fused_matches_jax(models):
    """The fused text path at int2: the first sweep is the coarse pass, and
    its floor comes back in the same copy."""
    pm, jm, words = models
    rng = np.random.default_rng(12)
    texts = [" ".join(rng.choice(words, size=int(rng.integers(3, 12)))) for _ in range(400)]
    vecs = np.asarray(jm.encode(texts), np.float32)
    p, j = _pair(pm.dim, list(range(1, 401)), [i % 2 for i in range(400)], vecs)
    for qtext in ("music river", "pizza kernel notes"):
        got, want = p.search_fused(pm, qtext, 8), j.search_fused(jm, qtext, 8)
        assert [i for i, _ in got] == [i for i, _ in want]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want], atol=1e-4, rtol=0)
        hits, aq = p.search_fused(pm, qtext, 8, [1], aux_model=pm)
        assert [i for i, _ in hits] == [i for i, _ in j.search_fused(jm, qtext, 8, [1])]
        assert aq.shape == (pm.dim,)
