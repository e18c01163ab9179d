"""The port's coalescing executor against the JAX package's, on the CPU.

Both executors serve searchers built from the same seeded vectors; every
answer is held against the JAX executor's answer to the same request and
against the port's own per-query ``search_vector``.  Tolerances: the same
ids in the same order; scores within 1e-5 relative (f32 tier: f32 sums in
another order; int8 tier: both rerank in f32 on the host).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceive_tpu.index import BatchingSearchExecutor as JaxExecutor
from perceive_tpu.index import Searcher as JaxSearcher
from perceive_tpu_torch.index import BatchingSearchExecutor, Searcher
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)

N, D = 800, 32


def _same(got, want):
    assert [g[0] for g in got] == [w[0] for w in want]
    np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want], rtol=1e-5, atol=1e-7)


class _Counting:
    """Counts the sweeps a searcher's batch entry runs."""

    def __init__(self, searcher):
        self.sweeps = 0
        orig = searcher.search_vectors_batch

        def counted(vecs, k, source_ids=None):
            self.sweeps += 1
            return orig(vecs, k, source_ids)

        searcher.search_vectors_batch = counted


@pytest.fixture(params=["float32", "int8"])
def pair(request):
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((N, D)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    p = Searcher(0, 0, D, device="cpu", dtype=getattr(torch, request.param))
    j = JaxSearcher(0, 0, D, dtype=getattr(jnp, request.param), engine="xla")
    for s in (p, j):
        s.upsert_embeddings(list(range(1, N + 1)), [i % 3 for i in range(N)], vecs)
    return p, j, vecs


def _concurrent(ex, vecs, n_clients, k=5):
    results = [None] * n_clients
    barrier = threading.Barrier(n_clients)

    def client(i):
        barrier.wait()
        results[i] = ex.search(vecs[i], k, timeout=30)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results


def test_coalesces_concurrent_queries_like_jax(pair):
    p, j, vecs = pair
    count = _Counting(p)
    ex, jex = BatchingSearchExecutor(p, window_ms=25, max_batch=64), JaxExecutor(j, window_ms=25, max_batch=64)
    try:
        got, want = _concurrent(ex, vecs, 24), _concurrent(jex, vecs, 24)
        for i in range(24):
            assert got[i][0][0] == i + 1  # self-match first
            _same(got[i], want[i])
            _same(got[i], p.search_vector(vecs[i], 5))
        assert count.sweeps <= 4, count.sweeps  # 24 queries, far fewer sweeps
        assert ex.queries_total == jex.queries_total == 24
        assert ex.sweeps_total == count.sweeps and ex.query_errors_total == 0
    finally:
        ex.close()
        jex.close()


def test_slab_wide_drain_matches_per_query(pair):
    """One drain of 300 queries: a sweep at the slab width (K2 or K4 on the
    card; the plain version here)."""
    p, j, vecs = pair
    ex = BatchingSearchExecutor(p, window_ms=200, max_batch=512)
    try:
        ex.search(vecs[0], 5)  # the next burst coalesces (no idle short-circuit)
        futs = [ex.submit(vecs[i], 5) for i in range(300)]
        got = [f.result(30) for f in futs]
        for i in range(0, 300, 7):
            _same(got[i], p.search_vector(vecs[i], 5))
            _same(got[i], j.search_vector(vecs[i], 5))
        assert ex.sweeps_total <= 4
    finally:
        ex.close()


def test_mixed_signatures_grouped_like_jax(pair):
    p, j, vecs = pair
    answers = []
    for cls, s in ((BatchingSearchExecutor, p), (JaxExecutor, j)):
        ex = cls(s, window_ms=20)
        try:
            fs = [ex.submit(vecs[0], 5), ex.submit(vecs[1], 3, source_ids=[1]), ex.submit(vecs[2], 5)]
            answers.append([f.result(10) for f in fs])
        finally:
            ex.close()
    for g, w in zip(*answers):
        _same(g, w)
    _same(answers[0][1], p.search_vector(vecs[1], 3, source_ids=[1]))
    assert len(answers[0][1]) == 3


def test_error_propagates_to_futures(pair):
    p, _, vecs = pair

    class Boom(Exception):
        pass

    def explode(*a, **k):
        raise Boom("device on fire")

    p.search_vectors_batch = explode
    ex = BatchingSearchExecutor(p, window_ms=5)
    try:
        f = ex.submit(vecs[0], 5)
        with pytest.raises(Boom):
            f.result(10)
        assert ex.query_errors_total == 1
        ex.close()
        with pytest.raises(RuntimeError):
            ex.submit(vecs[0], 5)
    finally:
        ex.close()


@pytest.fixture(scope="module")
def models():
    from perceive_tpu.models import EncoderArch as JaxArch
    from perceive_tpu.models import HeadConfig as JaxHead
    from perceive_tpu.models import Model as JaxModel
    from perceive_tpu.models import TextTokenizer as JaxTokenizer
    from perceive_tpu.models.tokenize import tiny_test_vocab
    from perceive_tpu_torch.models import EncoderArch, HeadConfig, Model, TextTokenizer
    from perceive_tpu_torch.models.convert import params_from_jax

    words = "the a and search semantic music pizza river mountain notes kernel".split()
    vocab = tiny_test_vocab(words)
    arch_kw = dict(vocab_size=len(vocab), hidden_size=D, num_layers=2, num_heads=4,
                   intermediate_size=64, max_position_embeddings=64)
    jm = JaxModel.random(JaxArch(**arch_kw), JaxHead(pooling="mean", normalize=True),
                         JaxTokenizer.from_vocab(vocab, max_seq_length=64), seed=5)
    pm = Model(
        params_from_jax(jax.tree.map(np.asarray, jm.params)), EncoderArch(**arch_kw),
        HeadConfig(pooling="mean", normalize=True), TextTokenizer.from_vocab(vocab, max_seq_length=64),
        device="cpu", compute_dtype=torch.float32,
    )
    return pm, jm, words


def test_text_queries_and_cache_invalidation_like_jax(pair, models):
    """submit_text: a lone query rides search_fused, a burst batch-encodes
    once; a repeat is served from the result cache until the matrix's
    mutation_gen moves.  Hits and cache counters follow the JAX executor's."""
    p, j, _ = pair
    pm, jm, words = models
    rng = np.random.default_rng(1)
    texts = [" ".join(rng.choice(words, size=int(rng.integers(3, 9)))) for _ in range(6)]

    def run(cls, s, m):
        ex = cls(s, model=m, aux_model=m, window_ms=30)
        try:
            lone = ex.search_text(texts[0], 5)
            burst = [f.result(30) for f in [ex.submit_text(t, 5) for t in texts]]
            again = ex.search_text(texts[0], 5)  # cached
            hits_aux, aux = ex.search_text(texts[1], 4, want_aux=True)
            before = s.matrix.mutation_gen
            s.upsert_embeddings([N + 1], [0], np.ones((1, D), np.float32) / np.sqrt(D))
            assert s.matrix.mutation_gen == before + 1
            fresh = ex.search_text(texts[0], 5)  # the upsert invalidated the entry
            assert again == lone and aux.shape == (D,)
            counts = (ex.result_cache_hits, ex.result_cache_misses, ex.queries_total)
            return [lone, *burst, hits_aux, fresh], counts
        finally:
            ex.close()

    got, got_counts = run(BatchingSearchExecutor, p, pm)
    want, want_counts = run(JaxExecutor, j, jm)
    assert got_counts == want_counts
    for g, w in zip(got, want):
        assert [i for i, _ in g] == [i for i, _ in w]
        np.testing.assert_allclose([v for _, v in g], [v for _, v in w], atol=1e-4, rtol=0)
