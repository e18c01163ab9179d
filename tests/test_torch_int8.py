"""The port's int8 tier against the JAX package's, on the CPU.

Same seeded numpy inputs to both.  The JAX scans run as the JAX package's
own tests run them here: the Pallas kernels in interpret mode
(``scan_topk_pallas_int8``, ``scan_topk_pallas``, and the searcher with
``engine="pallas"``).  Tolerances:
  * quantization (``quantize_queries``, the matrix's ``_quantize``) and int8
    scores: none, bit for bit; rows equal outside exact score ties (the
    TPU kernel's tie order is no contract; the port's is the lower row
    first);
  * bf16 slab scan (K2's plain version): scores within 1e-3 (bf16 matrix,
    f32 sums in another order), rows equal outside near ties;
  * searcher hits at the int8 tier: the same ids in the same order, scores
    within 1e-6 relative (both rerank in f32 on the host); the fused text
    path within 1e-4 (the two encoders round differently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceive_tpu.index.matrix import EmbeddingMatrix as JaxMatrix
from perceive_tpu.index.searcher import Searcher as JaxSearcher
from perceive_tpu.ops import topk as jax_topk
from perceive_tpu_torch.index.matrix import EmbeddingMatrix, _quantize
from perceive_tpu_torch.index.searcher import RERANK_FACTOR, Searcher
from perceive_tpu_torch.ops import topk
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)

N = 2048


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _allowed(ids=None):
    a = np.full(16, -9, dtype=np.int32)
    if ids is None:
        a[0] = topk.ALLOW_ALL
    else:
        a[: len(ids)] = ids
    return a


# -- reference math -----------------------------------------------------------


def _edge_queries():
    q = _unit(np.random.default_rng(0).standard_normal((6, 96)))
    q[0] = 0.0  # all zero: the scale floors at 1e-12 / 127
    q[1, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]  # scale 1: halves round to even
    q[1, 8:] = 0.0
    q[2] *= 1e-30  # subnormal range
    q[3] *= 3e4
    return q


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_queries_bit_exact(seed):
    q = _edge_queries() if seed == 0 else np.random.default_rng(seed).standard_normal((9, 384)).astype(np.float32)
    qi8, scale = topk.quantize_queries(torch.from_numpy(q))
    # compiled, as every JAX path runs it (XLA turns the division by 127
    # into a multiplication by its f32 reciprocal)
    want_q, want_s = jax.jit(jax_topk.quantize_queries)(jnp.asarray(q))
    assert qi8.dtype == torch.int8 and scale.dtype == torch.float32 and scale.shape == (q.shape[0], 1)
    np.testing.assert_array_equal(qi8.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(want_s))


@pytest.mark.parametrize("seed", [0, 1])
def test_matrix_quantize_bit_exact(seed):
    rows = _edge_queries() if seed == 0 else np.random.default_rng(seed).standard_normal((64, 384)).astype(np.float32) * 5
    got_q, got_s = _quantize(rows)
    want_q, want_s = JaxMatrix(rows.shape[1], dtype=jnp.int8)._quantize(rows)
    np.testing.assert_array_equal(got_q, want_q)
    np.testing.assert_array_equal(got_s, want_s)
    assert got_q.dtype == np.int8 and got_s.dtype == np.float32


def test_scores_int8_bit_exact():
    rng = np.random.default_rng(4)
    m, s = _quantize(_unit(rng.standard_normal((300, 384))))
    qi8, qs = jax.jit(jax_topk.quantize_queries)(jnp.asarray(_unit(rng.standard_normal((5, 384)))))
    got = topk.scores_int8(torch.from_numpy(m), torch.from_numpy(s), torch.from_numpy(np.array(qi8)),
                           torch.from_numpy(np.array(qs)))
    want = jax_topk.xla_scores_int8(jnp.asarray(m), jnp.asarray(s), qi8, qs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("nq", [1, 100, 255, 256, 300, 384, 2047, 2048, 4000])
def test_slab_routing_matches_jax(nq):
    assert topk._slab_pad(nq) == jax_topk._slab_pad(nq)
    assert (topk.QUERY_SLAB, topk.MAX_QUERY_SLAB) == (jax_topk.QUERY_SLAB, jax_topk.MAX_QUERY_SLAB)
    padded = nq + topk._slab_pad(nq)
    assert topk._is_slab(padded) == (padded >= 2 * jax_topk.QUERY_SLAB and padded % jax_topk.QUERY_SLAB == 0)


# -- the scans ------------------------------------------------------------------


def _int8_inputs(d, nq, seed, invalid=0.1, ties=False, n=N):
    rng = np.random.default_rng(seed)
    v = _unit(rng.standard_normal((n, d)))
    if ties:  # each row 8 times over: exact score ties
        v = np.tile(v[: n // 8], (8, 1))
    m, scales = _quantize(v)
    src = rng.integers(0, 4, n).astype(np.int32)
    src[rng.random(n) < invalid] = -1
    q = _unit(rng.standard_normal((nq, d)))
    return m, scales, src, q


def _assert_same(got, want, tol):
    """Scores within ``tol`` (0: equal bits); rows equal except where the
    score lies within ``tol`` of a neighbour's (ties may order either
    way)."""
    gv, gr = (np.asarray(x) for x in got)
    wv, wr = (np.asarray(x) for x in want)
    assert gv.shape == wv.shape
    np.testing.assert_array_equal(np.isfinite(gv), np.isfinite(wv))
    fin = np.isfinite(wv)
    if tol == 0:
        np.testing.assert_array_equal(gv[fin], wv[fin])
    else:
        np.testing.assert_allclose(gv[fin], wv[fin], atol=tol, rtol=0)
    np.testing.assert_array_equal(gr[~fin], -1)
    for qi in range(gv.shape[0]):
        for j in np.nonzero(gr[qi] != wr[qi])[0]:
            if not fin[qi, j]:
                continue
            lo, hi = max(j - 1, 0), min(j + 1, wv.shape[1] - 1)
            assert min(abs(wv[qi, j] - wv[qi, lo]) if lo != j else np.inf,
                       abs(wv[qi, j] - wv[qi, hi]) if hi != j else np.inf) <= 2 * tol, (qi, j)


INT8_CASES = [
    # (d, nq, k, filter, n_sweep, invalid, ties)
    (128, 1, 16, None, 0, 0.1, False),
    (384, 8, 64, [1, 3], 1536, 0.1, False),
    (128, 8, 64, None, 0, 0.1, True),
    (384, 1, 256, [0], 0, 0.9, False),  # fewer matches than k
    (128, 256, 16, None, 0, 0.1, False),  # K4's route
    (128, 300, 32, [0, 2], 1024, 0.5, False),  # padded to 384: K4's route
    (128, 256, 64, None, 0, 0.1, True),
    # deep k over a sweep of more than 4k rows (the escalation ladder's
    # rungs at one query and at an executor drain's width), both filters,
    # dense ties; K3's plan takes the multi-block pass 2 at these depths
    (128, 1, 512, None, 2560, 0.1, False),
    (128, 16, 512, [0, 2], 0, 0.1, True),
    (128, 1, 2048, [1, 3], 0, 0.1, True),
    (128, 16, 2048, None, 9216, 0.1, False),
]
DEEP_ROWS = 10240  # the matrix of the deep cases: a sweep past 4k rows at k = 2,048


@pytest.mark.parametrize("d,nq,k,filt,n_sweep,invalid,ties", INT8_CASES)
def test_int8_scan_matches_pallas_kernel(d, nq, k, filt, n_sweep, invalid, ties):
    n = DEEP_ROWS if k >= 512 else N
    m, scales, src, q = _int8_inputs(d, nq, seed=d + nq + k, invalid=invalid, ties=ties, n=n)
    assert k < 512 or (n_sweep or n) > 4 * k
    allowed = _allowed(filt)
    got = topk.scan_topk_int8(torch.from_numpy(m), torch.from_numpy(scales), torch.from_numpy(src),
                              torch.from_numpy(q), torch.from_numpy(allowed), k, n_sweep)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    want = jax_topk.scan_topk_pallas_int8(jnp.asarray(m), jnp.asarray(scales), jnp.asarray(src),
                                          jnp.asarray(q), jnp.asarray(allowed), k, n_sweep)
    _assert_same((got[0].numpy(), got[1].numpy()), want, 0)
    if ties:  # the port's tie rule: lower row first
        v, r = got[0].numpy(), got[1].numpy()
        same = (v[:, 1:] == v[:, :-1]) & np.isfinite(v[:, 1:])
        assert same.any() and (r[:, 1:][same] > r[:, :-1][same]).all()
    if invalid == 0.9:
        assert np.isinf(got[0].numpy()).any(), "case meant to run short of matches"


@pytest.mark.parametrize("kernel", ["flat", "slab"])
def test_int8_kernel_entries_agree(kernel):
    """K3's and K4's entries take the same pre-quantized inputs as the
    plain version and give its answer (on the CPU they are the plain
    version; the card's check is tests/test_torch_cuda.py)."""
    m, scales, src, q = _int8_inputs(128, 256, seed=3)
    qi8, qs = topk.quantize_queries(torch.from_numpy(q))
    args = (torch.from_numpy(m), torch.from_numpy(scales), torch.from_numpy(src), qi8, qs,
            torch.from_numpy(_allowed()), 32, 0)
    fn = topk.scan_topk_int8_flat if kernel == "flat" else topk.scan_topk_int8_slab
    got, want = fn(*args), topk.scan_topk_int8_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("nq,k,filt", [(256, 16, None), (384, 64, [1, 2])])
def test_bf16_slab_matches_pallas_kernel(nq, k, filt):
    rng = np.random.default_rng(nq + k)
    v = _unit(rng.standard_normal((N, 128)))
    src = rng.integers(0, 4, N).astype(np.int32)
    src[rng.random(N) < 0.1] = -1
    q = _unit(rng.standard_normal((nq, 128)))
    allowed = _allowed(filt)
    got = topk.scan_topk(torch.from_numpy(v).bfloat16(), torch.from_numpy(src), torch.from_numpy(q),
                         torch.from_numpy(allowed), k, 1536)
    want = jax_topk.scan_topk_pallas(jnp.asarray(v, jnp.bfloat16), jnp.asarray(src), jnp.asarray(q),
                                     jnp.asarray(allowed), k, 1536)
    _assert_same((got[0].numpy(), got[1].numpy()), want, 1e-3)


# -- the searcher -----------------------------------------------------------------


def _same_hits(got, want, rtol=1e-6):
    assert [i for i, _ in got] == [i for i, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=rtol, atol=1e-7)


def _pair(d, pairs, srcs, vecs, dtype="int8"):
    p = Searcher(0, 0, d, device="cpu", dtype=getattr(torch, dtype))
    j = JaxSearcher(0, 0, d, dtype=getattr(jnp, dtype), engine="pallas")
    for s in (p, j):
        s.upsert_embeddings(pairs, srcs, vecs)
    return p, j


def test_int8_searcher_matches_jax():
    """search_vector (filtered too), search_vectors_batch at a slab width,
    then upserts and removals."""
    rng = np.random.default_rng(3)
    n, d, k = 1500, 64, 10
    vecs = _unit(rng.standard_normal((n, d)))
    p, j = _pair(d, list(range(1, n + 1)), [i % 3 for i in range(n)], vecs)
    assert p.matrix.quantized and p._first_fetch(k) == j._first_fetch(k) == RERANK_FACTOR * k
    qs = _unit(rng.standard_normal((300, d)))
    for q in qs[:4]:
        _same_hits(p.search_vector(q, k), j.search_vector(q, k))
        _same_hits(p.search_vector(q, k, [1]), j.search_vector(q, k, [1]))
    for g, w in zip(p.search_vectors_batch(qs, k), j.search_vectors_batch(qs, k)):
        _same_hits(g, w)
    for s in (p, j):
        s.upsert_embeddings([42, 5000], [0, 2], np.stack([qs[0], qs[1]]))
        s.remove_items([7, 8, 9])
    assert p.search_vector(qs[0], 1)[0][0] == j.search_vector(qs[0], 1)[0][0] == 42
    for q in qs[:3]:
        _same_hits(p.search_vector(q, k), j.search_vector(q, k))
    assert (p.escalations, p.scan_calls) == (j.escalations, j.scan_calls)
    assert p.matrix.mutation_gen == j.matrix.mutation_gen


def _spread(rng, n, d, scale=8.0):
    """Rows of a model without Normalize (msmarco-bert-base-dot-v5 writes
    mean-pooled, unnormalized rows): random directions, log-normal norms
    (sigma 0.3) around ``scale``."""
    return (_unit(rng.standard_normal((n, d))) * scale * rng.lognormal(0.0, 0.3, (n, 1))).astype(np.float32)


def test_int8_unnormalized_rows_match_jax():
    """Rows and queries with a spread of norms, a quarter of the queries
    near a stored row: the same top-10 (item, score) at Q = 1 and in a
    batch, and the same escalations (the 3-sigma margin scales with the
    query's norm and the rows' largest one)."""
    rng = np.random.default_rng(17)
    n, d, k = 1500, 64, 10
    vecs = _spread(rng, n, d)
    # half the rows crowd around 4 centres: close scores, which escalate
    vecs[: n // 2] = (vecs[rng.integers(0, 4, n // 2)] + 0.02 * _spread(rng, n // 2, d)).astype(np.float32)
    p, j = _pair(d, list(range(1, n + 1)), [i % 3 for i in range(n)], vecs)
    assert p.matrix.norm_hw == j.matrix.norm_hw and p.matrix.scale_hw == j.matrix.scale_hw
    qs = _spread(rng, 64, d)
    qs[:16] = vecs[rng.integers(0, n, 16)] + 0.05 * _spread(rng, 16, d)
    for q in qs[:12]:
        _same_hits(p.search_vector(q, k), j.search_vector(q, k))
    for g, w in zip(p.search_vectors_batch(qs, k), j.search_vectors_batch(qs, k)):
        _same_hits(g, w)
    assert (p.escalations, p.scan_calls) == (j.escalations, j.scan_calls)
    assert p.escalations > 0


def test_int8_with_chunked_documents_matches_jax():
    d, k = 48, 6
    rng = np.random.default_rng(7)
    pairs, vecs, srcs = [], [], []
    for i in range(1, 201):
        for c in range(3 if i % 5 == 0 else 1):
            pairs.append((i, c))
            vecs.append(rng.standard_normal(d).astype(np.float32))
            srcs.append(i % 2)
    vecs = _unit(np.stack(vecs))
    p, j = _pair(d, pairs, srcs, vecs)
    assert p.matrix.multi_chunk_groups == j.matrix.multi_chunk_groups == 40
    assert p._first_fetch(k) == j._first_fetch(k) == 2 * RERANK_FACTOR * k
    for _ in range(4):
        q = _unit(rng.standard_normal((1, d)))[0]
        got, want = p.search_vector(q, k), j.search_vector(q, k)
        _same_hits(got, want)
        assert len({i for i, _ in got}) == k


def test_bf16_to_int8_retier_matches_jax():
    rng = np.random.default_rng(11)
    n, d = 900, 64
    vecs = _unit(rng.standard_normal((n, d)))
    p, j = _pair(d, list(range(n)), [0] * n, vecs, dtype="bfloat16")
    p.matrix.retier(torch.int8)
    j.matrix.retier(jnp.int8)
    assert (p.matrix.scale_hw, p.matrix.norm_hw) == (j.matrix.scale_hw, j.matrix.norm_hw)
    for q in _unit(rng.standard_normal((4, d))):
        _same_hits(p.search_vector(q, 8), j.search_vector(q, 8))


def test_margin_sigma_escalates_like_jax(monkeypatch):
    """Built like tests/test_int8.py's test_rerank_margin_sigma_escalates: a
    huge noise margin forces both packages up the same ladder of sweep
    depths to the cap, with hits equal to the f32 oracle's; sigma 0 sweeps
    once."""
    rng = np.random.default_rng(3)
    n, d, k = 512, 64, 5
    vecs = _unit(rng.standard_normal((n, d)))
    p, j = _pair(d, list(range(1, n + 1)), [0] * n, vecs)
    oracle = Searcher(0, 0, d, device="cpu", dtype=torch.float32)
    oracle.upsert_embeddings(list(range(1, n + 1)), [0] * n, vecs)
    q = vecs[7] + 0.01 * rng.standard_normal(d).astype(np.float32)

    sweeps = {"port": [], "jax": []}
    p_orig, j_orig = p._device_scan, j._device_scan
    p._device_scan = lambda qp, kb, allowed, *a: sweeps["port"].append(kb) or p_orig(qp, kb, allowed, *a)
    j._device_scan = lambda qp, kb, allowed, engine, **kw: sweeps["jax"].append(kb) or j_orig(qp, kb, allowed, engine, **kw)

    monkeypatch.setenv("PERCEIVE_TPU_RERANK_MARGIN_SIGMA", "1000")
    got, want = p.search_vector(q, k), j.search_vector(q, k)
    _same_hits(got, want)
    assert [i for i, _ in got] == [i for i, _ in oracle.search_vector(q, k)]
    assert sweeps["port"] == sweeps["jax"] and len(sweeps["port"]) >= 2 and max(sweeps["port"]) >= n
    assert p.escalations == j.escalations == len(sweeps["port"]) - 1

    for v in sweeps.values():
        v.clear()
    monkeypatch.setenv("PERCEIVE_TPU_RERANK_MARGIN_SIGMA", "0")
    _same_hits(p.search_vector(q, k), j.search_vector(q, k))
    assert sweeps["port"] == sweeps["jax"] and len(sweeps["port"]) == 1


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


def test_int8_search_fused_matches_jax(models):
    """The fused text path at the int8 tier: the first sweep (the query
    quantized on the device) is reranked like any other."""
    pm, jm, words = models
    rng = np.random.default_rng(12)
    texts = [" ".join(rng.choice(words, size=int(rng.integers(3, 12)))) for _ in range(400)]
    vecs = jm.encode(texts)
    p, j = _pair(pm.dim, list(range(1, 401)), [i % 2 for i in range(400)], np.asarray(vecs, np.float32))
    for qtext in ("music river", "pizza kernel notes", "semantic search"):
        got, want = p.search_fused(pm, qtext, 8), j.search_fused(jm, qtext, 8)
        assert [i for i, _ in got] == [i for i, _ in want]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want], atol=1e-4, rtol=0)
        hits, aq = p.search_fused(pm, qtext, 8, [1], aux_model=pm)
        assert [i for i, _ in hits] == [i for i, _ in j.search_fused(jm, qtext, 8, [1])]
        assert aq.shape == (pm.dim,)
