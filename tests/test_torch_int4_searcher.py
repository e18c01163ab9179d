"""The port's searcher at the int4 tier, and at the int2 tier with the int4
companion, against the JAX package's (``engine="xla"``), on the CPU.

Same seeded numpy inputs to both.  Tolerances: the same ids in the same
order, scores within 1e-6 relative (both rerank in f32 on the host), the
same first fetch depth (8x the request: RERANK_FACTOR_INT4), the same
escalation and scan counts; the fused text path within 1e-4 (the two
encoders round differently).  The int2 self-audit: the same verdict,
depth and overlap.
"""

import numpy as np
import pytest
import torch

from perceive_tpu.index.matrix import INT2 as JAX_INT2
from perceive_tpu.index.matrix import INT4 as JAX_INT4
from perceive_tpu.index.searcher import Searcher as JaxSearcher
from perceive_tpu_torch.index import BatchingSearchExecutor
from perceive_tpu_torch.index.matrix import INT2, INT4
from perceive_tpu_torch.index.searcher import RERANK_FACTOR_INT4, Searcher
from perceive_tpu_torch.ops import topk
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)

TIERS = {"int4": (INT4, JAX_INT4), "int2+int4fine": (INT2, JAX_INT2)}


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _same_hits(got, want, rtol=1e-6):
    assert [i for i, _ in got] == [i for i, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=rtol, atol=1e-7)


@pytest.fixture(autouse=True)
def _int4_companion(monkeypatch):
    monkeypatch.setenv("PERCEIVE_TPU_INT2_FINE", "int4")


def _pair(tier, d, keys, srcs, vecs):
    tp, tj = TIERS[tier]
    p = Searcher(0, 0, d, device="cpu", dtype=tp)
    j = JaxSearcher(0, 0, d, dtype=tj, engine="xla")
    for s in (p, j):
        s.upsert_embeddings(keys, srcs, vecs)
    assert p.matrix.tier_name == j.matrix.tier_name == tier
    return p, j


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(6)
    n, d = 8192, 64
    return rng, d, _unit(rng.standard_normal((n, d)))


def _spy(monkeypatch, names):
    """Record which of topk's K9 wrappers (and the int2 pipeline) a search
    reaches."""
    from perceive_tpu_torch.ops import int2

    calls = []
    for mod, name in [(topk, n) for n in names if hasattr(topk, n)] + [(int2, n) for n in names if hasattr(int2, n)]:
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _name=name, **kw: calls.append(_name) or _fn(*a, **kw))
    return calls


@pytest.mark.parametrize("tier", list(TIERS))
def test_int4_searcher_matches_jax(corpus, monkeypatch, tier):
    """Q = 1 (flat K9; at int2 the coarse pass over the int4 companion,
    filtered too), Q = 8 (flat K9) and Q = 300 (padded to 384: slab K9),
    then upserts, a reused row and removals: hits, the first fetch depth,
    escalations and scan counts equal JAX's."""
    rng, d, vecs = corpus
    n, k = len(vecs), 10
    p, j = _pair(tier, d, list(range(1, n + 1)), [i % 3 for i in range(n)], vecs)
    assert p._first_fetch(k) == j._first_fetch(k) == RERANK_FACTOR_INT4 * k
    if tier != "int4":
        assert p.matrix.coarse_trusted == j.matrix.coarse_trusted
        for key in ("overlap", "min_overlap", "fetch", "queries", "trusted"):
            assert p.coarse_audit[key] == j.coarse_audit[key], key
    calls = _spy(monkeypatch, ["scan_topk_int4_flat", "scan_topk_int4_slab", "scan_int2_coarse_fine"])
    qs = _unit(rng.standard_normal((300, d)))
    for q in qs[:3]:
        _same_hits(p.search_vector(q, k), j.search_vector(q, k))
        _same_hits(p.search_vector(q, k, [1]), j.search_vector(q, k, [1]))
    assert ("scan_int2_coarse_fine" if tier != "int4" else "scan_topk_int4_flat") in calls
    for width in (8, 300):
        for g, w in zip(p.search_vectors_batch(qs[:width], k), j.search_vectors_batch(qs[:width], k)):
            _same_hits(g, w)
    assert "scan_topk_int4_slab" in calls and "scan_topk_int4_flat" in calls
    for s in (p, j):
        s.remove_items([7, 8, 9])
        s.upsert_embeddings([42, 9000], [0, 2], np.stack([qs[0], qs[1]]))
    assert p.search_vector(qs[0], 1)[0][0] == j.search_vector(qs[0], 1)[0][0] == 42
    _same_hits(p.search_vector(qs[1], k, [2]), j.search_vector(qs[1], k, [2]))
    assert (p.escalations, p.scan_calls) == (j.escalations, j.scan_calls)
    assert p.escalations > 0  # the 3-sigma margin re-fetches on 4-bit scores


@pytest.mark.parametrize("tier", list(TIERS))
def test_int4_unnormalized_rows_match_jax(tier):
    """Rows with a spread of norms (log-normal, sigma 0.3: a model without
    Normalize), queries likewise, a quarter near a stored row: at int2 the
    same audit verdict; the same top-10 (item, score) at Q = 1 and in a
    batch, the same escalations."""
    rng = np.random.default_rng(19)
    n, d, k = 4096, 64, 10
    vecs = (_unit(rng.standard_normal((n, d))) * 8.0 * rng.lognormal(0.0, 0.3, (n, 1))).astype(np.float32)
    # half the rows crowd around 4 centres: close scores, which escalate
    vecs[: n // 2] = vecs[rng.integers(0, 4, n // 2)] + 0.3 * vecs[n // 2 :]
    p, j = _pair(tier, d, list(range(1, n + 1)), [i % 3 for i in range(n)], vecs)
    if tier != "int4":
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


def test_int4_dense_ties_escalate_like_jax():
    """A corpus of near-duplicates: the int4 floor cannot prove the top k
    at the first depth; the port escalates as often as JAX and answers
    alike."""
    rng = np.random.default_rng(2)
    d = 64
    center = _unit(rng.standard_normal((1, d)))
    rows = _unit(center + 0.05 * rng.standard_normal((4096, d)))
    p, j = _pair("int4", d, list(range(1, 4097)), [0] * 4096, rows)
    q = _unit(center + 0.01 * rng.standard_normal((1, d)))[0]
    _same_hits(p.search_vector(q, 10), j.search_vector(q, 10))
    for g, w in zip(p.search_vectors_batch(rows[:4] + 0.01, 10), j.search_vectors_batch(rows[:4] + 0.01, 10)):
        _same_hits(g, w)
    assert p.escalations == j.escalations > 0


def test_retier_into_int4_and_back_matches_jax(corpus, monkeypatch):
    """The auto rule moves a growing corpus from int2 into int4 (thresholds
    lowered for the test) and back to int2 when it has shrunk and rows are
    added again; hits and quantization stats follow JAX's."""
    from perceive_tpu.index import matrix as jax_matrix
    from perceive_tpu_torch.index import matrix as port_matrix

    monkeypatch.setattr(port_matrix, "auto_matrix_dtype", lambda n, padded_dim=384: INT4 if n > 4000 else INT2)
    monkeypatch.setattr(jax_matrix, "auto_matrix_dtype", lambda n, padded_dim=384: JAX_INT4 if n > 4000 else JAX_INT2)
    rng, d, vecs = corpus
    p = Searcher(0, 0, d, device="cpu", dtype=INT2)
    j = JaxSearcher(0, 0, d, dtype=JAX_INT2, engine="xla")
    q = _unit(rng.standard_normal((1, d)))[0]
    for s in (p, j):
        s.auto_retier = True
        s.upsert_embeddings(list(range(1, 3001)), [0] * 3000, vecs[:3000])
        s.upsert_embeddings(list(range(3001, 6001)), [1] * 3000, vecs[3000:6000])
    assert p.matrix.packed4 and j.matrix.packed4 and p.coarse_audit is None
    assert (p.matrix.scale_hw, p.matrix.norm_hw) == (j.matrix.scale_hw, j.matrix.norm_hw)
    _same_hits(p.search_vector(q, 10), j.search_vector(q, 10))
    for s in (p, j):
        s.remove_items(list(range(1, 3001)))
        s.upsert_embeddings([7000], [2], vecs[6000:6001])
    assert p.matrix.packed2 and j.matrix.packed2 and p.matrix.tier_name == "int2+int4fine"
    assert p.coarse_audit["trusted"] == j.coarse_audit["trusted"]
    assert (p.matrix.scale_hw, p.matrix.norm_hw) == (j.matrix.scale_hw, j.matrix.norm_hw)
    _same_hits(p.search_vector(q, 10), j.search_vector(q, 10))


@pytest.mark.parametrize("tier", list(TIERS))
def test_int4_executor_serves_batches(corpus, tier):
    """The executor needs no int4 code of its own: its drains take the K9
    routes and answer as search_vector does."""
    rng, d, vecs = corpus
    p = Searcher(0, 0, d, device="cpu", dtype=TIERS[tier][0])
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


def test_int4_tier_with_a_spilled_mirror(corpus, tmp_path, monkeypatch):
    """Past 24M rows the f32 host mirror is tens of GB (38.7 GB at
    25,165,824 x 384) and spills to a memory-mapped file; the int4 tier
    needs nothing of its own for that: a spilled mirror, grown in place,
    answers as one in RAM."""
    from perceive_tpu_torch.index.matrix import HostMirror

    assert HostMirror(512, 384, ram_budget=1 << 30)._nbytes(25_165_824) == 25_165_824 * 384 * 4
    rng, d, vecs = corpus
    q = _unit(rng.standard_normal((4, d)))
    ram = Searcher(0, 0, d, device="cpu", dtype=INT4)
    monkeypatch.setenv("PERCEIVE_TPU_MIRROR_RAM_GB", "0")
    monkeypatch.setenv("PERCEIVE_TPU_MIRROR_DIR", str(tmp_path))
    spilled = Searcher(0, 0, d, device="cpu", dtype=INT4)
    for s in (ram, spilled):
        s.upsert_embeddings(list(range(1, 3001)), [0] * 3000, vecs[:3000])
        s.search_vector(q[0], 10)  # staged at a capacity of 4,096 rows
        s.upsert_embeddings(list(range(3001, 5001)), [1] * 2000, vecs[3000:5000])  # grows to 8,192
    assert spilled.matrix._mirror.path is not None and ram.matrix._mirror.path is None
    assert spilled.matrix.capacity == ram.matrix.capacity == 8192
    for g, w in zip(spilled.search_vectors_batch(q, 10), ram.search_vectors_batch(q, 10)):
        _same_hits(g, w, rtol=0)


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


@pytest.mark.parametrize("tier", list(TIERS))
def test_int4_search_fused_matches_jax(models, tier):
    """The fused text path: the first sweep is flat K9 (at int2 the coarse
    pass over the int4 companion), reranked and escalated like any other."""
    pm, jm, words = models
    rng = np.random.default_rng(13)
    texts = [" ".join(rng.choice(words, size=int(rng.integers(3, 12)))) for _ in range(400)]
    vecs = np.asarray(jm.encode(texts), np.float32)
    p, j = _pair(tier, pm.dim, list(range(1, 401)), [i % 2 for i in range(400)], vecs)
    for qtext in ("music river", "pizza kernel notes"):
        got, want = p.search_fused(pm, qtext, 8), j.search_fused(jm, qtext, 8)
        assert [i for i, _ in got] == [i for i, _ in want]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want], atol=1e-4, rtol=0)
        hits, aq = p.search_fused(pm, qtext, 8, [1], aux_model=pm)
        assert [i for i, _ in hits] == [i for i, _ in j.search_fused(jm, qtext, 8, [1])]
        assert aq.shape == (pm.dim,)
    assert p.escalations == j.escalations


def test_audit_case_reproduces_in_port_and_jax(tmp_path, monkeypatch):
    """``chip_smoke.py --audit-case``'s chain on a clustered corpus: the
    audit redrawn sample by sample gives the audit's own mean and worst;
    the worst sample and the rows around it, written out, rebuild with the
    same bytes; and the port's and JAX's audits on that one sample give the
    overlap measured over the whole corpus (``tests/audit_case.py``)."""
    import chip_smoke
    from audit_case import reproduce

    monkeypatch.setenv("PERCEIVE_TPU_COARSE_FETCH", "")  # restored after reproduce() pins it
    rng = np.random.default_rng(5)
    n, d = 12288, 64
    centers = rng.standard_normal((8, d))
    vecs = _unit(centers[rng.integers(0, 8, n)] + 0.35 * rng.standard_normal((n, d)))
    p = Searcher(0, 0, d, device="cpu", dtype=INT2)
    # two chunks an item, as windows of one document: the first fetch doubles
    p.upsert_embeddings([(i // 2 + 1, i % 2) for i in range(n)], [i % 2 for i in range(n)], vecs)
    p.audit_coarse()
    sample, overlaps, refs, served = chip_smoke.audit_overlaps(p)
    i = int(np.argmin(overlaps))
    assert overlaps[i] < 1.0  # a sample whose top 10 the coarse pipeline misses in part
    path = str(tmp_path / "case.npz")
    case = chip_smoke.write_audit_case(p, path, int(sample[i]), overlaps[i], refs[i], served[i])
    assert case["rows"][case["pos"]] == sample[i] and len(case["rows"]) < n
    out = reproduce(path)
    assert out["kb"] == 256  # 2 x 8 x 10, bucketed
    for name in ("port", "jax"):
        assert out[name]["ref"] == refs[i] and out[name]["served"] == served[i], name
        assert out[name]["audit"]["min_overlap"] == round(overlaps[i], 6), name
        assert out[name]["audit"]["trusted"] == (overlaps[i] >= 0.95), name
