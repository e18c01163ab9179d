"""The port's text-query slice against the JAX package's, end to end on CPU.

One SQLite database is ingested once by the JAX package's pipeline with a
tiny model of the random-fallback shape; the same params reach the port
through ``params_from_jax``.  Then ``search --json`` runs through both
CLIs: same ids in the same order, scores within 1e-4 (bf16 matrix, f32
accumulation in another order), same snippets.
"""

import io
import json
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from perceive_tpu.cli import AppState as JaxAppState
from perceive_tpu.cli import main as jax_main
from perceive_tpu.models import EncoderArch as JaxArch
from perceive_tpu.models import HeadConfig as JaxHead
from perceive_tpu.models import Model as JaxModel
from perceive_tpu.models import TextTokenizer as JaxTokenizer
from perceive_tpu.models.tokenize import tiny_test_vocab
from perceive_tpu_torch.cli import AppState, main
from perceive_tpu_torch.models import EncoderArch, HeadConfig, Model, TextTokenizer
from perceive_tpu_torch.models.convert import params_from_jax
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)

WORDS = "the a and search semantic music pizza river mountain notes kernel".split()
SCORE_TOL = 1e-4


def _docs():
    rng = np.random.default_rng(3)
    docs = {}
    for i in range(12):
        words = rng.choice(WORDS, size=int(rng.integers(4, 30)))
        docs[f"doc{i:02d}.txt"] = " ".join(words)
    # long enough for several windows at the 126-token wrap budget: the
    # chunk-embedding (dedupe) path
    docs["long.txt"] = " ".join(["music river"] * 100 + ["pizza kernel notes"] * 60)
    return docs


@pytest.fixture(scope="module")
def states(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("slice")
    vocab = tiny_test_vocab(WORDS)
    arch_kw = dict(vocab_size=len(vocab), hidden_size=128, num_layers=2, num_heads=4,
                   intermediate_size=256, max_position_embeddings=128)
    jm = JaxModel.random(JaxArch(**arch_kw), JaxHead(pooling="mean", normalize=True),
                         JaxTokenizer.from_vocab(vocab, max_seq_length=128), seed=5)
    jm.model_id = 0
    pm = Model(
        params_from_jax(jax.tree.map(np.asarray, jm.params)), EncoderArch(**arch_kw),
        HeadConfig(pooling="mean", normalize=True), TextTokenizer.from_vocab(vocab, max_seq_length=128),
        device="cpu", compute_dtype=torch.float32, model_id=0,
    )
    db = str(tmp / "db.sqlite3")
    js = JaxAppState(db, model=jm, engine="xla")
    for name, docs in (("alpha", _docs()), ("beta", {"b.txt": "pizza pizza notes", "c.txt": "mountain river"})):
        d = tmp / name
        d.mkdir()
        for fname, text in docs.items():
            (d / fname).write_text(text)
        with redirect_stdout(io.StringIO()):
            assert jax_main(["source", "add", "fs", str(d), "--name", name], state=js) == 0
            assert jax_main(["source", "scan", name], state=js) == 0
    ps = AppState(db, model=pm, highlights_model=pm, device="cpu")
    yield js, ps
    ps.close()
    js.close()


def _search(entry, state, argv):
    out = io.StringIO()
    with redirect_stdout(out):
        assert entry(argv, state=state) == 0
    return json.loads(out.getvalue())


@pytest.mark.parametrize(
    "argv",
    [
        ["search", "music river", "-n", "5", "--json"],
        ["search", "pizza kernel notes", "-n", "10", "--json"],
        ["search", "semantic search", "-n", "3", "--json"],
        ["search", "pizza", "-n", "5", "--source", "beta", "--json"],
        ["search", "mountain notes", "-n", "4", "--source", "alpha", "--json"],
    ],
)
def test_cli_search_matches_jax(states, argv):
    js, ps = states
    want = _search(jax_main, js, argv)
    got = _search(main, ps, argv)
    assert got, "no results"
    assert [r["id"] for r in got] == [r["id"] for r in want]
    np.testing.assert_allclose([r["score"] for r in got], [r["score"] for r in want], atol=SCORE_TOL, rtol=0)
    assert [r["snippet"] for r in got] == [r["snippet"] for r in want]
    assert [(r["title"], r["url"], r["source"], r["time"]) for r in got] == [
        (r["title"], r["url"], r["source"], r["time"]) for r in want
    ]


def test_chunked_document_dedupes(states):
    js, ps = states
    assert ps.searcher.matrix.multi_chunk_groups == js.searcher.matrix.multi_chunk_groups == 1
    assert len(ps.searcher.matrix) == len(js.searcher.matrix)
    got = _search(main, ps, ["search", "music river pizza", "-n", "15", "--json"])
    ids = [r["id"] for r in got]
    assert len(ids) == len(set(ids))


def test_like_search_matches_jax(states):
    js, ps = states
    item = js.searcher.matrix.item_ids[0] // 4096
    argv = ["search", "--like", str(item), "-n", "5", "--json"]
    want, got = _search(jax_main, js, argv), _search(main, ps, argv)
    assert [r["id"] for r in got] == [r["id"] for r in want]
    np.testing.assert_allclose([r["score"] for r in got], [r["score"] for r in want], atol=SCORE_TOL, rtol=0)


def test_searcher_updates_match_jax(states):
    """Batched search, upserts, removals and a source rebuild on fresh
    searchers built from the same database: same ids, scores within
    SCORE_TOL."""
    from perceive_tpu.index.searcher import Searcher as JaxSearcher
    from perceive_tpu_torch.index.searcher import Searcher

    js, ps = states
    mid, ver, dim = ps.model.model_id, ps.model.model_version, ps.model.dim
    jsr = JaxSearcher.build(js.db, mid, ver, dim, engine="xla", use_snapshot=False)
    psr = Searcher.build(ps.db, mid, ver, dim, device="cpu")

    def same(got, want):
        assert [i for i, _ in got] == [i for i, _ in want]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want], atol=SCORE_TOL, rtol=0)

    rng = np.random.default_rng(4)
    qs = rng.standard_normal((3, dim)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    for g, w in zip(psr.search_vectors_batch(qs, 6), jsr.search_vectors_batch(qs, 6)):
        same(g, w)
    beta = ps.source_by_name("beta").id
    for srch in (psr, jsr):
        srch.upsert_embeddings([99_999, (99_998, 0), (99_998, 1)], [beta] * 3, qs)
    same(psr.search_vector(qs[0], 5), jsr.search_vector(qs[0], 5))
    assert psr.search_vector(qs[0], 1)[0][0] == 99_999
    gone = [99_999] + [i for i, _ in psr.search_vector(qs[1], 2)]
    assert psr.remove_items(gone) == jsr.remove_items(gone)
    same(psr.search_vector(qs[1], 8), jsr.search_vector(qs[1], 8))
    assert psr.rebuild_source(ps.db, beta) == jsr.rebuild_source(js.db, beta)
    for q in qs:
        same(psr.search_vector(q, 10, [beta]), jsr.search_vector(q, 10, [beta]))
    item = int(psr.matrix.item_ids[0]) // 4096
    got, want = psr.stored_embeddings(ps.db, item), jsr.stored_embeddings(js.db, item)
    assert got and len(got) == len(want)
    for (gc, gv), (wc, wv) in zip(got, want):
        assert gc == wc
        np.testing.assert_array_equal(gv, wv)
    got = psr.search_and_retrieve(ps.db, ps.model, "pizza notes", 5)
    want = jsr.search_and_retrieve(js.db, js.model, "pizza notes", 5)
    assert [r.item.id for r in got] == [r.item.id for r in want]


def test_unknown_source_is_an_error(states):
    _, ps = states
    assert main(["search", "pizza", "--source", "nosuch"], state=ps) == 1
