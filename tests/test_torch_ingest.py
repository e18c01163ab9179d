"""The port's ingest (connectors, scan pipeline, Searcher hooks, CLI source
commands) against the JAX package's, on the CPU.

One tiny encoder (2 layers, hidden 32, max_seq_length 64) is built in JAX
and carried to the port with ``params_from_jax``.  Both packages scan the
same file tree into databases of their own; their rows, stored bytes and
chunk keys must be equal, their embeddings within EMB_TOL (f32 on the CPU;
the reader threads make batch composition, so padding, differ), and their
ScanStats counters equal through unchanged, changed, FORCE and pruned
rescans.  The CLI's source commands and ``refresh`` run in both packages
on copies of one database: equal outputs (durations masked), then equal
``search --json`` hits after a hooked scan.  Item ids follow the reader
threads' write order in each package, so rows are compared by
external_id.
"""

import contextlib
import io
import json
import os
import re
import shutil

import jax
import numpy as np
import pytest
import torch

from perceive_tpu.cli import AppState as JaxAppState
from perceive_tpu.cli import main as jax_main
from perceive_tpu.db import Database as JaxDatabase
from perceive_tpu.db import add_source as jax_add_source
from perceive_tpu.index.searcher import Searcher as JaxSearcher
from perceive_tpu.models import EncoderArch as JaxArch
from perceive_tpu.models import HeadConfig as JaxHead
from perceive_tpu.models import Model as JaxModel
from perceive_tpu.models import TextTokenizer as JaxTokenizer
from perceive_tpu.models.tokenize import tiny_test_vocab
from perceive_tpu.sources import prune_missing_items as jax_prune
from perceive_tpu.sources import scan_source as jax_scan
from perceive_tpu.types import ItemCompareStrategy as JaxStrategy
from perceive_tpu.types import Source as JaxSource
from perceive_tpu_torch.cli import AppState, main
from perceive_tpu_torch.db import Database, add_source
from perceive_tpu_torch.index.matrix import CHUNK_STRIDE
from perceive_tpu_torch.index.searcher import Searcher
from perceive_tpu_torch.models import EncoderArch, HeadConfig, Model, TextTokenizer
from perceive_tpu_torch.models.convert import params_from_jax
from perceive_tpu_torch.sources import (
    chunk_config,
    chunk_token_windows_batch,
    prune_missing_items,
    scan_source,
)
from perceive_tpu_torch.sources.pipeline import chunk_token_windows
from perceive_tpu_torch.types import ItemCompareStrategy, Source

WORDS = "the a and search semantic music pizza river mountain notes kernel".split()
EMB_TOL = 1e-5  # f32 encoders on the CPU, the same weights
SCORE_TOL = 1e-4  # search scores: a bf16 matrix, f32 sums in another order
COUNTERS = ("scanned", "encoded", "fetched", "added", "changed", "unchanged", "embed_failed")
ITEM_SQL = """SELECT external_id, content, name, description, author, hash, raw_content,
                     skipped, modified, process_version, version FROM items"""


def tiny_models():
    """(JAX model, port model) with the same weights: 2 layers, hidden 32,
    max_seq_length 64 (a 62-token wrap budget)."""
    vocab = tiny_test_vocab(WORDS)
    kw = dict(vocab_size=len(vocab), hidden_size=32, num_layers=2, num_heads=2,
              intermediate_size=64, max_position_embeddings=64)
    jm = JaxModel.random(JaxArch(**kw), JaxHead(pooling="mean", normalize=True),
                         JaxTokenizer.from_vocab(vocab, max_seq_length=64), seed=7)
    jm.model_id = 0
    pm = Model(
        params_from_jax(jax.tree.map(np.asarray, jm.params)), EncoderArch(**kw),
        HeadConfig(pooling="mean", normalize=True), TextTokenizer.from_vocab(vocab, max_seq_length=64),
        device="cpu", compute_dtype=torch.float32, model_id=0,
    )
    return jm, pm


@pytest.fixture(scope="module")
def models():
    return tiny_models()


def words(rng, n):
    return " ".join(rng.choice(WORDS, size=n))


def make_tree(root):
    """Plain and front-matter files, a .gitignore, a hidden, an empty, a
    whitespace-only and a binary file, a non-UTF-8 filename, a nested
    directory and one document long enough for several windows."""
    rng = np.random.default_rng(5)
    root.mkdir(parents=True)
    for i in range(6):
        (root / f"doc{i}.txt").write_text(words(rng, int(rng.integers(3, 25))))
    (root / "long.txt").write_text(words(rng, 200))
    (root / "fm.md").write_text(
        "---\ntitle: Pizza notes\ndescription: a semantic summary\nauthor: river\n---\n"
        + words(rng, 12) + "\n")
    (root / "fm_date.md").write_text("---\ntitle: 2024-01-02\ntags: [a, b]\nsummary: kernel\n---\nmusic notes\n")
    (root / "fm_list.md").write_text("---\n- not\n- a mapping\n---\nsearch body\n")
    (root / "nested").mkdir()
    (root / "nested" / "deep.md").write_text(words(rng, 9))
    (root / ".gitignore").write_text("ignored/\n*.log\n")
    (root / "ignored").mkdir()
    (root / "ignored" / "skip.txt").write_text("music ignored")
    (root / "trace.log").write_text("music log")
    (root / ".hidden.txt").write_text("music hidden")
    (root / "empty.txt").write_text("")
    (root / "blank.txt").write_text("  \n\t\n")
    (root / "binary.dat").write_bytes(b"\xff\xfe\x00music\x81")
    with open(os.path.join(os.fsencode(root), b"caf\xe9.txt"), "wb") as f:
        f.write(b"river music")
    return root


class Side:
    """One package's database, source, searcher and scan/prune functions."""

    def __init__(self, pkg, path, model, root, config):
        self.pkg = pkg
        if pkg == "jax":
            self.db = JaxDatabase(path)
            self.src = jax_add_source(self.db, JaxSource(name="docs", config=config, location=str(root)))
            self.searcher = JaxSearcher(0, 0, model.dim, engine="xla")
            self.strategy, self.scan, self.prune = JaxStrategy, jax_scan, jax_prune
        else:
            self.db = Database(path)
            self.src = add_source(self.db, Source(name="docs", config=config, location=str(root)))
            self.searcher = Searcher(0, 0, model.dim, device="cpu")
            self.strategy, self.scan, self.prune = ItemCompareStrategy, scan_source, prune_missing_items
        self.model = model

    def run(self, force=False, prune=False):
        """One scan as ``source scan`` runs it: index_version bumped, the
        Searcher's pipeline hooks, then the prune; (counters, pruned
        external ids)."""
        self.src.index_version += 1
        pruned = set()
        on_emb, on_rm = self.searcher.pipeline_hooks()
        ext = self.externals()
        stats, ok = self.scan(
            self.db, self.model, self.src, on_embeddings=on_emb, on_removed=on_rm,
            compare_strategy=self.strategy.FORCE if force else None,
        )
        assert ok
        if prune:
            ids = self.prune(self.db, self.src)
            self.searcher.remove_items(ids)
            pruned = {ext[i] for i in ids}
        summary = stats.summary()
        return {k: summary[k] for k in COUNTERS}, pruned

    def externals(self):
        return dict(self.db.read().execute("SELECT id, external_id FROM items"))

    def items(self):
        return {r[0]: r[1:] for r in self.db.read().execute(ITEM_SQL)}

    def embeddings(self):
        rows = self.db.read().execute(
            """SELECT items.external_id, e.chunk_idx, e.embedding, e.seq FROM item_embeddings e
               JOIN items ON items.id = e.item_id""").fetchall()
        return {(r[0], r[1]): np.frombuffer(r[2], dtype="<f4") for r in rows}, sorted(r[3] for r in rows)

    def matrix_keys(self):
        """The live matrix's chunk keys as (external_id, chunk_idx)."""
        ext = self.externals()
        keys = [int(k) for k in np.asarray(self.searcher.matrix.item_ids) if k >= 0]
        return sorted((ext[k // CHUNK_STRIDE], k % CHUNK_STRIDE) for k in keys)


def assert_same_store(jx, pt):
    assert pt.items() == jx.items()
    pe, pseq = pt.embeddings()
    je, jseq = jx.embeddings()
    assert sorted(pe) == sorted(je)
    for key, vec in je.items():
        np.testing.assert_allclose(pe[key], vec, atol=EMB_TOL, rtol=0, err_msg=str(key))
    # one seq per row, numbered in write order from MAX(seq) in both
    assert len(set(pseq)) == len(pseq) and len(set(jseq)) == len(jseq)
    assert pt.matrix_keys() == jx.matrix_keys() == sorted(pe)


@pytest.mark.parametrize("config", [{"type": "fs"}, {"type": "fs", "globs": ["*.md", "long.txt"]}],
                         ids=["all", "globs"])
def test_scan_source_matches_jax(models, tmp_path, config):
    jm, pm = models
    root = make_tree(tmp_path / "tree")
    jx = Side("jax", tmp_path / "jax.sqlite3", jm, root, config)
    pt = Side("torch", tmp_path / "torch.sqlite3", pm, root, config)

    first = pt.run()
    assert first == jx.run()
    assert_same_store(jx, pt)
    names = {os.path.relpath(e, root) for e in pt.externals().values()}
    if "globs" in config:
        assert names == {"fm.md", "fm_date.md", "fm_list.md", "long.txt", "nested/deep.md"}
    else:
        assert names == {*(f"doc{i}.txt" for i in range(6)), "long.txt", "fm.md", "fm_date.md",
                         "fm_list.md", "nested/deep.md"}
    assert max(ci for _, ci in pt.matrix_keys()) > 0, "the long document took one window"

    # unchanged, changed (new text and mtime), FORCE, then a vanished file pruned
    assert pt.run() == jx.run()
    long_doc = root / "long.txt"
    long_doc.write_text("music river " * 20)
    st = long_doc.stat()
    os.utime(long_doc, (st.st_atime, st.st_mtime + 10))
    changed = pt.run()
    assert changed == jx.run() and changed[0]["changed"] == 1
    assert_same_store(jx, pt)
    assert pt.run(force=True) == jx.run(force=True)
    assert_same_store(jx, pt)
    (root / "fm.md").unlink()
    got = pt.run(prune=True)
    assert got == jx.run(prune=True) and got[1] == {str(root / "fm.md")}
    assert_same_store(jx, pt)
    jx.db.close()
    pt.db.close()


def test_chunker_matches_jax(models):
    from perceive_tpu.sources.pipeline import chunk_token_windows_batch as jax_chunk

    jm, pm = models
    rng = np.random.default_rng(9)
    texts = [words(rng, n) for n in (1, 30, 61, 62, 63, 200, 700)] + ["", "   "]
    for ct, co in ((62, 7), (20, 5), (500, 600), (8, 8)):
        assert chunk_token_windows_batch(pm.tokenizer, texts, ct, co) == jax_chunk(jm.tokenizer, texts, ct, co)
    assert chunk_token_windows(pm.tokenizer, texts[5], 62, 7) == jax_chunk(jm.tokenizer, texts[5:6], 62, 7)[0]
    assert chunk_config(Source(config={"type": "fs"}), pm.tokenizer) == (62, 7)
    assert chunk_config(Source(config={"type": "fs", "chunk_tokens": 0}), pm.tokenizer) == (0, 0)


def _cli(entry, state, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = entry(argv, state=state)
    return rc, out.getvalue()


def _masked(text):
    text = re.sub(r"\b\d+(\.\d+)?s\b", "<t>s", text)
    return re.sub(r"in \d+(\.\d+)? seconds", "in <t> seconds", text)


CLI_STEPS = [
    ["source", "add", "fs", "{root}", "--name", "docs", "--chunk-tokens", "20"],
    ["source", "add", "fs", "{root}", "--name", "docs"],  # duplicate name: error
    ["source", "add", "fs", "{root}", "--name", "42"],  # all digits: error
    ["source", "add", "bookmarks", "{root}", "--name", "marks", "--skip", "example.com"],
    ["source", "list"],
    ["source", "scan", "docs"],
    ["search", "music river", "-n", "5", "--json"],
    ["source", "scan", "docs", "--force"],
    ["source", "scan", "docs", "--by-content"],
    ["source", "scan", "nosuch"],
    ["source", "reprocess", "docs"],
    ["source", "rebuild-search", "docs"],
    ["source", "edit", "docs", "--new-name", "notes", "--interval", "3600", "--glob", "*.txt"],
    ["source", "edit", "notes", "--new-name", "marks"],  # taken: error
    ["source", "list"],
    ["source", "remove", "marks", "--yes"],
    ["refresh", "--due-only"],
    ["refresh", "--prune"],
    ["search", "pizza notes", "-n", "10", "--json"],
    ["source", "remove", "notes"],  # refused without --yes
    ["source", "remove", "notes", "--yes"],
    ["source", "list"],
]


def test_cli_source_commands_match_jax(models, tmp_path):
    jm, pm = models
    root = make_tree(tmp_path / "tree")
    seed = tmp_path / "seed.sqlite3"
    JaxDatabase(seed).close()
    shutil.copy(seed, tmp_path / "jax.sqlite3")
    shutil.copy(seed, tmp_path / "torch.sqlite3")
    js = JaxAppState(str(tmp_path / "jax.sqlite3"), model=jm, engine="xla")
    ps = AppState(str(tmp_path / "torch.sqlite3"), model=pm, highlights_model=pm, device="cpu")
    searched = 0
    for step in CLI_STEPS:
        argv = [a.format(root=root) for a in step]
        (jrc, jout), (prc, pout) = _cli(jax_main, js, argv), _cli(main, ps, argv)
        assert prc == jrc, argv
        if argv[0] == "search":
            want, got = json.loads(jout), json.loads(pout)
            assert got, argv
            # ids follow each package's write order: compare by url
            assert [r["url"] for r in got] == [r["url"] for r in want]
            np.testing.assert_allclose([r["score"] for r in got], [r["score"] for r in want],
                                       atol=SCORE_TOL, rtol=0)
            assert [(r["title"], r["snippet"], r["source"]) for r in got] == [
                (r["title"], r["snippet"], r["source"]) for r in want]
            searched += 1
        else:
            assert _masked(pout) == _masked(jout), argv
    assert searched == 2
    # the hooks kept the matrix current without a rebuild: everything left
    assert len(ps.searcher.matrix) == len(js.searcher.matrix) == 0
    ps.close()
    js.close()


def test_maintenance_never_runs_inside_write_txn(models, tmp_path, monkeypatch):
    """The hooks' retier/audit run after each write batch's transaction
    commits, never while it is open (as tests/test_pipeline.py holds the
    JAX package)."""
    _, pm = models
    root = make_tree(tmp_path / "tree")
    db = Database(tmp_path / "db.sqlite3")
    src = add_source(db, Source(name="docs", config={"type": "fs"}, location=str(root)))
    searcher = Searcher(0, 0, pm.dim, device="cpu")
    searcher.auto_retier = True
    calls, in_txn = [], []

    def spy(name, orig):
        def wrapper(self):
            calls.append(name)
            if db._write_conn.in_transaction:
                in_txn.append(name)
            return orig(self)

        return wrapper

    monkeypatch.setattr(Searcher, "_maybe_retier", spy("retier", Searcher._maybe_retier))
    monkeypatch.setattr(Searcher, "_audit_coarse_if_stale", spy("audit", Searcher._audit_coarse_if_stale))
    on_emb, on_rm = searcher.pipeline_hooks()
    stats, ok = scan_source(db, pm, src, on_embeddings=on_emb, on_removed=on_rm, embed_batch_size=2)
    assert ok and stats.encoded.value == 11
    assert len(searcher.matrix) > 11  # the long document's windows too
    assert calls and not in_txn, in_txn
    assert not searcher._maintenance_due
    db.close()
