"""The port's CLI commands added with its server against the JAX package's,
on the CPU.

The filter helpers (``parse_when``, ``filter_results_by_time``,
``resolve_source_filter``) run on one table of inputs in both packages.  The
commands run through both CLIs (``main(argv, state=...)``) on copies of one
database written by the JAX package with a tiny encoder carried across by
``params_from_jax``: the search flags, ``print``, ``hide``, ``tag``,
``model`` and ``stats`` print the same lines (scores within SCORE_TOL), and
every mutation leaves both databases equal.  ``import-db`` brings one
reference-layout database into each; ``doctor`` gives the JAX doctor's
database rows; the REPL runs from stdin and the desktop entry names the
port's CLI.
"""

import contextlib
import io
import json
import os
import re
import sqlite3
import sys
import types

import jax
import numpy as np
import pytest
import torch

from perceive_tpu.cli import AppState as JaxAppState
from perceive_tpu.cli import commands as jax_commands
from perceive_tpu.cli import main as jax_main
from perceive_tpu.cli.doctor import doctor as jax_doctor
from perceive_tpu.models import EncoderArch as JaxArch
from perceive_tpu.models import HeadConfig as JaxHead
from perceive_tpu.models import Model as JaxModel
from perceive_tpu.models import TextTokenizer as JaxTokenizer
from perceive_tpu.models.tokenize import tiny_test_vocab
from perceive_tpu.types import Source as JaxSource
from perceive_tpu_torch.cli import AppState, main
from perceive_tpu_torch.cli import commands
from perceive_tpu_torch.cli.doctor import doctor
from perceive_tpu_torch.models import EncoderArch, HeadConfig, Model, TextTokenizer
from perceive_tpu_torch.models.convert import params_from_jax
from perceive_tpu_torch.types import Source
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)

WORDS = "the a and search semantic music pizza river mountain notes kernel".split()
SCORE_TOL = 1e-4
T0 = 1_600_000_000
DAY = 86_400
NOW = 1_700_000_000.0
ARCH = dict(vocab_size=len(tiny_test_vocab(WORDS)), hidden_size=32, num_layers=1, num_heads=4,
            intermediate_size=64, max_position_embeddings=32)


# -- the filter helpers ---------------------------------------------------------


WHEN = ["1700000000", "123456789", "7d", "12h", "30min", "2w", "3mo", "1y", "45s", " 7d ", "10 d",
        "2026-01-15", "2026-01-15T09:30", "2026-01-15T09:30+02:00", "yesterday", "123", "", "7x"]


@pytest.mark.parametrize("text", WHEN)
def test_parse_when_matches_jax(text):
    def run(fn):
        try:
            return fn(text, now=NOW)
        except ValueError as e:
            return ("error", str(e))

    assert run(commands.parse_when) == run(jax_commands.parse_when)


def _fake_results():
    times = [(None, None), (T0, None), (None, T0 + DAY), (T0 + 2 * DAY, T0), (T0 + 5 * DAY, None)]
    return [types.SimpleNamespace(item=types.SimpleNamespace(metadata=types.SimpleNamespace(mtime=m, atime=a)))
            for m, a in times]


@pytest.mark.parametrize("after,before", [(None, None), (T0, None), (None, T0 + DAY), (T0 + DAY, T0 + 3 * DAY),
                                          (0, None), (T0 + 9 * DAY, None), (T0, T0)])
def test_filter_results_by_time_matches_jax(after, before):
    res = _fake_results()
    got = commands.filter_results_by_time(res, after, before)
    want = jax_commands.filter_results_by_time(res, after, before)
    assert [res.index(r) for r in got] == [res.index(r) for r in want]
    assert [commands.item_time(r.item) for r in res] == [jax_commands.item_time(r.item) for r in res]


def _source_state(cls):
    configs = [("alpha", {"type": "fs"}), ("web", {"type": "chromium_history"}),
               ("marks", {"type": "chromium_bookmarks"}), ("more", {"type": "fs"})]
    sources = [cls(name=n, config=c, location="/x", id=i + 1) for i, (n, c) in enumerate(configs)]
    return types.SimpleNamespace(sources=sources, source_by_name=lambda name: next(
        (s for s in sources if s.name == name or str(s.id) == name), None))


@pytest.mark.parametrize("source,type_tag", [(None, None), ("alpha", None), ("2", None), ("nosuch", None),
                                             (None, "local"), (None, "web"), (None, "bookmarks"),
                                             (None, "nope"), ("alpha", "web"), ("", "local")])
def test_resolve_source_filter_matches_jax(source, type_tag):
    def run(mod, cls):
        try:
            return mod.resolve_source_filter(_source_state(cls), source, type_tag)
        except mod.UnknownSource as e:
            return ("unknown", e.args)
        except ValueError as e:
            return ("bad", str(e))

    assert run(commands, Source) == run(jax_commands, JaxSource)


# -- the commands on copies of one database ---------------------------------------


def _copy_db(src: str, dst: str) -> None:
    with contextlib.closing(sqlite3.connect(src)) as a, contextlib.closing(sqlite3.connect(dst)) as b:
        a.backup(b)


@pytest.fixture(scope="module")
def states(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    mp = pytest.MonkeyPatch()
    mp.setenv("PERCEIVE_TPU_DATA_DIR", str(tmp / "data"))
    vocab = tiny_test_vocab(WORDS)
    jm = JaxModel.random(JaxArch(**ARCH), JaxHead(pooling="mean", normalize=True),
                         JaxTokenizer.from_vocab(vocab, max_seq_length=32), seed=13)
    jm.model_id = 0
    pm = Model(
        params_from_jax(jax.tree.map(np.asarray, jm.params)), EncoderArch(**ARCH),
        HeadConfig(pooling="mean", normalize=True), TextTokenizer.from_vocab(vocab, max_seq_length=32),
        device="cpu", compute_dtype=torch.float32, model_id=0, name=jm.name,
    )
    rng = np.random.default_rng(17)
    i = 0
    for name, n in (("alpha", 20), ("beta", 6)):
        d = tmp / name
        d.mkdir()
        for j in range(n):
            text = " ".join(rng.choice(WORDS, size=int(rng.integers(3, 18))))
            path = d / (f"n{j:02d}.md" if j % 5 == 0 else f"n{j:02d}.txt")
            path.write_text(f"---\ntitle: Note {name} {j}\n---\n{text}\n" if j % 5 == 0 else text)
            os.utime(path, (T0 + i * DAY, T0 + i * DAY))
            i += 1
    (tmp / "alpha" / "long.txt").write_text(" ".join(["music river"] * 30 + ["pizza kernel notes"] * 20))
    db = str(tmp / "db.sqlite3")
    js = JaxAppState(db, model=jm, engine="xla")
    with contextlib.redirect_stdout(io.StringIO()):
        for name in ("alpha", "beta"):
            assert jax_main(["source", "add", "fs", str(tmp / name), "--name", name], state=js) == 0
            assert jax_main(["source", "scan", name], state=js) == 0
    _copy_db(db, str(tmp / "port.sqlite3"))
    ps = AppState(str(tmp / "port.sqlite3"), model=pm, highlights_model=pm, device="cpu")
    yield {"js": js, "ps": ps, "tmp": tmp, "jm": jm, "pm": pm}
    ps.close()
    js.close()
    mp.undo()


def _run(entry, state, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = entry(argv, state=state)
    return rc, out.getvalue(), err.getvalue()


def _both(states, argv):
    want = _run(jax_main, states["js"], argv)
    got = _run(main, states["ps"], argv)
    return got, want


def _same_json_hits(got, want):
    g, w = json.loads(got), json.loads(want)
    assert [r["id"] for r in g] == [r["id"] for r in w]
    np.testing.assert_allclose([r["score"] for r in g], [r["score"] for r in w], atol=SCORE_TOL, rtol=0)
    for key in ("snippet", "title", "url", "source", "time"):
        assert [r[key] for r in g] == [r[key] for r in w], key
    return g


_SCORE = re.compile(r"\[(-?\d+\.\d+)\]")


def _same_text_hits(got, want):
    """The plain (non-JSON) result lines: equal once scores are compared
    within SCORE_TOL."""
    gs, ws = [float(x) for x in _SCORE.findall(got)], [float(x) for x in _SCORE.findall(want)]
    np.testing.assert_allclose(gs, ws, atol=SCORE_TOL, rtol=0)
    assert _SCORE.sub("[]", got) == _SCORE.sub("[]", want)


def _tables(db_path: str) -> dict:
    with contextlib.closing(sqlite3.connect(db_path)) as c:
        return {t: c.execute(f"SELECT * FROM {t} ORDER BY 1, 2").fetchall()
                for t in ("items", "tags", "item_tags", "config")}


SEARCHES = [
    ["search", "music river", "-n", "5", "--type", "local", "--json"],
    ["search", "pizza", "-n", "5", "--type", "web", "--json"],
    ["search", "notes kernel", "-n", "6", "--after", str(T0 + 8 * DAY), "--json"],
    ["search", "notes kernel", "-n", "6", "--before", str(T0 + 8 * DAY), "--json"],
    ["search", "notes kernel", "-n", "6", "--after", "2020-09-20", "--before", "2020-10-01", "--json"],
    ["search", "semantic search", "-n", "8", "--sort", "time", "--json"],
    ["search", "semantic search", "-n", "8", "--sort", "time"],
    ["search", "pizza notes", "-n", "4", "--source", "beta", "--sort", "score"],
    ["search", "pizza", "--source", "nosuch"],
    ["search", "pizza", "--after", "yesterday"],
    ["search", "pizza", "--tag", "nosuchtag"],
]


@pytest.mark.parametrize("argv", SEARCHES, ids=[" ".join(a[2:]) for a in SEARCHES])
def test_search_flags_match_jax(states, argv):
    (grc, gout, gerr), (wrc, wout, werr) = _both(states, argv)
    assert grc == wrc, (gerr, werr)
    assert gerr.splitlines()[-1:] == werr.splitlines()[-1:]
    if "--json" in argv and grc == 0:
        hits = _same_json_hits(gout, wout)
        if "--after" in argv:
            assert all(h["time"] >= int(argv[argv.index("--after") + 1]) for h in hits if argv[-3] != "--before")
        if "--sort" in argv:
            times = [h["time"] or -1 for h in hits]
            assert times == sorted(times, reverse=True)
    else:
        _same_text_hits(gout, wout)


def _alpha_ids(states, n):
    return [r[0] for r in states["js"].db.read().execute(
        "SELECT i.id FROM items i JOIN sources s ON s.id = i.source_id WHERE s.name = 'alpha' ORDER BY i.id LIMIT ?",
        (n,))]


def test_tag_commands_and_tag_search_match_jax(states):
    ids = _alpha_ids(states, 3)
    steps = [["tag", "add", str(i), "fav"] for i in ids] + [
        ["tag", "add", str(ids[0]), "other"], ["tag", "list"],
        ["search", "music river pizza", "-n", "5", "--tag", "fav", "--json"],
        ["search", "music river pizza", "-n", "300", "--tag", "fav", "--json"],
        ["search", "notes", "-n", "3", "--tag", "fav", "--sort", "time"],
        ["tag", "rm", str(ids[0]), "other"], ["tag", "rm", str(ids[0]), "other"], ["tag", "list"],
    ]
    for argv in steps:
        (grc, gout, gerr), (wrc, wout, werr) = _both(states, argv)
        assert (grc, gerr) == (wrc, werr), argv
        if "--json" in argv:
            hits = _same_json_hits(gout, wout)
            found = {h["id"] for h in hits}
            # -n 300 fetches MAX_K (1,024) rows, every item: all three
            assert found == set(ids) if "300" in argv else found <= set(ids)
        elif argv[0] == "search":
            _same_text_hits(gout, wout)
        else:
            assert gout == wout, argv
    got, want = _tables(states["ps"].db.path), _tables(states["js"].db.path)
    assert got["tags"] == want["tags"] and got["item_tags"] == want["item_tags"]


def test_print_hide_unhide_match_jax(states):
    ps, js = states["ps"], states["js"]
    md = js.db.read().execute("SELECT id FROM items WHERE external_id LIKE '%.md' ORDER BY id").fetchone()[0]
    long_id = js.db.read().execute("SELECT id FROM items WHERE external_id LIKE '%long.txt'").fetchone()[0]
    for argv in (["print", str(md)], ["print", str(md), "--raw"], ["print", str(long_id)], ["print", "999999"]):
        got, want = _both(states, argv)
        assert got == want, argv
    rows0 = len(ps.searcher.matrix)
    n_chunks = ps.db.read().execute("SELECT COUNT(*) FROM item_embeddings WHERE item_id = ?",
                                    (long_id,)).fetchone()[0]
    assert n_chunks > 1
    query = ["search", "music river pizza kernel", "-n", "40", "--json"]  # every item
    got, want = _both(states, query)
    assert long_id in [h["id"] for h in _same_json_hits(got[1], want[1])]
    got, want = _both(states, ["hide", str(long_id)])
    assert got == want
    assert len(ps.searcher.matrix) == rows0 - n_chunks
    got, want = _both(states, query)
    assert long_id not in [h["id"] for h in _same_json_hits(got[1], want[1])]
    got, want = _both(states, ["hide", str(long_id), "--unhide"])
    assert got == want
    assert len(ps.searcher.matrix) == rows0  # every chunk row is back
    got, want = _both(states, query)
    assert long_id in [h["id"] for h in _same_json_hits(got[1], want[1])]
    assert _tables(ps.db.path)["items"] == _tables(js.db.path)["items"]


def test_model_and_stats_match_jax(states):
    for argv in (["model", "list"], ["model", "set", "AllMiniLmL12V2"], ["model", "set", "nosuch"],
                 ["stats"]):
        (grc, gout, gerr), (wrc, wout, werr) = _both(states, argv)
        assert grc == wrc and gerr == werr, argv
        if argv[0] == "stats":
            keep = ("items:", "embeddings model")
            assert [l for l in gout.splitlines() if l.startswith(keep)] == [
                l for l in wout.splitlines() if l.startswith(keep)]
            line = [l for l in gout.splitlines() if l.startswith("device matrix")][0]
            assert "device cpu" in line and f"{len(states['ps'].searcher.matrix)} vectors" in line
        else:
            assert gout == wout, argv
    assert _tables(states["ps"].db.path)["config"] == _tables(states["js"].db.path)["config"]
    for st in (states["ps"], states["js"]):
        with st.db.write() as conn:
            conn.execute("DELETE FROM config WHERE key = 'model'")


# -- import-db -----------------------------------------------------------------------


def make_reference_db(path, vecs):
    """Reference-layout store (the maker of tests/test_import_reference.py):
    2 sources, 4 items (one hidden, one skipped), embeddings under
    model_id=0, 1 tag."""
    conn = sqlite3.connect(path)
    conn.executescript(
        """
        CREATE TABLE sources (id INTEGER PRIMARY KEY, name TEXT NOT NULL,
          config TEXT, location TEXT NOT NULL, compare_strategy TEXT NOT NULL,
          status TEXT NOT NULL, last_indexed BIGINT NOT NULL DEFAULT 0,
          index_version BIGINT NOT NULL DEFAULT 0, index_interval BIGINT);
        CREATE TABLE items (id INTEGER PRIMARY KEY, source_id INTEGER NOT NULL,
          external_id TEXT NOT NULL, version INTEGER NOT NULL DEFAULT 0,
          hash TEXT NOT NULL, content TEXT NOT NULL, raw_content BLOB,
          process_version INTEGER NOT NULL DEFAULT 0, name TEXT, author TEXT,
          description TEXT, modified BIGINT, last_accessed BIGINT,
          skipped TEXT, hidden_at BIGINT);
        CREATE TABLE item_embeddings (model_id INT NOT NULL,
          model_version INT NOT NULL, item_id BIGINT NOT NULL,
          item_index_version BIGINT NOT NULL, embedding BLOB NOT NULL,
          PRIMARY KEY (model_id, model_version, item_id));
        CREATE TABLE tags (id INTEGER PRIMARY KEY, name TEXT NOT NULL,
          description TEXT, color TEXT NOT NULL);
        CREATE TABLE item_tags (item_id BIGINT NOT NULL, tag_id BIGINT NOT NULL,
          PRIMARY KEY (item_id, tag_id));
        """
    )
    conn.execute(
        "INSERT INTO sources (id, name, config, location, compare_strategy, status)"
        " VALUES (1, 'notes', '{\"type\": \"fs\", \"globs\": [\"*.md\"]}', '/ref/notes',"
        " 'm_time_and_content', '{\"status\": \"ready\", \"scanned\": 4, \"duration\": 1}')"
    )
    conn.execute(
        "INSERT INTO sources (id, name, config, location, compare_strategy, status)"
        " VALUES (9, 'web', '{\"type\": \"chromium_history\", \"skip\": [\"x.com\"]}',"
        " '/ref/profile', 'm_time', '{\"status\": \"ready\", \"scanned\": 0, \"duration\": 0}')"
    )
    rows = [
        (11, 1, "/ref/notes/a.md", "a doc", "doc a", None, None),
        (12, 1, "/ref/notes/b.md", "b doc", "doc b", None, None),
        (13, 9, "https://ex.com/", "a page", "page", None, 123456),  # hidden
        (14, 9, "https://dead.com/", "", None, "FetchError: 404", None),  # skipped
    ]
    for iid, sid, ext, content, name, skipped, hidden in rows:
        conn.execute(
            "INSERT INTO items (id, source_id, external_id, hash, content, name,"
            " skipped, hidden_at) VALUES (?,?,?,?,?,?,?,?)",
            (iid, sid, ext, f"h{iid}", content, name, skipped, hidden),
        )
    for iid, v in vecs.items():
        conn.execute(
            "INSERT INTO item_embeddings (model_id, model_version, item_id,"
            " item_index_version, embedding) VALUES (0, 0, ?, 1, ?)",
            (iid, v.astype("<f4").tobytes()),
        )
    conn.execute("INSERT INTO tags (id, name, color) VALUES (5, 'work', '#fff')")
    conn.execute("INSERT INTO item_tags (item_id, tag_id) VALUES (11, 5)")
    conn.commit()
    conn.close()


def test_import_db_matches_jax(states, tmp_path):
    rng = np.random.default_rng(3)
    vecs = {i: v / np.linalg.norm(v) for i, v in zip((11, 12, 13), rng.standard_normal((3, 32)).astype(np.float32))}
    ref = tmp_path / "reference.sqlite3"
    make_reference_db(ref, vecs)
    js = JaxAppState(str(tmp_path / "jax.sqlite3"), model=states["jm"], engine="xla")
    ps = AppState(str(tmp_path / "port.sqlite3"), model=states["pm"], highlights_model=states["pm"],
                  device="cpu")
    try:
        for argv in (["source", "add", "fs", str(tmp_path), "--name", "notes"], ["import-db", str(ref)],
                     ["import-db", str(tmp_path / "missing.sqlite3")]):
            got, want = _run(main, ps, argv), _run(jax_main, js, argv)
            assert got == want, argv
        for table in ("sources", "items", "item_embeddings", "tags", "item_tags", "models", "model_versions"):
            q = f"SELECT * FROM {table} ORDER BY 1, 2"
            assert ps.db.read().execute(q).fetchall() == js.db.read().execute(q).fetchall(), table
        assert len(ps.searcher.matrix) == len(js.searcher.matrix) == 2  # the live items' vectors streamed
        for v in vecs.values():
            assert ps.searcher.search_vector(v, 2)[0][0] == js.searcher.search_vector(v, 2)[0][0]
    finally:
        ps.close()
        js.close()


# -- doctor ---------------------------------------------------------------------------


def _doctor_rows(fn, db_path) -> tuple:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(db_path) if fn is jax_doctor else fn(db_path, device="cpu")
    keep = ("database", "snapshot", "embedding dims", "unembedded items")
    rows = [l for l in out.getvalue().splitlines() if l[4:].split(":")[0] in keep]
    return rc, rows, out.getvalue()


def _minimal_db(path, shards=(), blobs=((1, "00000000"),)):
    conn = sqlite3.connect(path)
    conn.executescript(
        """
        CREATE TABLE sources (id INTEGER PRIMARY KEY, name TEXT);
        CREATE TABLE items (id INTEGER PRIMARY KEY, source_id INTEGER,
                            skipped TEXT, hidden_at BIGINT);
        CREATE TABLE item_embeddings (item_id INTEGER, model_id INTEGER,
                                      model_version INTEGER, embedding BLOB);
        CREATE TABLE vector_shards (model_id INTEGER, model_version INTEGER,
                                    path TEXT, rows INTEGER);
        INSERT INTO items (id, source_id) VALUES (1, 1), (2, 1), (3, 1);
        """
    )
    for item, hexblob in blobs:
        conn.execute("INSERT INTO item_embeddings VALUES (?, 0, 0, ?)", (item, bytes.fromhex(hexblob)))
    for shard in shards:
        conn.execute("INSERT INTO vector_shards VALUES (?, ?, ?, ?)", shard)
    conn.commit()
    conn.close()


def test_doctor_database_rows_match_jax(states, tmp_path):
    healthy = tmp_path / "healthy.sqlite3"
    _copy_db(states["ps"].db.path, str(healthy))
    v1 = tmp_path / "v1.npz"
    np.savez(v1, base_token="tok", vectors=np.zeros((1, 4), np.float32))
    corrupt = tmp_path / "bad.npz"
    corrupt.write_bytes(b"PK\x03\x04 definitely truncated")
    broken = tmp_path / "broken.sqlite3"
    broken.write_bytes(b"definitely not a sqlite file" * 100)
    snaps, dims = tmp_path / "snaps.sqlite3", tmp_path / "dims.sqlite3"
    _minimal_db(snaps, shards=[(0, 0, str(v1), 1), (1, 0, str(corrupt), 1), (2, 0, str(tmp_path / "gone.npz"), 5)])
    _minimal_db(dims, blobs=[(1, "00000000"), (2, "0000000000000000")])
    cases = {healthy: 0, broken: 1, snaps: 0, dims: 0, tmp_path / "missing.sqlite3": 0}
    for path, rc_want in cases.items():
        grc, grows, gout = _doctor_rows(doctor, str(path))
        wrc, wrows, _ = _doctor_rows(jax_doctor, str(path))
        assert grows == wrows and grows, gout
        assert grc == rc_want and (wrc == rc_want or path == healthy), gout  # (the JAX doctor's own checks)
    assert "! device platform" in _doctor_rows(doctor, str(healthy))[2]


def test_doctor_reports_the_tokenizer_library(tmp_path, monkeypatch):
    """The compiled tokenizer is a hard dependency: ok when its library
    loads, a failure (with the build's error) when it does not build."""
    from perceive_tpu_torch.native import tokenizer as native_tokenizer

    db = str(tmp_path / "missing.sqlite3")
    rc, _, out = _doctor_rows(doctor, db)
    assert rc == 0 and f"✓ tokenizer library: loaded {native_tokenizer.library_path().name}" in out, out
    monkeypatch.setattr(native_tokenizer, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_tokenizer, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native_tokenizer, "_lib", None)
    rc, _, out = _doctor_rows(doctor, db)
    assert rc == 1 and "✗ tokenizer library: the tokenizer library did not build" in out, out


# -- REPL, desktop entry ------------------------------------------------------------------


def test_repl_from_stdin(states, monkeypatch):
    from perceive_tpu_torch.cli import repl as repl_mod

    monkeypatch.setattr(repl_mod, "data_dir", lambda: states["tmp"])
    lines = ["", "help", "stats", "search pizza -n 2 --json", "bogus-command", "print 'unclosed", "tag list",
             "quit", "stats"]
    monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(lines) + "\n"))
    rc, out, err = _run(main, states["ps"], [])
    assert rc == 0
    assert "usage: perceive-tpu-torch" in out and "items:" in out
    assert out.count("items:") == 1  # nothing after quit ran
    assert json.loads([l for l in out.splitlines() if l.lstrip("> ").startswith("[")][0].lstrip("> "))
    assert "parse error" in err and "invalid choice" in err


def test_desktop_entry_names_the_port(tmp_path, monkeypatch):
    from perceive_tpu_torch.cli.desktop import ENTRY_NAME, install_desktop_entry
    from perceive_tpu_torch.cli.state import AppState as PortAppState

    path = install_desktop_entry(base_dir=str(tmp_path))
    assert os.path.basename(path) == ENTRY_NAME == "perceive-tpu-torch.desktop"
    text = open(path).read()
    assert "-m perceive_tpu_torch.cli app" in text and "Exec=" in text

    def boom(*a, **k):
        raise AssertionError("AppState built for a plain file write")

    monkeypatch.setenv("XDG_DATA_HOME", str(tmp_path / "xdg"))
    monkeypatch.setattr(PortAppState, "__init__", boom)
    rc, out, _ = _run(main, None, ["app", "--install"])
    if sys.platform != "darwin":
        assert rc == 0 and out.strip() == str(tmp_path / "xdg" / "applications" / ENTRY_NAME)


@pytest.mark.parametrize("argv", [["serve", "--port", "0"], ["app", "--no-browser", "--port", "0"], ["stats"]])
def test_entry_points_need_cuda(tmp_path, argv):
    """The CLI's AppState is on cuda:0: without CUDA it raises, and nothing
    falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--db", str(tmp_path / "db.sqlite3"), *argv])
