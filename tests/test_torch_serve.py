"""The port's HTTP server against the JAX package's, request for request, on
the CPU.

One small database (a few dozen items in two fs sources, files with spread
mtimes, a long document embedded as several windows) is written by the JAX
package's CLI with a tiny encoder (hidden 32) whose weights reach the port
through ``params_from_jax``.  Each package serves its own copy of it
(``start_server``, both background warmers off), and one table of requests
goes to both: status codes equal, hits equal (ids, snippets, titles, urls,
sources, times; scores within SCORE_TOL), error payloads equal.  The
port-only cases follow: the readiness gate, a server stopped mid-build, a
kernel error in the warm-up, the SSE push, the refresh loop's per-source
isolation, the dispatch gauge and the SIGTERM drain.
"""

import contextlib
import http.client
import io
import json
import os
import signal
import sqlite3
import threading
import time

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
from perceive_tpu.serve import start_server as jax_start_server
from perceive_tpu_torch import serve as serve_mod
from perceive_tpu_torch.cli import AppState, main
from perceive_tpu_torch.models import EncoderArch, HeadConfig, Model, TextTokenizer
from perceive_tpu_torch.models.convert import params_from_jax
from perceive_tpu_torch.ops import topk
from perceive_tpu_torch.serve import start_server
from perceive_tpu_torch.utils import dispatchmeter
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)

WORDS = "the a and search semantic music pizza river mountain notes kernel".split()
SCORE_TOL = 1e-4  # a bf16 matrix, f32 sums in another order
T0 = 1_600_000_000  # the files' mtimes: T0 + i days
DAY = 86_400
ARCH = dict(vocab_size=len(tiny_test_vocab(WORDS)), hidden_size=32, num_layers=1, num_heads=4,
            intermediate_size=64, max_position_embeddings=32)


def _docs():
    rng = np.random.default_rng(7)
    alpha = {f"a{i:02d}.txt": " ".join(rng.choice(WORDS, size=int(rng.integers(3, 20)))) for i in range(24)}
    alpha["long.txt"] = " ".join(["music river"] * 30 + ["pizza kernel notes"] * 20)
    beta = {f"b{i:02d}.txt": " ".join(rng.choice(WORDS, size=int(rng.integers(3, 12)))) for i in range(8)}
    return {"alpha": alpha, "beta": beta}


def _models():
    vocab = tiny_test_vocab(WORDS)
    jm = JaxModel.random(JaxArch(**ARCH), JaxHead(pooling="mean", normalize=True),
                         JaxTokenizer.from_vocab(vocab, max_seq_length=32), seed=9)
    jm.model_id = 0
    pm = Model(
        params_from_jax(jax.tree.map(np.asarray, jm.params)), EncoderArch(**ARCH),
        HeadConfig(pooling="mean", normalize=True), TextTokenizer.from_vocab(vocab, max_seq_length=32),
        device="cpu", compute_dtype=torch.float32, model_id=0,
    )
    return jm, pm


def _write_tree(root, docs):
    i = 0
    for name, files in docs.items():
        d = root / name
        d.mkdir()
        for fname, text in files.items():
            (d / fname).write_text(text)
            os.utime(d / fname, (T0 + i * DAY, T0 + i * DAY))
            i += 1


def _copy_db(src: str, dst: str) -> None:
    """A consistent copy of a live WAL database (the backup API)."""
    with contextlib.closing(sqlite3.connect(src)) as a, contextlib.closing(sqlite3.connect(dst)) as b:
        a.backup(b)


def _wait_ready(server, timeout=120):
    assert server.perceive_state.ready.wait(timeout), "server never became ready"


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """The JAX package's server and the port's over copies of one database."""
    tmp = tmp_path_factory.mktemp("serve")
    mp = pytest.MonkeyPatch()
    mp.setenv("PERCEIVE_TPU_WARM_BATCH_SHAPES", "0")
    mp.setenv("PERCEIVE_TPU_WARM_HIGHLIGHTS", "0")
    mp.setenv("PERCEIVE_TPU_DATA_DIR", str(tmp / "data"))
    jm, pm = _models()
    _write_tree(tmp, _docs())
    db = str(tmp / "db.sqlite3")
    js = JaxAppState(db, model=jm, engine="xla")
    with contextlib.redirect_stdout(io.StringIO()):
        for name in ("alpha", "beta"):
            assert jax_main(["source", "add", "fs", str(tmp / name), "--name", name], state=js) == 0
            assert jax_main(["source", "scan", name], state=js) == 0
    _copy_db(db, str(tmp / "port.sqlite3"))
    ps = AppState(str(tmp / "port.sqlite3"), model=pm, highlights_model=pm, device="cpu")
    jsrv = jax_start_server(lambda: js, port=0)
    psrv = start_server(lambda: ps, port=0)
    _wait_ready(jsrv)
    _wait_ready(psrv)
    assert psrv.perceive_state.error is None, psrv.perceive_state.error
    yield {"jax": jsrv, "port": psrv, "js": js, "ps": ps, "pm": pm, "tmp": tmp}
    for srv in (psrv, jsrv):
        srv.perceive_state.stop()
        srv.shutdown()
        srv.server_close()
    ps.close()
    js.close()
    mp.undo()


def _request(server, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=60)
    try:
        if isinstance(body, (dict, list)):
            body = json.dumps(body)
        if headers is not None:  # raw: the headers exactly as given
            conn.putrequest(method, path)
            for k, v in headers.items():
                conn.putheader(k, v)
            conn.endheaders()
        else:
            conn.request(method, path, body=body, headers={"Content-Type": "application/json"} if body else {})
        r = conn.getresponse()
        return r.status, r.getheader("Content-Type"), r.read()
    finally:
        conn.close()


def _metrics(server) -> dict:
    text = _request(server, "GET", "/metrics")[2].decode()
    return {line.split()[0]: float(line.split()[1]) for line in text.splitlines() if line and line[0] != "#"}


def _same_hits(got, want):
    assert [r["id"] for r in got] == [r["id"] for r in want]
    np.testing.assert_allclose([r["score"] for r in got], [r["score"] for r in want], atol=SCORE_TOL, rtol=0)
    for key in ("snippet", "title", "url", "source", "time"):
        assert [r[key] for r in got] == [r[key] for r in want], key


AFTER, BEFORE = T0 + 10 * DAY, T0 + 20 * DAY
CASES = [
    # GET /search: k, source, type, after/before (epoch 0 and "" included)
    ("GET", "/search?q=music%20river&k=5", None, None),
    ("GET", "/search?q=pizza%20kernel%20notes", None, None),
    ("GET", "/search?q=pizza&k=3&source=beta", None, None),
    ("GET", "/search?q=pizza&k=20&type=local", None, None),
    ("GET", "/search?q=pizza&k=20&type=web", None, None),
    ("GET", f"/search?q=notes%20river&k=8&after={AFTER}", None, None),
    ("GET", f"/search?q=notes%20river&k=8&before={BEFORE}", None, None),
    ("GET", f"/search?q=mountain&k=6&after={AFTER}&before={BEFORE}&source=alpha", None, None),
    ("GET", "/search?q=semantic&k=4&after=&before=", None, None),
    ("GET", "/search?q=semantic&k=4&after=0", None, None),
    ("GET", "/search?q=semantic&k=4&after=2020-09-20", None, None),
    # GET guards
    ("GET", "/search?q=pizza&k=abc", None, None),
    ("GET", "/search?q=pizza&k=0", None, None),
    ("GET", "/search?q=pizza&k=257", None, None),
    ("GET", "/search?k=3", None, None),
    ("GET", "/search?q=pizza&source=nosuch", None, None),
    ("GET", "/search?q=pizza&type=nope", None, None),
    ("GET", "/search?q=pizza&after=yesterday", None, None),
    # POST /search
    ("POST", "/search", {"q": "music", "k": 4}, None),
    ("POST", "/search", {"query": "pizza notes", "source": "beta"}, None),
    ("POST", "/search", {"q": "river", "type": "local", "k": 7}, None),
    ("POST", "/search", {"q": "notes", "after": 0, "k": 12}, None),
    ("POST", "/search", {"q": "notes", "before": BEFORE, "k": 12}, None),
    ("POST", "/search", {"q": "notes", "after": "", "before": None}, None),
    # POST guards
    ("POST", "/search", "{not json", None),
    ("POST", "/search", [1, 2], None),
    ("POST", "/search", {"q": 5}, None),
    ("POST", "/search", {"k": 3}, None),
    ("POST", "/search", {"q": "pizza", "k": "x"}, None),
    ("POST", "/search", {"q": "pizza", "k": 300}, None),
    ("POST", "/search", {"q": "pizza", "source": "nosuch"}, None),
    ("POST", "/search", {"q": "pizza", "type": "nope"}, None),
    ("POST", "/search", {"q": "pizza", "after": True}, None),
    ("POST", "/search", None, {"Content-Length": "-1"}),
    ("POST", "/search", None, {"Content-Length": str(100 << 20)}),
    ("POST", "/search", None, {"Content-Length": "abc"}),
    ("POST", "/elsewhere", {"q": "pizza"}, None),
    # the other routes
    ("GET", "/sources", None, None),
    ("GET", "/nope", None, None),
]


@pytest.mark.parametrize("method,path,body,headers", CASES, ids=[f"{m} {p} {b}" for m, p, b, _ in CASES])
def test_requests_match_jax(servers, method, path, body, headers):
    want = _request(servers["jax"], method, path, body, headers)
    got = _request(servers["port"], method, path, body, headers)
    assert got[0] == want[0], (got, want)
    g, w = json.loads(got[2]), json.loads(want[2])
    if want[0] == 200 and path.startswith("/search"):
        assert isinstance(g, list)
        _same_hits(g, w)
    else:
        assert g == w


def test_filters_select_rows(servers):
    """The filter cases above are not vacuous: each returns hits, and the
    time windows drop some."""
    port = servers["port"]
    every = json.loads(_request(port, "GET", "/search?q=notes%20river&k=40")[2])
    after = json.loads(_request(port, "GET", f"/search?q=notes%20river&k=8&after={AFTER}")[2])
    before = json.loads(_request(port, "GET", f"/search?q=notes%20river&k=8&before={BEFORE}")[2])
    assert after and before and len(every) > len(after)
    assert all(r["time"] >= AFTER for r in after) and all(r["time"] < BEFORE for r in before)
    beta = json.loads(_request(port, "GET", "/search?q=pizza&k=3&source=beta")[2])
    assert beta and {r["source"] for r in beta} == {"beta"}


def test_status_metrics_and_page_match_jax(servers):
    jstat = json.loads(_request(servers["jax"], "GET", "/status")[2])
    pstat = json.loads(_request(servers["port"], "GET", "/status")[2])
    assert sorted(pstat) == sorted(jstat)
    for key in ("model_loaded", "searcher_built", "rows", "error", "tier"):
        assert pstat[key] == jstat[key], key
    assert pstat["model_loaded"] and pstat["rows"] > 34  # the long document: several windows

    def names(server):
        return {k.split("{")[0] for k in _metrics(server)}

    assert names(servers["port"]) == names(servers["jax"])
    jp, pp = (_request(servers[s], "GET", p) for s in ("jax", "port") for p in ("/",))
    assert pp[0] == jp[0] == 200 and pp[1] == jp[1] and pp[2] == jp[2]
    assert _request(servers["port"], "GET", "/index.html")[2] == jp[2]


def _held_server(ps, **kw):
    """A port server whose builder waits for the returned Event."""
    go = threading.Event()

    def builder():
        assert go.wait(60)
        return ps

    return start_server(builder, port=0, **kw), go


def test_503_before_readiness(servers):
    srv, go = _held_server(servers["ps"])
    try:
        status, _, body = _request(srv, "GET", "/search?q=pizza")
        assert status == 503 and json.loads(body) == {"status": "loading", "error": None}
        assert _request(srv, "POST", "/search", {"q": "pizza"})[0] == 503
        assert _request(srv, "GET", "/sources")[0] == 503
        assert json.loads(_request(srv, "GET", "/status")[2])["model_loaded"] is False
        assert _metrics(srv)["perceive_ready"] == 0
        go.set()
        _wait_ready(srv)
        assert _request(srv, "GET", "/search?q=pizza")[0] == 200
        assert _metrics(srv)["perceive_ready"] == 1
    finally:
        go.set()
        srv.perceive_state.stop()
        srv.shutdown()
        srv.server_close()


def test_stop_before_build_ends_answers_503(servers):
    """A server stopped while its state is still building gets no executor:
    /search answers 503 instead of searching around it."""
    srv, go = _held_server(servers["ps"])
    try:
        srv.perceive_state._stop_refresh.set()  # stop()'s first step
        go.set()
        _wait_ready(srv)
        assert srv.perceive_state.executor is None
        status, _, body = _request(srv, "GET", "/search?q=pizza")
        assert status == 503 and json.loads(body) == {"error": "the server is stopping"}
        assert _request(srv, "POST", "/search", {"q": "pizza"})[0] == 503
    finally:
        go.set()
        srv.perceive_state.stop()
        srv.shutdown()
        srv.server_close()


def test_kernel_error_in_warmup_is_not_ready(servers, monkeypatch):
    """A kernel that fails to build or launch before readiness sets
    ``error``: /status reports it and /search answers 503, never a ready
    server answering 500s."""
    def broken(*a, **k):
        raise RuntimeError("perceive_scan_flat_rows failed: CUDA error 209 (no kernel image)")

    monkeypatch.setattr(topk, "scan_topk", broken)
    srv = start_server(lambda: servers["ps"], port=0)
    try:
        _wait_ready(srv)
        status = json.loads(_request(srv, "GET", "/status")[2])
        assert status["model_loaded"] is False and "CUDA error 209" in status["error"]
        code, _, body = _request(srv, "GET", "/search?q=pizza")
        assert code == 503 and "CUDA error 209" in json.loads(body)["error"]
        assert _metrics(srv)["perceive_ready"] == 0
        assert srv.perceive_state.warmers == []  # no warmer runs on a failed state
    finally:
        srv.perceive_state.stop()
        srv.shutdown()
        srv.server_close()


def test_sse_pushes_load_status(servers):
    srv, go = _held_server(servers["ps"])
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1], timeout=60)
        conn.request("GET", "/events")
        r = conn.getresponse()
        assert r.getheader("Content-Type").startswith("text/event-stream")
        first = r.fp.readline() + r.fp.readline() + r.fp.readline()
        assert b"event: load_status" in first and json.loads(first.split(b"data: ")[1])["model_loaded"] is False
        go.set()
        rest = r.read().decode()
        conn.close()
        assert json.loads(rest.split("data: ")[1].split("\n")[0])["model_loaded"] is True
    finally:
        go.set()
        srv.perceive_state.stop()
        srv.shutdown()
        srv.server_close()


@pytest.fixture()
def fresh_state(servers, tmp_path):
    """A port AppState over a database of its own (the refresh writes)."""
    ps = AppState(str(tmp_path / "own.sqlite3"), model=servers["pm"], highlights_model=servers["pm"],
                  device="cpu")
    yield ps
    ps.close()


def _cli(state, *argv):
    with contextlib.redirect_stdout(io.StringIO()):
        assert main(list(argv), state=state) == 0


def _wait(pred, timeout=60):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return pred()


def test_refresh_loop_isolates_failing_source(fresh_state, tmp_path):
    from perceive_tpu_torch.db import get_source, update_source

    good = tmp_path / "ok"
    good.mkdir()
    (good / "a.txt").write_text("music river notes")
    _cli(fresh_state, "source", "add", "fs", str(good), "--name", "ok")
    _cli(fresh_state, "source", "add", "fs", str(tmp_path / "gone"), "--name", "bad")
    bad = fresh_state.source_by_name("bad")
    bad.config["type"] = "no_such_scanner"
    update_source(fresh_state.db, bad)
    srv = start_server(lambda: fresh_state, port=0, refresh_interval=0.2)
    holder = srv.perceive_state
    try:
        assert _wait(lambda: holder.refresh_scans_total >= 1 and holder.refresh_errors_total >= 1)
        assert get_source(fresh_state.db, bad.id).status.status == "error"
        assert get_source(fresh_state.db, fresh_state.source_by_name("ok").id).status.status == "ready"
        hits = json.loads(_request(srv, "GET", "/search?q=music%20river&k=3")[2])
        assert hits and hits[0]["url"].endswith("a.txt")
        metrics = _metrics(srv)
        assert metrics["perceive_refresh_scans_total"] >= 1 and metrics["perceive_refresh_errors_total"] >= 1
    finally:
        holder.stop()
        srv.shutdown()
        srv.server_close()
    assert not holder._build_thread.is_alive()


def test_dispatch_gauge_counts_encodes_and_ignores_refresh(fresh_state, tmp_path):
    """The port counts the dispatches the JAX package misses (a query
    encoded outside the fused path, a highlight chunk batch) and subtracts
    the background refresh's, as it subtracts the warm-up's."""
    model = fresh_state.model
    before = dispatchmeter.snapshot().get("encode", 0)
    model.encode_query("pizza notes")
    assert dispatchmeter.snapshot()["encode"] == before + 1
    model.highlight("pizza", ["a document about pizza and notes, never seen before " * 3])
    assert dispatchmeter.snapshot()["encode"] == before + 2

    docs = tmp_path / "docs"
    docs.mkdir()
    (docs / "a.txt").write_text("music river notes")
    _cli(fresh_state, "source", "add", "fs", str(docs), "--name", "docs")
    _cli(fresh_state, "source", "scan", "docs")
    srv = start_server(lambda: fresh_state, port=0, refresh_interval=0.2)
    holder = srv.perceive_state
    try:
        _wait_ready(srv)
        for q in ("music river", "notes", "pizza"):
            assert _request(srv, "GET", f"/search?q={q.replace(' ', '%20')}&k=3")[0] == 200
        gauge = _metrics(srv)["perceive_dispatches_per_request"]
        assert gauge > 0
        refresh0 = dispatchmeter.snapshot().get("refresh", 0)
        (docs / "b.txt").write_text("mountain kernel semantic search " * 4)
        assert _wait(lambda: dispatchmeter.snapshot().get("refresh", 0) > refresh0)
        assert _wait(lambda: len(fresh_state.searcher.matrix) == 2)
        assert _metrics(srv)["perceive_dispatches_per_request"] == gauge
    finally:
        holder.stop()
        srv.shutdown()
        srv.server_close()


def test_serve_drains_on_sigterm(servers):
    before = signal.getsignal(signal.SIGTERM)
    stopped = []
    real_stop = serve_mod.ServeState.stop

    def spy(self, *a, **k):
        stopped.append(self)
        return real_stop(self, *a, **k)

    def kill_soon():
        deadline = time.time() + 30
        while time.time() < deadline and signal.getsignal(signal.SIGTERM) == before:
            time.sleep(0.02)
        os.kill(os.getpid(), signal.SIGTERM)

    serve_mod.ServeState.stop = spy
    try:
        threading.Thread(target=kill_soon, daemon=True).start()
        t0 = time.time()
        serve_mod.serve(servers["ps"], port=0)  # returns only on shutdown
    finally:
        serve_mod.ServeState.stop = real_stop
    assert time.time() - t0 < 30
    assert signal.getsignal(signal.SIGTERM) == before
    assert len(stopped) == 1 and not stopped[0]._build_thread.is_alive()


def test_profiling_trace(tmp_path, monkeypatch):
    """``trace`` is free without PERCEIVE_TPU_TRACE_DIR and writes a
    torch.profiler Chrome trace with it; ``annotate`` names a region."""
    from perceive_tpu_torch.utils import profiling

    monkeypatch.delenv(profiling.TRACE_ENV, raising=False)
    with profiling.trace("off"):
        pass
    monkeypatch.setenv(profiling.TRACE_ENV, str(tmp_path / "traces"))
    with profiling.trace("serve"):
        with profiling.annotate("scan"):
            torch.ones(8) @ torch.ones(8)
    (path,) = (tmp_path / "traces").iterdir()
    assert path.name.startswith("serve-") and '"scan"' in path.read_text()
