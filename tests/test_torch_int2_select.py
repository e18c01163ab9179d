"""The int2 tier's other coarse selects (tiletop through K10's plain
version, window, threshold) against the JAX package's, on the CPU.

Same seeded numpy inputs to both.  ``pallas_int2_scores_tiletop`` and the
tiletop pipeline run in interpret mode (``engine="pallas"``), the window and
threshold pipelines with ``engine="xla"``, as the JAX package's own tests
run them here.  Tolerances: none.  K10's (vals, rows), including the
(-inf, first row of the bin) places of bins that run out of finite scores,
and each pipeline's fine scores, rows and floor equal JAX's bit for bit;
the searcher pinned to each select returns JAX's hits (same ids, scores
within 1e-6 relative: both rerank in f32 on the host).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceive_tpu.index.matrix import INT2 as JAX_INT2
from perceive_tpu.index.searcher import Searcher as JaxSearcher
from perceive_tpu.ops import topk as jax_topk
from perceive_tpu_torch.index.matrix import INT2, _quantize, _quantize2, _quantize4
from perceive_tpu_torch.index.searcher import Searcher
from perceive_tpu_torch.ops import int2, topk
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)


def _unit(x):
    return (x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-30)).astype(np.float32)


def _allowed(ids=None):
    a = np.full(16, -9, dtype=np.int32)
    if ids is None:
        a[0] = topk.ALLOW_ALL
    else:
        a[: len(ids)] = ids
    return a


def _t(*xs):
    return tuple(torch.from_numpy(np.array(x)) for x in xs)


def _j(*xs):
    return tuple(jnp.asarray(x) for x in xs)


# -- K10 -----------------------------------------------------------------------

TILETOP_CASES = [
    # (nq, n, d, n_sweep, kc, m_top, filter, case): tile_n 12288, 8192, 4096 in turn
    (1, 24576, 32, 0, 300, 0, None, "random"),  # 2 tiles of 12,288, M = 384 from the depth rule
    (2, 16384, 32, 0, 0, 512, [0, 2], "dead_bins"),  # 8,192; a filter that empties whole bins
    (8, 20480, 32, 0, 1200, 0, None, "tombstones"),  # 4,096; M = 512 from the depth rule
    (2, 36864, 32, 24576, 0, 256, [1], "ties"),  # a sweep prefix of 2 x 12,288; equal scores in a bin
    (2, 8192, 96 * 4, 0, 0, 256, None, "random"),  # d4 = 96 at Q = 2: one 8,192-row tile
]


def _tiletop_inputs(nq, n, d, case, seed):
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 256, (d // 4, n), dtype=np.uint8)
    scales = rng.uniform(0.005, 0.02, n).astype(np.float32)
    src = rng.integers(0, 3, n).astype(np.int32)
    if case == "ties":  # rows r and r + 512 alike: the same bin, other sublanes
        packed = np.ascontiguousarray(np.tile(packed[:, :512], (1, n // 512)))
        scales = np.tile(scales[:512], n // 512)
    if case == "dead_bins":  # lanes 0-4 hold only source 1, which the filter drops
        src[(np.arange(n) % 128) < 5] = 1
    if case == "tombstones":
        src[rng.random(n) < 0.05] = -1
        src[(np.arange(n) % 128) == 7] = -1  # and one lane wholly tombstoned
    q = _unit(rng.standard_normal((nq, d)))
    return packed, scales, src, q


@pytest.mark.parametrize("nq,n,d,n_sweep,kc,m_top,filt,case", TILETOP_CASES)
def test_tiletop_plain_matches_pallas_kernel(nq, n, d, n_sweep, kc, m_top, filt, case):
    packed, scales, src, q = _tiletop_inputs(nq, n, d, case, nq + n)
    allowed = _allowed(filt)
    qi8, qs = jax.jit(jax_topk.quantize_queries)(jnp.asarray(q))
    ns = n_sweep or n
    want = jax_topk.pallas_int2_scores_tiletop(
        jnp.asarray(packed), jnp.asarray(scales).reshape(1, n), jnp.asarray(src).reshape(1, n), qi8, qs,
        jnp.asarray(allowed), True, n_sweep, kc=kc, m_top=m_top)
    wv, wr = (np.asarray(x) for x in want)
    before = int2.LAUNCHES_TILETOP
    gv, gr = int2.int2_tiletop(*_t(packed, scales, src, np.asarray(qi8), np.asarray(qs), allowed), n_sweep,
                               kc=kc, m_top=m_top)
    assert int2.LAUNCHES_TILETOP == before  # CPU tensors: the plain version ran
    assert gr.dtype == torch.int32 and gv.shape == wv.shape
    np.testing.assert_array_equal(gv.numpy(), wv)
    np.testing.assert_array_equal(gr.numpy(), wr)
    tile = jax_topk._pick_tile_int2(ns, nq, d // 4)
    assert int2._pick_tile_int2(ns, nq, d // 4) == tile
    m = wv.shape[1] // (ns // tile)
    fill = ~np.isfinite(wv)
    if case in ("dead_bins", "tombstones"):  # an empty bin fills with (-inf, its first row)
        assert fill.any()
        pos = np.nonzero(fill)[1]
        np.testing.assert_array_equal(wr[fill], (pos // m) * tile + pos % 128)
    if case == "ties":  # equal scores in a bin: the lower row first
        v = wv.reshape(nq, -1, m // 128, 128)
        r = wr.reshape(nq, -1, m // 128, 128)
        same = (v[:, :, 1:] == v[:, :, :-1]) & np.isfinite(v[:, :, 1:])
        assert same.any() and (r[:, :, 1:][same] > r[:, :, :-1][same]).all()


def test_tiletop_geometry_matches_jax():
    """The tile picker, the depth rule and the viability test are the JAX
    package's, with its error text."""
    for n in (512, 4096, 24576, 98304, 131072, 147456, 3_809_280, 4_194_304, 25_165_824):
        for nq in (1, 2, 8, 64, 512):
            for d4 in (8, 32, 96):
                assert int2._pick_tile_int2(n, nq, d4) == jax_topk._pick_tile_int2(n, nq, d4)
                for kc in (16, 128, 512, 1024, 4096):
                    assert int2.tiletop_viable(n, nq, d4, kc) == jax_topk.tiletop_viable(n, nq, d4, kc)
    assert int2._pick_tile_int2(3_809_280, 1, 96) == 12288 and int2._pick_tile_int2(3_809_280, 512, 96) == 4096
    for args in ((4096, 4096, 128), (98304, 12288, 128), (3_809_280, 12288, 4096), (24576, 12288, 300)):
        assert int2._tiletop_depth(*args) == jax_topk._tiletop_depth(*args)
    with pytest.raises(ValueError) as port:
        int2._tiletop_depth(4096, 4096, 512)
    with pytest.raises(ValueError) as ref:
        jax_topk._tiletop_depth(4096, 4096, 512)
    assert str(port.value) == str(ref.value)
    with pytest.raises(ValueError, match="not a multiple of 512"):
        int2._pick_tile_int2(1000, 1, 8)
    assert (int2._INT2_TILETOP_M, int2._INT2_TILETOP_MAX) == (jax_topk._INT2_TILETOP_M, jax_topk._INT2_TILETOP_MAX)
    assert (int2._INT2_WINDOW, int2._INT2_CAP_SLACK) == (jax_topk._INT2_WINDOW, jax_topk._INT2_CAP_SLACK)
    assert (int2._TILES_INT2, int2._VMEM_BUDGET) == (jax_topk._TILES_INT2, jax_topk._VMEM_BUDGET)


# -- the pipelines -----------------------------------------------------------------


def _pipeline_inputs(n, d, nq, fine_bits, case, seed):
    rng = np.random.default_rng(seed)
    rows = _unit(rng.standard_normal((n, d)))
    if case == "pileup":  # half the corpus one row: a tie pile-up past kc + slack
        rows[: n // 2] = rows[0]
    p2, s2 = _quantize2(rows, d)
    f, fs = _quantize(rows) if fine_bits == 8 else _quantize4(rows)
    src = rng.integers(0, 4, n).astype(np.int32)
    src[rng.random(n) < 0.1] = -1
    src[(np.arange(n) % 128) == 3] = -1  # a lane of every tile bin-wide tombstoned
    q = _unit(rng.standard_normal((nq, d)))
    if case == "pileup":
        q[0] = rows[0]
    return np.ascontiguousarray(p2.T), s2, np.ascontiguousarray(f.T), fs, src, q


PIPELINE_CASES = [
    # (select, fine_bits, nq, k, kc, filter, n_sweep, case)
    ("tiletop", 8, 2, 64, 256, None, 0, "random"),
    ("tiletop", 4, 1, 32, 512, [1, 2], 24576, "random"),
    ("tiletop", 8, 2, 16, 64, None, 0, "pileup"),
    ("window", 8, 3, 64, 256, None, 0, "random"),
    ("window", 4, 2, 16, 100, [0, 3], 24576, "random"),
    ("window", 8, 2, 10, 64, None, 0, "pileup"),
    ("threshold", 8, 3, 64, 256, None, 0, "random"),
    ("threshold", 4, 2, 32, 100, [0, 3], 24576, "random"),
    ("threshold", 8, 2, 16, 64, None, 0, "pileup"),  # its sort path
]


@pytest.mark.parametrize("select,fine_bits,nq,k,kc,filt,n_sweep,case", PIPELINE_CASES)
def test_select_pipeline_matches_jax(select, fine_bits, nq, k, kc, filt, n_sweep, case):
    """scan_int2_coarse_fine(select=...) against JAX's over both companions:
    fine scores, rows and floor bit for bit."""
    n, d = 36864, 64
    p2, s2, f, fs, src, q = _pipeline_inputs(n, d, nq, fine_bits, case, kc + k)
    allowed = _allowed(filt)
    got = int2.scan_int2_coarse_fine(*_t(p2, s2, f, fs, src, q, allowed), k, k_coarse=kc, n_sweep=n_sweep,
                                     select=select)
    kw = dict(k_coarse=kc, n_sweep=n_sweep, fine_bits=fine_bits, select=select)
    if select == "tiletop":
        want = jax_topk.scan_int2_coarse_fine(*_j(p2, s2, f, fs, src, q, allowed), k, engine="pallas",
                                              interpret=True, **kw)
    else:
        want = jax.jit(lambda *a: jax_topk.scan_int2_coarse_fine(*a, k, engine="xla", **kw))(
            *_j(p2, s2, f, fs, src, q, allowed))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].dtype == torch.int32 and np.isfinite(got[2].numpy()).all()
    plain = int2.scan_int2_coarse_fine_plain(*_t(p2, s2, f, fs, src, q, allowed), k, k_coarse=kc,
                                             n_sweep=n_sweep, select=select)
    for g, p in zip(got, plain):
        assert torch.equal(g, p)
    if case == "pileup" and select == "threshold":  # the sort path ran: more than kcap rows tie
        qi8, qs = topk.quantize_queries(torch.from_numpy(q))
        coarse = int2.int2_scores(*_t(p2, s2, src), qi8, qs, torch.from_numpy(allowed))
        assert int((coarse[0] >= got[2][0]).sum()) > kc + int2._INT2_CAP_SLACK


def test_window_and_threshold_contain_the_exact_candidates():
    """Their candidates contain the exact select's, so their fine top-k is
    at least as good place for place, and their floors lie at or below the
    exact floor."""
    n, d, k, kc = 36864, 64, 32, 200
    p2, s2, f, fs, src, q = _pipeline_inputs(n, d, 3, 8, "random", 9)
    args = _t(p2, s2, f, fs, src, q, _allowed())
    ev, _, ef = int2.scan_int2_coarse_fine(*args, k, k_coarse=kc)
    for select in ("window", "threshold"):
        v, _, fl = int2.scan_int2_coarse_fine(*args, k, k_coarse=kc, select=select)
        assert bool((v >= ev).all()) and bool((fl <= ef).all())


def test_select_guards_match_jax():
    """"tiletop" at a full fetch is "exact"; "auto" and "approx" run the
    exact select (the JAX package's on the CPU); a tiletop geometry past the
    epilogue budget, a window select with fewer windows than kc and an
    unknown name raise as in JAX."""
    n, d, k = 4096, 64, 16
    p2, s2, f, fs, src, q = _pipeline_inputs(n, d, 2, 8, "random", 3)
    args = _t(p2, s2, f, fs, src, q, _allowed())
    jargs = _j(p2, s2, f, fs, src, q, _allowed())
    exact = int2.scan_int2_coarse_fine(*args, k, k_coarse=256)
    for select in ("auto", "approx"):
        for g, e in zip(int2.scan_int2_coarse_fine(*args, k, k_coarse=256, select=select), exact):
            assert torch.equal(g, e)
        want = jax_topk.scan_int2_coarse_fine(*jargs, k, k_coarse=256, engine="xla", fine_bits=8, select=select)
        for g, w in zip(exact, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    full = int2.scan_int2_coarse_fine(*args, k, k_coarse=n, select="tiletop")
    for g, e in zip(full, int2.scan_int2_coarse_fine(*args, k, k_coarse=n)):
        assert torch.equal(g, e)
    assert np.isneginf(full[2].numpy()).all()
    assert not int2.tiletop_viable(n, 2, d // 4, 512)
    with pytest.raises(ValueError, match="tiletop select needs"):
        int2.scan_int2_coarse_fine(*args, k, k_coarse=512, select="tiletop")
    with pytest.raises(ValueError, match="tiletop select needs"):
        jax_topk.scan_int2_coarse_fine(*jargs, k, k_coarse=512, engine="pallas", interpret=True, fine_bits=8,
                                       select="tiletop")
    for select in ("window", "threshold"):
        with pytest.raises(ValueError, match="requires n % 128 == 0"):
            int2.scan_int2_coarse_fine(*args, k, k_coarse=64, select=select)
    with pytest.raises(ValueError, match="unknown select"):
        int2.scan_int2_coarse_fine(*args, k, k_coarse=64, select="partial")


# -- the searcher ---------------------------------------------------------------------


def _pin(searcher, select: str, fetch: int) -> None:
    m = searcher.matrix
    with m._lock:
        m.coarse_select, m.coarse_fetch = select, fetch
        m.mutation_gen += 1


@pytest.fixture(scope="module")
def pinned_pair():
    """The port and JaxSearcher(int2, engine="pallas") on 131,072 rows at
    d = 32 with the int8 companion, the audit off and the coarse depth at
    512 on both sides."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PERCEIVE_TPU_INT2_FINE", "int8")
    mp.setenv("PERCEIVE_TPU_COARSE_AUDIT", "0")
    rng = np.random.default_rng(21)
    n, d = 131072, 32
    vecs = _unit(rng.standard_normal((n, d)))
    p = Searcher(0, 0, d, device="cpu", dtype=INT2)
    j = JaxSearcher(0, 0, d, dtype=JAX_INT2, engine="pallas")
    keys, srcs = list(range(1, n + 1)), [i % 3 for i in range(n)]
    for s in (p, j):
        s.upsert_embeddings(keys, srcs, vecs)
    yield p, j, _unit(vecs[rng.integers(0, n, 4)] + 0.3 * rng.standard_normal((4, d)))
    mp.undo()


@pytest.mark.parametrize("select", ["tiletop", "window", "threshold"])
def test_pinned_searcher_matches_jax(pinned_pair, select, monkeypatch):
    p, j, qs = pinned_pair
    for s in (p, j):
        _pin(s, select, 512)
    assert int2.tiletop_viable(p.matrix.sweep_rows, 1, 8, 512)
    calls = []
    real = int2.scan_int2_coarse_fine
    monkeypatch.setattr(int2, "scan_int2_coarse_fine", lambda *a, **kw: calls.append(kw["select"]) or real(*a, **kw))
    for qi, q in enumerate(qs[:3]):
        filt = [1] if qi == 2 else None
        got, want = p.search_vector(q, 10, filt), j.search_vector(q, 10, filt)
        assert [i for i, _ in got] == [i for i, _ in want]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=1e-6, atol=1e-7)
    assert calls and set(calls) == {select}
    assert (p.escalations, p.scan_calls) == (j.escalations, j.scan_calls)


def test_audit_resets_a_pinned_select_like_jax(monkeypatch):
    """The self-audit's phase 2b overwrites a pinned select ("exact" in the
    port, "approx" or "exact" in JAX) and bumps mutation_gen; its phase 3
    then measures that select, so a tiletop pin does not survive it."""
    monkeypatch.setenv("PERCEIVE_TPU_INT2_FINE", "int8")
    monkeypatch.delenv("PERCEIVE_TPU_COARSE_AUDIT", raising=False)
    rng = np.random.default_rng(4)
    n, d = 8192, 64
    vecs = _unit(rng.standard_normal((n, d)))
    p = Searcher(0, 0, d, device="cpu", dtype=INT2)
    j = JaxSearcher(0, 0, d, dtype=JAX_INT2, engine="xla")
    for s in (p, j):
        s.upsert_embeddings(list(range(1, n + 1)), [i % 3 for i in range(n)], vecs)
    fetch = p.matrix.coarse_fetch
    assert fetch == j.matrix.coarse_fetch and p.matrix.coarse_select == "exact"
    for s in (p, j):
        _pin(s, "tiletop", fetch)
    gens = (p.matrix.mutation_gen, j.matrix.mutation_gen)
    assert p.audit_coarse() == j.audit_coarse()
    assert p.matrix.coarse_select == "exact" and j.matrix.coarse_select in ("approx", "exact")
    assert p.matrix.mutation_gen == gens[0] + 1 and j.matrix.mutation_gen == gens[1] + 1
    assert p.coarse_audit["select"] == "exact" and p.matrix.coarse_fetch == j.matrix.coarse_fetch
    q = _unit(rng.standard_normal((1, d)))[0]
    got, want = p.search_vector(q, 10), j.search_vector(q, 10)
    assert [i for i, _ in got] == [i for i, _ in want]
