"""The port's scan + top-k (plain version of the CUDA kernel) against the
JAX package: the Pallas kernel in interpret mode and the XLA engine.

Same seeded numpy inputs to both.  Tolerances: scores to 1e-5 (f32
matrix) or 1e-3 (bf16 matrix, where the f32 sums run in another order);
rows equal except where two scores lie within that tolerance of each other
(near ties may swap).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceive_tpu.index.searcher import _scan_topk_xla_impl
from perceive_tpu.ops.topk import ALLOW_ALL, scan_topk_pallas
from perceive_tpu_torch.ops import topk

N = 2048
TOL = {"float32": 1e-5, "bfloat16": 1e-3}


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _inputs(d, nq, seed, *, invalid_frac=0.1, n_sources=4):
    """Unit-norm rows and queries, as the searcher stores embeddings."""
    rng = np.random.default_rng(seed)
    matrix = _unit(rng.standard_normal((N, d)))
    src = rng.integers(0, n_sources, N).astype(np.int32)
    src[rng.random(N) < invalid_frac] = -1
    q = _unit(rng.standard_normal((nq, d)))
    return matrix, src, q


def _allowed(ids=None):
    a = np.full(16, -9, dtype=np.int32)
    if ids is None:
        a[0] = ALLOW_ALL
    else:
        a[: len(ids)] = ids
    return a


def _port(matrix, src, q, allowed, k, n_sweep, dtype):
    m = torch.from_numpy(matrix).to(getattr(torch, dtype))
    v, r = topk.scan_topk(m, torch.from_numpy(src), torch.from_numpy(q), torch.from_numpy(allowed), k, n_sweep)
    assert v.dtype == torch.float32 and r.dtype == torch.int32
    return v.numpy(), r.numpy()


def _assert_same(got, want, tol):
    gv, gr = got
    wv, wr = (np.asarray(x) for x in want)
    assert gv.shape == wv.shape
    np.testing.assert_array_equal(np.isfinite(gv), np.isfinite(wv))
    fin = np.isfinite(wv)
    np.testing.assert_allclose(gv[fin], wv[fin], atol=tol, rtol=0)
    np.testing.assert_array_equal(gr[~fin], -1)
    # rows agree except inside near ties
    for qi in range(gv.shape[0]):
        for j in np.nonzero(gr[qi] != wr[qi])[0]:
            if not fin[qi, j]:
                continue
            assert abs(wv[qi, j] - wv[qi, j - 1 if j else j + 1]) <= 2 * tol or (
                j + 1 < wv.shape[1] and abs(wv[qi, j] - wv[qi, j + 1]) <= 2 * tol
            ), (qi, j)


CASES = [
    # (d, nq, k, dtype, filter, n_sweep, invalid_frac)
    (128, 1, 16, "float32", None, 0, 0.1),
    (128, 3, 64, "bfloat16", [1, 3], 0, 0.1),
    (384, 8, 16, "bfloat16", None, 1536, 0.1),
    (384, 3, 64, "float32", [2], 1024, 0.5),
    (128, 8, 64, "bfloat16", [0], 512, 0.9),  # fewer matches than k
]


@pytest.mark.parametrize("d,nq,k,dtype,filt,n_sweep,invalid", CASES)
def test_matches_pallas_kernel(d, nq, k, dtype, filt, n_sweep, invalid):
    matrix, src, q = _inputs(d, nq, seed=d + nq + k, invalid_frac=invalid)
    allowed = _allowed(filt)
    got = _port(matrix, src, q, allowed, k, n_sweep, dtype)
    want = scan_topk_pallas(
        jnp.asarray(matrix, getattr(jnp, dtype)), jnp.asarray(src), jnp.asarray(q),
        jnp.asarray(allowed), k, n_sweep,
    )
    _assert_same(got, want, TOL[dtype])
    if invalid == 0.9:
        assert np.isinf(got[0]).any(), "case meant to run short of matches"


@pytest.mark.parametrize("d", [128, 384])
@pytest.mark.parametrize("nq", [1, 3, 8])
@pytest.mark.parametrize("k", [16, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_xla_engine(d, nq, k, dtype):
    matrix, src, q = _inputs(d, nq, seed=7 * d + nq + k)
    for filt, n_sweep in ((None, 0), ([0, 2], 1536)):
        allowed = _allowed(filt)
        got = _port(matrix, src, q, allowed, k, n_sweep, dtype)
        want = _scan_topk_xla_impl(
            jnp.asarray(matrix, getattr(jnp, dtype)), jnp.asarray(src), jnp.asarray(q),
            jnp.asarray(allowed), k, n_sweep,
        )
        _assert_same(got, want, TOL[dtype])
        assert (got[1] < (n_sweep or N)).all()


def test_tie_rule_lower_row_first():
    """Equal scores order by the lower row (the CUDA kernel's documented
    order; small integers keep every dot product exact)."""
    rng = np.random.default_rng(0)
    base = rng.integers(-3, 4, (8, 128)).astype(np.float32)
    matrix = np.tile(base, (N // 8, 1))
    src = np.zeros(N, np.int32)
    src[5::7] = -1
    q = rng.integers(-3, 4, (2, 128)).astype(np.float32)
    vals, rows = _port(matrix, src, q, _allowed(), 64, 0, "bfloat16")
    scores = q @ matrix.T
    for qi in range(2):
        for j in range(63):
            if vals[qi, j] == vals[qi, j + 1]:
                assert rows[qi, j] < rows[qi, j + 1]
        np.testing.assert_array_equal(vals[qi], scores[qi, rows[qi]])
        assert (src[rows[qi]] >= 0).all()


def test_k_beyond_rows_pads():
    matrix, src, q = _inputs(128, 2, seed=1)
    vals, rows = _port(matrix, src, q, _allowed(), N + 10, 0, "float32")
    n_valid = int((src >= 0).sum())
    assert np.isfinite(vals[:, :n_valid]).all() and np.isinf(vals[:, n_valid:]).all()
    assert (rows[:, n_valid:] == -1).all()


def test_wrapper_checks():
    m = torch.zeros((512, 128))
    src = torch.zeros(512, dtype=torch.int32)
    al = torch.from_numpy(_allowed())
    with pytest.raises(TypeError):
        topk.scan_topk(m.to(torch.float16), src, torch.zeros(1, 128), al, 4)
    with pytest.raises(ValueError):
        topk.scan_topk(m, src.long(), torch.zeros(1, 128), al, 4)
    with pytest.raises(ValueError):
        topk.scan_topk(m, src, torch.zeros(1, 64), al, 4)


@pytest.mark.parametrize("nq", [256, 384, 512, 1024, 2048])
@pytest.mark.parametrize("k", [1, 10, 32, 33, 512, 8192])
@pytest.mark.parametrize("n_sweep", [958_464, 20_037, 128, 1])
def test_slab_bf16_plan_sizes_the_workspace(nq, k, n_sweep):
    """K2's launch plan: whole 128-row tiles cover the sweep in non-empty
    ranges, about one block per SM, lists of 64 keys up to k = 32 and more
    than k past it, and the workspace is what the kernel writes: a list per
    (query, range)."""
    sms = 132
    ws, (qrows, ranges, rows_per_range, cap) = topk.slab_bf16_plan(nq, 384, n_sweep, k, sms)
    assert qrows == 128
    assert cap == 64 if k <= 32 else cap >= 2 * k and cap % 32 == 0
    assert rows_per_range % 128 == 0 and rows_per_range >= 128
    assert ranges * rows_per_range >= n_sweep > (ranges - 1) * rows_per_range
    assert -(-nq // qrows) * ranges <= max(sms, -(-nq // qrows))
    if k > 32 and n_sweep >= 4 * k:
        assert rows_per_range >= 4 * k
    assert ws == nq * ranges * cap * 8
    # the wrapper's query chunks keep every launch's workspace within budget
    chunks = topk.query_chunks(nq, lambda n: topk.slab_bf16_plan(n, 384, n_sweep, k, sms)[0],
                               topk.SLAB_QUERIES, topk._WORKSPACE_BYTES)
    assert chunks[0][0] == 0 and chunks[-1][1] == nq
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    for s, e in chunks:
        assert topk.slab_bf16_plan(e - s, 384, n_sweep, k, sms)[0] <= topk._WORKSPACE_BYTES
        assert e == nq or (e - s) % topk.SLAB_QUERIES == 0


def test_slab_bf16_plan_wide_rows_take_64_queries():
    """Past d = 384 a block holds 64 queries, so the query tile still fits
    in shared memory beside the ring."""
    _, (qrows, *_) = topk.slab_bf16_plan(512, 1024, 100_000, 32, 132)
    assert qrows == 64


@pytest.mark.parametrize("nq,want", [
    (1, ["flat"]), (255, ["flat"]), (256, ["slab"]), (300, ["slab"]), (384, ["slab"]),
    (2048, ["slab"]), (2049, ["slab", "flat"]), (2048 + 300, ["slab", "slab"]),
])
@pytest.mark.parametrize("k", [1, 32, 8192])
def test_scan_topk_routes_as_before(monkeypatch, nq, k, want):
    """scan_topk routes each sweep of at most MAX_QUERY_SLAB queries to K2
    when it holds at least 2 * QUERY_SLAB queries (padded to a multiple of
    QUERY_SLAB) over a bf16 matrix, else to K1; an f32 matrix always takes
    K1."""
    calls = []

    def record(name):
        def fn(matrix, source_ids, q, allowed, k, n_sweep=0):
            calls.append((name, q.shape[0]))
            return (torch.zeros((q.shape[0], k)), torch.zeros((q.shape[0], k), dtype=torch.int32))
        return fn

    monkeypatch.setattr(topk, "scan_topk_slab", record("slab"))
    monkeypatch.setattr(topk, "scan_topk_flat", record("flat"))
    m = torch.zeros((16, 128), dtype=torch.bfloat16)
    src = torch.zeros(16, dtype=torch.int32)
    al = torch.from_numpy(_allowed())
    vals, rows = topk.scan_topk(m, src, torch.zeros((nq, 128)), al, k)
    assert [c[0] for c in calls] == want and vals.shape == (nq, k)
    assert all(n % topk.QUERY_SLAB == 0 for name, n in calls if name == "slab")
    calls.clear()
    topk.scan_topk(m.float(), src, torch.zeros((nq, 128)), al, k)
    assert {c[0] for c in calls} == {"flat"}
