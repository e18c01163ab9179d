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
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)

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


PLAN_KS = [1, 32, 256, 1024, 8192]
PLAN_ROWS = [20_480, 958_464, 25_165_824, 34_603_008, 100_000_000]


def _check_list_plan(nq, n_sweep, k, sms, plan, q_align):
    """What every list-keeping launch plan must give: whole 128-row tiles
    covering the sweep in non-empty ranges, lists of 64 keys up to k = 32
    and of more than k past it, a workspace that is one list per (query,
    range), launch dimensions within 65,535 (query tiles x ranges, and pass
    2's one block a query), and query chunks whose workspaces fit the
    budget.  Returns the chunks."""
    ws, (qt, ranges, rows_per_range, cap) = plan(nq)
    assert cap == 64 if k <= 32 else cap >= 2 * k and cap % 32 == 0
    assert rows_per_range % 128 == 0 and rows_per_range >= 128
    assert ranges * rows_per_range >= n_sweep > (ranges - 1) * rows_per_range
    assert ws == nq * ranges * cap * 8
    assert max(-(-nq // qt), ranges, nq) <= 65_535
    if k > 32 and n_sweep >= 4 * k:
        assert rows_per_range >= 4 * k
    chunks = topk.query_chunks(nq, lambda n: plan(n)[0], q_align, topk._WORKSPACE_BYTES)
    assert chunks[0][0] == 0 and chunks[-1][1] == nq
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    for s, e in chunks:
        assert plan(e - s)[0] <= topk._WORKSPACE_BYTES
    return chunks


@pytest.mark.parametrize("nq", [1, 16, 255])
@pytest.mark.parametrize("k", PLAN_KS)
@pytest.mark.parametrize("n_sweep", PLAN_ROWS)
@pytest.mark.parametrize("f32", [False, True])
def test_flat_bf16_plan_sizes_the_workspace(nq, k, n_sweep, f32):
    """K1's launch plan (``flat_rows_plan``): up to
    FLAT_ROWS_CORE_QUERIES["bf16"] queries (and at f32) a power-of-two tile
    of at most 16 on the CUDA cores, about two blocks an SM; wider bf16
    sweeps K2's tensor-core tiles of 64 or 128, about one block an SM; the
    checks every list plan shares, on its lists (the multi-block select's
    scratch aside)."""
    sms = 132
    operand = "f32" if f32 else "bf16"
    plan = lambda n: _lists_of(n, k, topk.flat_rows_plan(n, 384, n_sweep, k, sms, operand))  # noqa: E731
    _, (qt, ranges, _, _) = plan(nq)
    if f32 or nq <= topk.FLAT_ROWS_CORE_QUERIES["bf16"]:
        assert qt == min(16, 1 << (nq - 1).bit_length()) and -(-nq // qt) * ranges <= max(2 * sms, -(-nq // qt))
    else:
        assert qt == (64 if nq <= 64 else 128) and -(-nq // qt) * ranges <= sms
    _check_list_plan(nq, n_sweep, k, sms, plan, 1)


def _lists_of(nq, k, flat_plan):
    """A flat plan's lists alone: (list bytes, (qt, ranges, rows a range,
    cap)), the multi-block select's scratch and flag set aside."""
    ws, (qt, ranges, per, cap, multi) = flat_plan
    return ws - (topk.keys_select_bytes(nq, k) if multi else 0), (qt, ranges, per, cap)


@pytest.mark.parametrize("nq", [256, 512, 2048])
@pytest.mark.parametrize("k", PLAN_KS)
@pytest.mark.parametrize("n_sweep", PLAN_ROWS)
def test_slab_int4_plan_sizes_the_workspace(nq, k, n_sweep):
    """K9's slab plan: tiles of 128 queries, about one block an SM, no
    launch dimension that grows with the rows (the first slab kernel's grid
    stopped at 33,553,920 rows), and a sweep of 2,048 queries in one launch
    within the 1 GiB budget up to k = 1,024."""
    sms = 132
    plan = lambda n: topk.slab_s8_plan(n, 384, n_sweep, k, sms)  # noqa: E731
    _, (qt, ranges, _, _) = plan(nq)
    assert qt == 128 and -(-nq // qt) * ranges <= sms
    chunks = _check_list_plan(nq, n_sweep, k, sms, plan, topk.SLAB_QUERIES)
    if k <= 1024:
        assert chunks == [(0, nq)]


@pytest.mark.parametrize("kernel,d", [("K4", 384), ("K8", 384), ("K4", 1024), ("K8", 128)])
@pytest.mark.parametrize("nq", [256, 2048])
@pytest.mark.parametrize("k", [16, 128, 256, 8192])
@pytest.mark.parametrize("n_sweep", PLAN_ROWS)
def test_slab_int8_plans_size_the_workspace(kernel, d, nq, k, n_sweep):
    """K4's and K8's list plans (``slab_s8_plan``, which their wrappers
    pass to the kernels at every width the kernels take): the workspace
    within _WORKSPACE_BYTES, a sweep of 2,048 queries at k <= 256 in one
    launch at any row count, at most 65,535 ranges of whole 128-row tiles,
    and no launch dimension that grows with the rows (their first kernels'
    grid stopped at 33,553,920 rows)."""
    sms = 132
    plan = lambda n: topk.slab_s8_plan(n, d, n_sweep, k, sms)  # noqa: E731
    ws, (qt, ranges, rows_per_range, _) = plan(nq)
    assert qt == 128 and ranges <= 65_535 and rows_per_range % 128 == 0
    assert -(-nq // qt) * ranges <= max(sms, -(-nq // qt))
    chunks = _check_list_plan(nq, n_sweep, k, sms, plan, topk.SLAB_QUERIES)
    if k <= 256:
        assert chunks == [(0, nq)] and ws <= topk._WORKSPACE_BYTES


@pytest.mark.parametrize("d,nq,want", [(384, 8, 8), (384, 9, 64), (384, 64, 64), (384, 65, 128),
                                       (768, 200, 64), (200, 40, 16)])
def test_flat_bf16_plan_tiles_by_width(d, nq, want):
    """K1 takes the CUDA cores up to FLAT_ROWS_CORE_QUERIES["bf16"] queries
    and where d is no multiple of 64 (K2's boxes are 64 dims), K2's tiles of
    64 queries past that, and 128 past 64 queries where d <= 384."""
    _, (qt, *_) = topk.flat_rows_plan(nq, d, 958_464, 32, 132, "bf16")
    assert qt == want


FLAT_ROWS_ROWS = [2_064_384, 25_165_824, 100_000_000]


@pytest.mark.parametrize("operand", ["int8", "bf16"])
@pytest.mark.parametrize("nq", [1, 16, 17, 64, 255])
@pytest.mark.parametrize("k", [16, 128, 512, 2048, 8192])
def test_flat_rows_plan_workspace_does_not_grow_with_rows(operand, nq, k):
    """K3's (and K1's) launch plan (``flat_rows_plan``): one list per
    (query, range) and, where pass 2 is the multi-block select, its
    scratch; about two blocks an SM on the CUDA cores, one on the tensor
    cores; no launch dimension and no workspace that grows with the rows
    (K3's first kernel kept min(k, 512) keys per 512-row block and query:
    every row past k = 512), and every sweep within _WORKSPACE_BYTES."""
    sms = 132
    plans = [topk.flat_rows_plan(nq, 384, n, k, sms, operand) for n in FLAT_ROWS_ROWS]
    for n, (ws, (qt, ranges, per, cap, multi)) in zip(FLAT_ROWS_ROWS, plans):
        assert ws == nq * ranges * cap * 8 + (topk.keys_select_bytes(nq, k) if multi else 0)
        assert cap == 64 if k <= 32 else cap >= 2 * k and cap % 32 == 0
        assert per % 128 == 0 and ranges * per >= n > (ranges - 1) * per
        assert -(-nq // qt) * ranges <= (2 * sms if qt <= 16 else sms)
        assert ws <= topk._WORKSPACE_BYTES
        if k > 32 and operand == "int8":
            assert per >= 2 * k
    assert plans[0][0] <= plans[1][0] == plans[2][0]


@pytest.mark.parametrize("operand", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("n_sweep", [2_064_384, 25_165_824])
@pytest.mark.parametrize("nq", [32, 255])
def test_flat_rows_plan_deep_wide_sweep_is_one_launch(operand, n_sweep, nq):
    """A sweep of 255 queries at k = 8,192 (the escalation ladder's top
    rung for an executor drain) is one chunk: the plan cuts its ranges to
    fit the lists and the multi-block select's scratch in _WORKSPACE_BYTES
    (K1's former plan split it into launches that each re-read the
    matrix)."""
    plan = lambda n: topk.flat_rows_plan(n, 384, n_sweep, 8192, 132, operand)  # noqa: E731
    assert topk.query_chunks(nq, lambda n: plan(n)[0], 1, topk._WORKSPACE_BYTES) == [(0, nq)]
    ws, (_, ranges, _, cap, multi) = plan(nq)
    assert ws <= topk._WORKSPACE_BYTES and multi == 1 and ranges >= 1 and cap == 16384


@pytest.mark.parametrize("d", [384, 256, 128, 192, 160, 96])
@pytest.mark.parametrize("step", [-1, 0, 1])
def test_flat_rows_plan_routes_int8_at_the_crossover(d, step):
    """K3: up to FLAT_ROWS_CORE_QUERIES["int8"] queries a power-of-two tile
    of at most 16 on the CUDA cores; past it K4's wgmma tile of 64 queries
    (128 past 64), but only where d is a multiple of 128 (K4's s8 boxes);
    elsewhere the CUDA cores at every width."""
    cross = topk.FLAT_ROWS_CORE_QUERIES["int8"]
    for nq in (cross + step, 64 + step, 255):
        if nq < 1:
            continue
        _, (qt, *_) = topk.flat_rows_plan(nq, d, 2_064_384, 128, 132, "int8")
        if nq <= cross or d % 128:
            assert qt == min(16, 1 << (nq - 1).bit_length())
        else:
            assert qt == (64 if nq <= 64 else 128)


@pytest.mark.parametrize("operand", ["int8", "bf16"])
@pytest.mark.parametrize("nq", [1, 16, 255])
@pytest.mark.parametrize("k", [1, 16, 32, 33, 64, 128, 512, 2048, 8192])
@pytest.mark.parametrize("n_sweep", [128, 20_037, 958_464, 2_064_384])
def test_flat_rows_plan_takes_the_multi_block_select_past_staging(operand, nq, k, n_sweep):
    """K3's and K1's pass 2 is the multi-block select exactly where a
    query's ranges x cap keys pass what list_pass2 stages in shared memory
    beside its sort buffer (232,448 bytes less its select scratch and 1,024
    spare), as K7's and K9 flat's."""
    _, (_, ranges, _, cap, multi) = topk.flat_rows_plan(nq, 384, n_sweep, k, 132, operand)
    sort_n = 1 << max(0, k - 1).bit_length()
    staged = (((sort_n + 1) & ~1) + ranges * cap) * 8 + 1040 + 1024 <= 232_448
    assert multi == (not staged) and topk.list_pass2_staged(ranges * cap, k) == staged


FLAT_COLS_ROWS = [3_809_280, 25_165_824, 100_000_000]


@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("nq", [1, 8, 32, 255])
@pytest.mark.parametrize("k", [16, 128, 256, 1024, 8192])
def test_flat_cols_plan_workspace_does_not_grow_with_rows(int4, nq, k):
    """K7's and K9 flat's launch plan (``flat_cols_plan``): one list per
    (query, range) and, where pass 2 is the multi-block select, its scratch;
    about two blocks an SM on the CUDA cores, one on the tensor cores; no
    launch dimension and no workspace that grows with the rows (the first
    kernel kept min(k, 512) keys per 512-row block: 4 GiB at 25M rows)."""
    sms = 132
    plans = [topk.flat_cols_plan(nq, 384, n, k, sms, int4) for n in FLAT_COLS_ROWS]
    for n, (ws, (qt, ranges, per, cap, multi)) in zip(FLAT_COLS_ROWS, plans):
        assert ws == nq * ranges * cap * 8 + (topk.keys_select_bytes(nq, k) if multi else 0)
        assert cap == 64 if k <= 32 else cap >= 2 * k and cap % 32 == 0
        assert per % 128 == 0 and ranges * per >= n > (ranges - 1) * per
        assert -(-nq // qt) * ranges <= (2 * sms if qt <= 16 else sms)
        assert ws <= nq * 2 * sms * cap * 8 + topk.keys_select_bytes(nq, k)
    assert plans[0][0] <= plans[1][0] == plans[2][0]


@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("n_sweep", [4_194_304, 25_165_824])
def test_flat_cols_plan_deep_32_query_sweep_is_one_launch(int4, n_sweep):
    """A 32-query sweep at k = 8,192 (the escalation ladder's top rung) is
    one chunk within _WORKSPACE_BYTES at the int4 tier's size and at the
    main path's: the first kernel split it in two, each re-reading the
    matrix."""
    plan = lambda n: topk.flat_cols_plan(n, 384, n_sweep, 8192, 132, int4)  # noqa: E731
    assert topk.query_chunks(32, lambda n: plan(n)[0], 1, topk._WORKSPACE_BYTES) == [(0, 32)]
    assert plan(32)[0] <= topk._WORKSPACE_BYTES


@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("d", [384, 256, 160])
@pytest.mark.parametrize("step", [-1, 0, 1])
def test_flat_cols_plan_routes_at_the_crossover(int4, d, step):
    """Up to FLAT_COLS_CORE_QUERIES[decode] queries a power-of-two tile of
    at most 16 on the CUDA cores; past it K8's and K9 slab's wgmma tile of
    64 queries (128 past 64), but only where d is a multiple of 128 (their
    K-slices); elsewhere the CUDA cores at every width."""
    cross = topk.FLAT_COLS_CORE_QUERIES["int4" if int4 else "int8"]
    for nq in (cross + step, 64 + step, 255):
        if nq < 1:
            continue
        _, (qt, *_) = topk.flat_cols_plan(nq, d, 3_809_280, 128, 132, int4)
        if nq <= cross or d % 128:
            assert qt == min(16, 1 << (nq - 1).bit_length())
        else:
            assert qt == (64 if nq <= 64 else 128)


@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("nq", [1, 16, 255])
@pytest.mark.parametrize("k", [1, 16, 32, 33, 64, 128, 512, 1024, 8192])
@pytest.mark.parametrize("n_sweep", [128, 20_037, 958_464, 3_809_280])
def test_flat_cols_plan_takes_the_multi_block_select_past_staging(int4, nq, k, n_sweep):
    """Pass 2 is the multi-block select exactly where a query's ranges x cap
    keys pass what list_pass2 stages in shared memory beside its sort
    buffer (232,448 bytes less its select scratch and 1,024 spare)."""
    _, (_, ranges, _, cap, multi) = topk.flat_cols_plan(nq, 384, n_sweep, k, 132, int4)
    sort_n = 1 << max(0, k - 1).bit_length()
    staged = (((sort_n + 1) & ~1) + ranges * cap) * 8 + 1040 + 1024 <= 232_448
    assert multi == (not staged) and topk.list_pass2_staged(ranges * cap, k) == staged


def test_list_pass2_staging_boundary():
    """The staging rule at its edge: at k = 128 (a sort buffer of 128 keys)
    28,670 keys stage and 28,672 do not."""
    assert topk.list_pass2_staged(28_670, 128)
    assert not topk.list_pass2_staged(28_672, 128)
    assert topk.keys_select_bytes(3, 100) == 3 * (32 + 2048 * 4 + 128 * 8)


_KS_SHIFTS = (53, 42, 31, 20, 9, 0)
_KS_BITS = (11, 11, 11, 11, 11, 9)


def _keys_select_model(keys: np.ndarray, k: int, block: int = 4096) -> np.ndarray:
    """A plain model of csrc/hopper_common.cuh's multi-block select over
    one query's uint64 keys (0 = no row): radix levels of 11 bits (9 at the
    last), each a histogram over blocks of keys that match the prefix, the
    bin of the kk-th largest found highest first, done once a bin holds
    exactly kk keys; at level 0, at most k non-zero keys are all taken
    (T = 1).  Returns the keys >= T, best first."""
    prefix, mask, kk, done = np.uint64(0), np.uint64(0), k, False
    for level, (shift, bits) in enumerate(zip(_KS_SHIFTS, _KS_BITS)):
        if done:
            break
        hist = np.zeros(2048, dtype=np.int64)
        for lo in range(0, keys.size, block):  # the blocks' shared histograms, flushed
            part = keys[lo : lo + block]
            live = part[(part != 0) & ((part & mask) == prefix)]
            hist += np.bincount(((live >> np.uint64(shift)) & np.uint64((1 << bits) - 1)).astype(np.int64),
                                minlength=2048)
        if level == 0 and hist.sum() <= kk:
            prefix, done = np.uint64(1), True
            break
        above = 0
        for digit in range(2047, -1, -1):
            if above + hist[digit] >= kk:
                prefix |= np.uint64(digit) << np.uint64(shift)
                mask |= np.uint64((1 << bits) - 1) << np.uint64(shift)
                kk -= above
                done = hist[digit] == kk
                break
            above += hist[digit]
    taken = keys[(keys != 0) & (keys >= prefix)]
    assert taken.size == min(k, int((keys != 0).sum()))
    return np.sort(taken)[::-1]


@pytest.mark.parametrize("case", ["random", "dense_ties", "all_equal", "few_live", "none_live", "negative"])
@pytest.mark.parametrize("k", [1, 7, 128, 1000, 8192])
def test_keys_select_model_matches_topk(case, k):
    """The multi-block select's plan, modelled on the CPU, against torch.topk
    over the (score, ~row) keys: the same (score, row) pairs best first,
    equal scores lower row first, on lists laid out as pass 1 leaves them
    (ranges x cap slots, zero-filled)."""
    rng = np.random.default_rng(k + len(case))
    ranges, cap = 37, 512
    n = ranges * cap
    scores = rng.standard_normal(n).astype(np.float32)
    if case == "dense_ties":
        scores = rng.integers(-3, 4, n).astype(np.float32) * np.float32(0.25)
    elif case == "all_equal":
        scores[:] = np.float32(0.5)
    elif case == "negative":
        scores = -np.abs(scores)
        scores[::5] = np.float32(-0.0)
    rows = rng.permutation(40 * n)[:n].astype(np.int64)  # rows spread past the slots, in no order
    live = rng.random(n) < {"few_live": 0.01, "none_live": 0.0}.get(case, 0.9)
    bits = scores.view(np.uint32).astype(np.uint64)
    bits = np.where(scores == 0, np.uint64(0x80000000), bits)  # -0 -> +0, as float_order(s + 0.0f)
    order = np.where(bits & np.uint64(0x80000000), ~bits & np.uint64(0xFFFFFFFF), bits | np.uint64(0x80000000))
    keys = np.where(live, (order << np.uint64(32)) | (np.uint64(0xFFFFFFFF) - rows.astype(np.uint64)), np.uint64(0))
    got = _keys_select_model(keys, k)
    got_rows = (np.uint64(0xFFFFFFFF) - (got & np.uint64(0xFFFFFFFF))).astype(np.int64)
    # torch.topk over the port's int64 keys of the live (score, row) pairs
    s_live, r_live = torch.from_numpy(scores[live]), torch.from_numpy(rows[live])
    ref = topk._order_keys(s_live[None, :], 0, r_live[None, :])[0]
    kk = min(k, ref.numel())
    pos = torch.topk(ref, kk, sorted=True).indices
    np.testing.assert_array_equal(got_rows, r_live[pos].numpy())
    np.testing.assert_array_equal(scores[live][pos.numpy()], s_live[pos].numpy())
