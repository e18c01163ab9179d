"""Models of the Hopper designs of K6 (``csrc/select_topk.cu``) and K10
(``csrc/scan_int2.cu``), on the CPU, held against the kernels' plain
versions (``select_topk_plain``, ``int2_tiletop_plain``; those are held
against the JAX package in ``test_torch_int2.py`` and
``test_torch_int2_select.py``).

A CUDA kernel cannot run here, so each model replays its kernel's
algorithm step by step with the kernel's constants: K6's first-level
histogram of the top 12 bits of the order key, its candidate region of
min(n, 65,536) entries filled round by round (16,384 entries a round) in an
order the atomics may give (a seeded permutation), the finish's 11- and
9-bit levels, the round table's prefixes and the writes in row order,
and the overflow routes (one value in the kc-th key's bin, or the last
level read again); K10's parts of a tile (the launch's cluster), each
part's running best p of a lane over its sublanes in passes, and the merge
of the parts' lists in rank order.  Tolerances: none; every answer equals
the plain version's bit for bit.  The kernels themselves are held to the
plain versions on the card (``test_torch_cuda.py``, ``chip_smoke.py``).
"""

import math

import numpy as np
import pytest
import torch

from perceive_tpu_torch.ops import int2, topk
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)

# K6's constants (csrc/select_topk.cu)
SEL_THREADS = 1024
ROUND = 16 * SEL_THREADS  # 16 consecutive entries a thread
QUADS = ROUND // 4
SHIFT1, SHIFT2 = 20, 9
BINS1, BINS2, BINS3 = 1 << 12, 1 << 11, 1 << 9
CAP = 65536
ZERO_WORDS = BINS1 + 4
STATE_BYTES, SEG_BYTES = 32, 16


def sel_rounds(n: int) -> int:
    """The round table's length: rows of n scores whose start lies up to
    three floats past a 16-byte boundary."""
    return ((n + 6) // 4 + QUADS - 1) // QUADS


def sel_plan(nq: int, n: int) -> dict:
    """K6's launch plan and workspace, as perceive_select_topk and
    perceive_select_topk_workspace compute them."""
    cap = min(n, CAP)
    rounds = sel_rounds(n)
    counts = rounds * 6 if rounds > 4096 else 0  # the finish's per-round counts, past shared memory
    ws = nq * (ZERO_WORDS * 4 + STATE_BYTES + BINS2 * 4 + rounds * SEG_BYTES + (counts + 3) // 4 * 16 + cap * 8)
    return {"launches": 3, "cap": cap, "rounds": rounds, "workspace": ws}  # a memset, pass 1, pass 2


def order_keys(x: np.ndarray) -> np.ndarray:
    """float_order(x + 0.0): uint32 keys that order like the f32 scores,
    -0.0 equal to +0.0."""
    b = (x.astype(np.float32) + np.float32(0.0)).view(np.uint32)
    return np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint32)


def find_bin(hist: np.ndarray, kk: int) -> tuple[int, int, int]:
    """(bin of the kk-th largest entry, entries above it, its count)."""
    above = 0
    for b in range(len(hist) - 1, -1, -1):
        if above + hist[b] >= kk:
            return b, above, int(hist[b])
        above += int(hist[b])
    raise AssertionError("kk past the entries")


def select_model(row: np.ndarray, kc: int, cap: int = 0, mis: int = 0, seed: int = 0):
    """K6 on one (n,) score row, step by step -> ((kc,) scores and rows by
    row, floor, route): the row starts ``mis`` floats past a 16-byte
    boundary (its rounds shift by that much), the region holds ``cap``
    entries (the kernel's min(n, 65,536) unless given)."""
    n = row.shape[0]
    cap = cap or min(n, CAP)
    keys = order_keys(row)
    dig = keys >> SHIFT1
    rounds = ((n + mis + 3) // 4 + QUADS - 1) // QUADS
    bounds = [(max(0, ROUND * r - mis), min(n, ROUND * (r + 1) - mis)) for r in range(rounds)]

    # pass 1 and its last block
    d1, above, c1 = find_bin(np.bincount(dig, minlength=BINS1), kc)
    kk = kc - above
    over = above + c1 > cap
    stored = not over or above <= cap

    # pass 2: each round's entries at or above d1 (above it, overflowing) in
    # row order, its segment reserved where the atomics put it
    region, table = [], {}
    for r in np.random.default_rng(seed).permutation(rounds):
        idx = np.arange(*bounds[r])
        take = (dig[idx] > d1) | (~np.bool_(over) & (dig[idx] == d1))
        sel = idx[take] if stored else idx[:0]
        table[r] = {"off": len(region), "cnt": len(sel), "bin": int((dig[idx] == d1).sum())}
        region.extend(sel.tolist())
    assert len(region) <= cap
    region = np.array(region, dtype=np.int64)
    in_bin = np.nonzero(dig == d1)[0]

    # the finish: T and the T-equal entries to take
    one_value = over and keys[in_bin].min() == keys[in_bin].max()
    if one_value:
        t, need = int(keys[in_bin][0]), kk
    else:
        cand = in_bin if over else region[dig[region] == d1]  # over: pass 2's histogram, the scores read again
        d2, a2, _ = find_bin(np.bincount((keys[cand] >> SHIFT2) & (BINS2 - 1), minlength=BINS2), kk)
        kk -= a2
        p22 = (d1 << (SHIFT1 - SHIFT2)) | d2
        last = cand[(keys[cand] >> SHIFT2) == p22]
        d3, a3, _ = find_bin(np.bincount(keys[last] & (BINS3 - 1), minlength=BINS3), kk)
        t, need = (p22 << SHIFT2) | d3, kk - a3
    reread_all = over and not (stored and one_value)

    # each round's counts, their prefixes in row order, the writes
    vals, rows = np.zeros(kc, np.float32), np.zeros(kc, np.int64)
    floor, eq_before, sel_before = None, 0, 0
    routes = set()
    for r in range(rounds):
        seg = table[r]
        entries = region[seg["off"] : seg["off"] + seg["cnt"]]
        src = np.arange(*bounds[r]) if reread_all else entries
        gt, eq = int((keys[src] > t).sum()), int((keys[src] == t).sum())
        if over and not reread_all:
            eq = seg["bin"]
        take = min(max(need - eq_before, 0), eq)
        reread = reread_all or (over and take > 0)
        if gt + take:
            routes.add("reread" if reread else "region")
            rank, pos = eq_before, sel_before
            for i in (np.arange(*bounds[r]) if reread else entries):
                is_eq = keys[i] == t
                if keys[i] > t or (is_eq and rank < need):
                    vals[pos], rows[pos] = row[i], i
                    pos += 1
                if is_eq:
                    if rank == need - 1:
                        floor = row[i]
                    rank += 1
            assert pos == sel_before + gt + take
        eq_before += eq
        sel_before += gt + take
    assert sel_before == kc and floor is not None
    route = "normal" if not over else ("one value" if one_value else "read again")
    return vals, rows, np.float32(floor), route, routes


def _plain(row: np.ndarray, kc: int):
    v, r, f = int2.select_topk_plain(torch.from_numpy(row[None].copy()), kc)
    return v[0].numpy(), r[0].numpy(), f[0].numpy()


def _check_select(row, kc, **kw):
    v, r, f, route, _ = select_model(row, kc, **kw)
    pv, pr, pf = _plain(row, kc)
    assert np.array_equal(r, pr) and np.array_equal(v.view(np.uint32), pv.view(np.uint32))
    assert np.array_equal(np.float32(f).view(np.uint32), pf.view(np.uint32))
    return route


def _coarse_like(rng, n: int) -> np.ndarray:
    """Scores as K5 gives them: concentrated near 0, 5% masked rows."""
    x = (rng.standard_normal(n) * 0.05).astype(np.float32)
    x[rng.random(n) < 0.05] = -np.inf
    return x


SELECT_CASES = [
    # (case, n, kc, cap, mis): the region as the kernel sizes it unless cap
    ("random", 50_000, 1, 0, 0),
    ("random", 50_000, 4096, 0, 3),
    ("random", 50_000, 50_000, 0, 1),  # kc = n
    ("dense_ties", 40_000, 4096, 0, 2),  # every score 8 times over
    ("dense_ties", 40_000, 4096, 2_000, 0),  # ... overflowing a small region: read again
    ("few_finite", 40_000, 4096, 3_000, 0),  # 1,000 finite, the rest -inf: one value in the bin
    ("few_finite", 40_000, 4096, 500, 1),  # ... the entries above d1 overflow too
    ("all_masked", 20_000, 4096, 0, 0),
    ("all_masked", 20_000, 4096, 1_000, 2),
    ("signed_zeros", 20_000, 300, 0, 1),  # -0.0 beside +0.0 at the kc-th score
    ("signed_zeros", 20_000, 300, 100, 3),
    ("ties_at_kc", 30_000, 1000, 0, 0),  # 3,000 entries equal the kc-th score
    ("ties_at_kc", 30_000, 1000, 1_500, 0),
    ("ascending", 30_000, 2048, 0, 2),
    ("random", 30_000, 16_384, 16_000, 0),  # kc past the region: the entries above d1 overflow
]


@pytest.mark.parametrize("case,n,kc,cap,mis", SELECT_CASES)
def test_select_model_matches_plain(case, n, kc, cap, mis):
    rng = np.random.default_rng(n + kc + cap + mis)
    row = _coarse_like(rng, n)
    if case == "dense_ties":
        row = np.tile(row[: n // 8], 8)
    elif case == "few_finite":
        row[:] = -np.inf
        row[rng.choice(n, 1000, replace=False)] = rng.standard_normal(1000).astype(np.float32)
    elif case == "all_masked":
        row[:] = -np.inf
    elif case == "signed_zeros":
        row = np.where(rng.random(n) < 0.5, np.float32(-0.0), np.float32(0.0)).astype(np.float32)
        row[rng.choice(n, 200, replace=False)] = 1.0
    elif case == "ties_at_kc":
        row[rng.choice(n, 3000, replace=False)] = np.float32(0.1)
        row[rng.choice(n, 500, replace=False)] = np.float32(0.5)
    elif case == "ascending":
        row = np.linspace(-1, 1, n, dtype=np.float32)
    route = _check_select(row, kc, cap=cap, mis=mis)
    if case in ("few_finite", "all_masked") and cap:
        assert route != "normal"
    if case == "dense_ties" and cap:
        assert route == "read again"


def test_select_model_routes():
    """Which route each adversarial row takes: a region too small for the
    kc-th key's bin of one value (every masked row) re-reads only the rounds
    whose T-equal entries it takes; of several values, every round."""
    rng = np.random.default_rng(9)
    row = np.full(40_000, -np.inf, dtype=np.float32)
    row[rng.choice(40_000, 1000, replace=False)] = 1.0 + rng.random(1000).astype(np.float32)
    *_, route, routes = select_model(row, 4096, cap=3_000)
    assert route == "one value" and routes == {"region", "reread"}
    *_, route, routes = select_model(np.tile(_coarse_like(rng, 5_000), 8), 4096, cap=2_000)
    assert route == "read again" and routes == {"reread"}
    *_, route, routes = select_model(_coarse_like(rng, 40_000), 4096)
    assert route == "normal" and routes == {"region"}


def test_select_plan():
    """K6's plan: three launches (a memset of pass 1's histograms and
    tickets, pass 1, pass 2); a region of min(n, 65,536) entries a query
    that holds the main path's deepest fetch (2 x 8,192) with the kc-th
    key's bin of coarse-like scores; the workspace as the C side sizes
    it."""
    tiletop = sel_plan(1, 310 * 256)  # K10's buffer
    assert tiletop["launches"] == 3 and tiletop["cap"] == 65536 and tiletop["rounds"] == 5
    main = sel_plan(1, 3_809_280)
    assert main["launches"] == 3 and main["rounds"] == 233  # 232.5 rounds
    assert main["workspace"] == ZERO_WORDS * 4 + 32 + BINS2 * 4 + 233 * 16 + 65536 * 8
    assert sel_plan(8, 3_809_280)["workspace"] == 8 * main["workspace"]
    assert sel_plan(1, 4096)["cap"] == 4096 and sel_plan(1, 4096)["rounds"] == 1
    assert sel_plan(1, 16384)["rounds"] == 2  # 16,384 rows 1-3 floats past a 16-byte boundary
    rng = np.random.default_rng(4)
    row = _coarse_like(rng, 1_000_000)
    for kc in (4096, 16_384):
        dig = order_keys(row) >> SHIFT1
        d1, above, c1 = find_bin(np.bincount(dig, minlength=BINS1), kc)
        assert above + c1 <= CAP, (kc, above, c1)


# -- K10 -------------------------------------------------------------------------


def tiletop_parts(tile_n: int, nq: int) -> tuple[int, int]:
    """K10's launch: (parts a tile, sublanes a pass), as launch_int2_tiletop
    sets them (rows a thread R by the query tile, as K5)."""
    r = 16 if nq <= 2 else 8 if nq <= 4 else 4
    pass_subs = 256 * r // 128
    return min(8, -(-(tile_n // 128) // pass_subs)), pass_subs


def _insert(bv, bs, v, s):
    """lane_insert on every lane at once: (..., P) lists, (...) entries."""
    m = v > bv[..., -1]
    bv[..., -1] = torch.where(m, v, bv[..., -1])
    bs[..., -1] = torch.where(m, s, bs[..., -1])
    for j in range(bv.shape[-1] - 1, 0, -1):
        up = bv[..., j] > bv[..., j - 1]
        hi_v, lo_v = torch.where(up, bv[..., j], bv[..., j - 1]), torch.where(up, bv[..., j - 1], bv[..., j])
        hi_s, lo_s = torch.where(up, bs[..., j], bs[..., j - 1]), torch.where(up, bs[..., j - 1], bs[..., j])
        bv[..., j - 1], bv[..., j], bs[..., j - 1], bs[..., j] = hi_v, lo_v, hi_s, lo_s


def tiletop_model(packed, scales, src, qi8, qscale, allowed, n_sweep: int = 0, kc: int = 0, m_top: int = 0):
    """K10 step by step: each part of a tile (a cluster's block) walks its
    sublanes pass by pass into a running best p a lane; the parts' lists
    merge in rank order."""
    n = packed.shape[1] if not n_sweep else n_sweep
    nq = qi8.shape[0]
    tile_n, m_top = int2._tiletop_geometry(n, nq, packed.shape[0], kc, m_top)
    p, sub, t = m_top // 128, tile_n // 128, n // tile_n
    parts, pass_subs = tiletop_parts(tile_n, nq)
    per = -(-sub // parts)
    sc = int2.int2_scores_plain(packed, scales, src, qi8, qscale, allowed, n).reshape(nq, t, sub, 128)
    lists = []
    for rank in range(parts):
        lo = min(sub, rank * per)
        hi = min(sub, lo + per)
        bv = torch.full((nq, t, 128, p), float("-inf"))
        bs = torch.zeros((nq, t, 128, p), dtype=torch.int64)
        for s0 in range(lo, hi, pass_subs):
            for s in range(s0, min(hi, s0 + pass_subs)):
                _insert(bv, bs, sc[:, :, s, :], torch.full((), s))
        lists.append((bv, bs))
    bv = torch.full((nq, t, 128, p), float("-inf"))
    bs = torch.zeros((nq, t, 128, p), dtype=torch.int64)
    for pv, ps in lists:
        for j in range(p):
            _insert(bv, bs, pv[..., j], ps[..., j])
    rows = (torch.arange(t)[:, None, None] * tile_n + bs * 128 + torch.arange(128)[:, None])
    return (bv.permute(0, 1, 3, 2).reshape(nq, t * m_top),
            rows.permute(0, 1, 3, 2).reshape(nq, t * m_top).to(torch.int32))


def _int2_inputs(rng, n, d, nq, dup=False):
    packed = rng.integers(0, 256, (d // 4, n), dtype=np.uint8)
    scales = (rng.random(n) + 0.5).astype(np.float32)
    if dup:  # every row 8 times over: equal scores in a bin
        packed = np.tile(packed[:, : n // 8], (1, 8))
        scales = np.tile(scales[: n // 8], 8)
    src = rng.integers(0, 3, n).astype(np.int32)
    src[rng.random(n) < 0.2] = -1
    qi8, qs = topk.quantize_queries(torch.from_numpy(rng.standard_normal((nq, d)).astype(np.float32)))
    return torch.from_numpy(packed), torch.from_numpy(scales), torch.from_numpy(src), qi8, qs


def _allowed(ids=None):
    a = torch.full((16,), -9, dtype=torch.int32)
    if ids is None:
        a[0] = topk.ALLOW_ALL
    else:
        a[: len(ids)] = torch.tensor(ids, dtype=torch.int32)
    return a


TILETOP_MODEL_CASES = [
    # (nq, n, n_sweep, kc, m_top, filter, case): tiles of 12,288 down to 512
    (1, 24576, 0, 0, 256, None, "random"),  # tile 12,288: 3 parts of one 32-sublane pass
    (2, 36864, 24576, 0, 512, [1], "ties"),  # a sweep prefix; 3 parts at Q = 2
    (3, 16384, 0, 0, 384, [0, 1], "dead_bins"),  # tile 8,192: 4 parts of 16 sublanes
    (8, 12288, 0, 0, 128, None, "random"),  # 8 parts of 12 sublanes: passes of 8 and 4
    (9, 8192, 0, 0, 512, None, "ties"),  # 2 query tiles, the second of one query
    (1, 1536, 0, 0, 128, None, "random"),  # tile 512: one part, 4 of a pass's 32 sublanes
    (2, 3072, 0, 0, 256, [2], "dead_bins"),  # tile 1,024
    (5, 6144, 0, 0, 384, None, "random"),  # tile 2,048: 2 parts of 8 sublanes
]


@pytest.mark.parametrize("nq,n,n_sweep,kc,m_top,filt,case", TILETOP_MODEL_CASES)
def test_tiletop_model_matches_plain(nq, n, n_sweep, kc, m_top, filt, case):
    rng = np.random.default_rng(nq * n + m_top)
    packed, scales, src, qi8, qs = _int2_inputs(rng, n, 64, nq, dup=case == "ties")
    if case == "dead_bins":  # lanes 0-4 hold only source 2, which the filter drops or keeps alone
        src[torch.arange(n) % 128 < 5] = 2
    args = (packed, scales, src, qi8, qs, _allowed(filt), n_sweep, kc, m_top)
    got, want = tiletop_model(*args), int2.int2_tiletop_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if case == "dead_bins":
        assert bool(torch.isneginf(got[0]).any())


def test_tiletop_parts():
    """The tile's parts at each query tile: one pass each at one or two
    queries over the 12,288-row tile (its 310 tiles give 930 blocks of K5's
    4,096 rows at Q = 1); never more than a portable cluster."""
    assert tiletop_parts(12288, 1) == (3, 32) and tiletop_parts(12288, 2) == (3, 32)
    assert tiletop_parts(12288, 4) == (6, 16) and tiletop_parts(12288, 8) == (8, 8)
    assert tiletop_parts(4096, 512) == (4, 8) and tiletop_parts(512, 1) == (1, 32)
    assert all(tiletop_parts(t, q)[0] <= 8 for t in int2._TILES_INT2 for q in (1, 2, 3, 8, 512))
    n = 3_809_280
    tile = int2._pick_tile_int2(n, 1, 96)
    assert tile == 12288 and n // tile * tiletop_parts(tile, 1)[0] == 930
    assert math.ceil(n / (256 * 16)) == 930  # K5's tiles over the same rows
