"""The int2 tier's coarse-to-fine scan: 2-bit coarse scores, a select of
the coarse candidates, and a fine rescore against the int8 or packed-int4
companion.

Port of perceive_tpu/ops/topk.py's int2 section (``scan_int2_coarse_fine``
with its selects, ``_int2_fine_phase``).  Three hand-written CUDA kernels,
each beside its plain PyTorch version and a launch counter:

    K5   int2_scores    masked (Q, n_sweep) coarse scores   csrc/scan_int2.cu
    K6   select_topk    exact top-kc of each score row      csrc/select_topk.cu
    K10  int2_tiletop   K5's scores, kept per tile bin      csrc/scan_int2.cu

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel or raises.

Layout of the coarse matrix ((D/4, N) uint8, transposed): byte [r, n] packs
dims r, r + D/4, r + 2D/4 and r + 3D/4 of row n as 2-bit crumbs, levels
{-3, -1, 1, 3}.  Planes 0-2 store c with level 2c - 3; plane 3 stores t in
two's complement with level 2t + 1.  Scores are ``f32(int32 dot) * row
scale * query scale``, multiplied in that order.

The select (``select=``, the matrix's ``coarse_select``) is one of:
  * "exact" (K5 -> K6): the exact top-kc; its floor is the kc-th coarse
    score, an upper bound on every row outside the candidates.  "auto" and
    "approx" run it too: the JAX package's approximate select is a TPU
    custom call that lowers to an exact top-k on the CPU.
  * "tiletop" (K10 -> K6 over its buffer): the best M/128 rows of every
    stride-128 lane bin of every tile, then the top kc of those; rows
    crowded out of a bin are lost, so the floor (the kc-th kept score) is
    statistical only.
  * "window" (K5, then glue): every row of the kc 128-row windows with the
    highest maxima is rescored (kc * 128 rows); floor: the kc-th window max.
  * "threshold" (K5, then glue): the rows of those windows scoring at least
    the kc-th window max, up to kc + _INT2_CAP_SLACK of them, else the top
    of them by score; floor: that threshold, or the last kept score.
Window and threshold candidates contain the exact select's.  Wherever the
JAX package calls ``lax.top_k`` (ties to the lower index), the glue here
selects by unique keys (``_top_k``), never by a bare ``torch.topk``, whose
tie order on the card is unspecified.  The candidates go to the fine phase
in row order, so equal fine scores fall to the lower row.  The fine phase
is glue, as in JAX: a gather of the candidate columns of the (D, N) int8
companion, or of the (D/2, N) packed int4 one then unpacked
(``topk.unpack_int4``), and an int32-exact dot (``topk.int8_dots``).
"""

from __future__ import annotations

import torch

from . import _cuda
from .topk import (
    _PLAIN_BYTES,
    MAX_FILTER,
    _device_of,
    _order_keys,
    _select_topk,
    _sweep_n,
    int8_dots,
    mask_scores,
    quantize_queries,
    unpack_int4,
)

# Coarse candidate depth (the JAX package's INT2_COARSE_FETCH).
INT2_COARSE_FETCH = 4096

# The tiletop select's geometry, copied from the JAX package's tile picker
# (perceive_tpu/ops/topk.py _TILES, _TILES_INT2, _VMEM_BUDGET,
# _pick_tile_int2, _tiletop_depth).  There the numbers fit a TPU's VMEM;
# here they fix the tiletop select's bins (the stride-128 lanes of a
# tile_n-row tile, M/128 rows kept a bin), so they define its result, and
# tile_n depends on the query count.  K10's block shape is its own; the
# bins are not.
_TILES = (8192, 4096, 2048, 1024, 512)
_TILES_INT2 = (12288,) + _TILES
_VMEM_BUDGET = 12 * 1024 * 1024
_INT2_TILETOP_M = 256  # 2 x 128 lanes per tile
_INT2_TILETOP_MAX = 512
# the window and threshold selects: window width, and the threshold's
# slack over kc for rows tied at it
_INT2_WINDOW = 128
_INT2_CAP_SLACK = 1024
SELECTS = ("exact", "tiletop", "window", "threshold")

LAUNCHES_SCORES = 0  # K5
LAUNCHES_SELECT = 0  # K6
LAUNCHES_TILETOP = 0  # K10


def launch_counts() -> dict:
    return {"int2_scores": LAUNCHES_SCORES, "select_topk": LAUNCHES_SELECT, "int2_tiletop": LAUNCHES_TILETOP}


def reset_launch_counts() -> None:
    global LAUNCHES_SCORES, LAUNCHES_SELECT, LAUNCHES_TILETOP
    LAUNCHES_SCORES = LAUNCHES_SELECT = LAUNCHES_TILETOP = 0


def int2_coarse_depth(k: int, n: int, fetch: int = 0) -> int:
    """Coarse candidate depth for a fine fetch of ``k``: the audit's
    adaptive ``fetch`` (0 = INT2_COARSE_FETCH), at least 2k, at most n."""
    return min(max(fetch or INT2_COARSE_FETCH, 2 * k), n)


def _pick_tile_int2(n: int, nq: int, d4: int) -> int:
    for t in _TILES_INT2:
        if n % t:
            continue
        if 2 * d4 * t + 4 * d4 * t + nq * t * 4 <= _VMEM_BUDGET:
            return t
    if n % _TILES[-1] == 0:
        return _TILES[-1]
    raise ValueError(f"matrix rows {n} not a multiple of {_TILES[-1]}")


def _tiletop_depth(n: int, tile_n: int, kc: int) -> int:
    """Per-tile output width M (a multiple of 128) for a kc-deep fetch: at
    least _INT2_TILETOP_M and enough that the T * M buffer holds >= 2 * kc
    candidates; raises past _INT2_TILETOP_MAX."""
    t = max(n // tile_n, 1)
    need = -(-2 * kc // t)  # ceil: buffer >= 2*kc
    m = max(_INT2_TILETOP_M, 128 * -(-need // 128))
    if m > _INT2_TILETOP_MAX:
        raise ValueError(
            f"tiletop select needs {m}-wide tiles at n={n}, kc={kc} "
            f"(tile {tile_n}) — beyond the epilogue budget "
            f"{_INT2_TILETOP_MAX}; use select='approx' or 'exact'"
        )
    return m


def tiletop_viable(n: int, nq: int, d4: int, kc: int) -> bool:
    """True when the tiletop select applies at this geometry (enough tiles
    that the per-tile depth stays in budget)."""
    if kc >= n:
        return False
    try:
        _tiletop_depth(n, _pick_tile_int2(n, nq, d4), kc)
    except ValueError:
        return False
    return True


def _tiletop_geometry(n: int, nq: int, d4: int, kc: int, m_top: int) -> tuple[int, int]:
    """(tile_n, M) of the tiletop select; M from the depth rule unless given."""
    tile_n = _pick_tile_int2(n, nq, d4)
    m_top = m_top or _tiletop_depth(n, tile_n, kc or 1)
    if m_top % 128 or not 128 <= m_top <= _INT2_TILETOP_MAX:
        raise ValueError(f"tiletop width {m_top} is not a multiple of 128 in [128, {_INT2_TILETOP_MAX}]")
    return tile_n, m_top


# -- reference math ------------------------------------------------------------


def unpack_int2(packed: torch.Tensor) -> torch.Tensor:
    """(D/4, N) uint8 -> (D, N) int8 levels in {-3, -1, 1, 3} (the JAX
    ``unpack_int2_xla``)."""
    p = packed.to(torch.int32)
    c0, c1, c2 = p & 3, (p >> 2) & 3, (p >> 4) & 3
    t3 = p >> 6
    t3 = torch.where(t3 >= 2, t3 - 4, t3)
    return torch.cat([2 * c0 - 3, 2 * c1 - 3, 2 * c2 - 3, 2 * t3 + 1], dim=0).to(torch.int8)


def scores_int2(packed, scales, qi8, qscale) -> torch.Tensor:
    """(Q, N) f32 coarse scores (the JAX ``xla_scores_int2``)."""
    return int8_dots(qi8, unpack_int2(packed)) * scales[None, :] * qscale


def int2_scores_plain(packed, scales, source_ids, qi8, qscale, allowed, n_sweep: int = 0):
    """Plain PyTorch version of K5: masked (Q, n_sweep) coarse scores."""
    n = _sweep_n(packed.shape[1], n_sweep)
    src = source_ids[:n]
    return mask_scores(scores_int2(packed[:, :n], scales[:n], qi8, qscale), src, allowed.to(src.device))


def int2_tiletop_plain(packed, scales, source_ids, qi8, qscale, allowed, n_sweep: int = 0, kc: int = 0,
                       m_top: int = 0):
    """Plain PyTorch version of K10, the JAX kernel's body written out: per
    tile, the scores reshaped (Q, tile_n / 128, 128) and M / 128 passes of
    max / argmax over the sublanes (argmax takes the first of equal values),
    each pass masking the places it took to -inf.  Scored in whole tiles of
    at most about _PLAIN_BYTES of temporaries."""
    n = _sweep_n(packed.shape[1], n_sweep)
    nq = qi8.shape[0]
    tile_n, m_top = _tiletop_geometry(n, nq, packed.shape[0], kc, m_top)
    dev = packed.device
    sub = torch.arange(tile_n // 128, device=dev)[None, None, :, None]
    lane = torch.arange(128, device=dev)
    step = tile_n * max(1, _PLAIN_BYTES // (tile_n * (16 * 4 * packed.shape[0] + 16 * nq)))
    vals, rows = [], []
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        t = (hi - lo) // tile_n
        resh = int2_scores_plain(packed[:, lo:hi], scales[lo:hi], source_ids[lo:hi], qi8, qscale,
                                 allowed).reshape(nq, t, tile_n // 128, 128)
        base = (lo + tile_n * torch.arange(t, device=dev))[:, None] + lane  # (t, 128)
        vs, ps = [], []
        for _ in range(m_top // 128):
            v, a = resh.max(dim=2)
            vs.append(v)
            ps.append(base + a * 128)
            resh = resh.masked_fill(sub == a[:, :, None, :], float("-inf"))
        vals.append(torch.stack(vs, dim=2).reshape(nq, t * m_top))
        rows.append(torch.stack(ps, dim=2).reshape(nq, t * m_top))
    return torch.cat(vals, dim=1), torch.cat(rows, dim=1).to(torch.int32)


def select_topk_plain(scores: torch.Tensor, kc: int):
    """Plain PyTorch version of K6: the exact top-kc (1 <= kc <= n) of each
    (n,) row of (Q, n) scores by the key (score, lower row first; -inf rows
    rank last, lower row first) -> ((Q, kc) scores, (Q, kc) int32 rows,
    both ordered by row; (Q,) floor = the kc-th score)."""
    keys = _order_keys(scores, 0)
    top = torch.topk(keys, kc, dim=1, largest=True, sorted=True).values
    idx = (1 << 31) - 1 - (top & ((1 << 31) - 1))
    floor = torch.gather(scores, 1, idx[:, -1:])[:, 0]
    rows = torch.sort(idx, dim=1).values
    return torch.gather(scores, 1, rows), rows.to(torch.int32), floor


# -- kernel wrappers -----------------------------------------------------------


def _check_int2(packed, scales, source_ids, qi8, qscale, allowed) -> None:
    if packed.dtype != torch.uint8 or packed.dim() != 2 or packed.shape[1] % 4:
        raise ValueError(f"the coarse matrix must be (D/4, N) uint8 with N a multiple of 4, got "
                         f"{tuple(packed.shape)} {packed.dtype}")
    if qi8.dtype != torch.int8 or qi8.dim() != 2 or qi8.shape[1] != 4 * packed.shape[0]:
        raise ValueError(f"queries must be (Q, {4 * packed.shape[0]}) int8, got {tuple(qi8.shape)} {qi8.dtype}")
    if qscale.shape != (qi8.shape[0], 1) or qscale.dtype != torch.float32:
        raise ValueError("qscale must be (Q, 1) float32")
    if scales.shape != (packed.shape[1],) or scales.dtype != torch.float32:
        raise ValueError("scales must be (N,) float32")
    if source_ids.shape != (packed.shape[1],) or source_ids.dtype != torch.int32:
        raise ValueError("source_ids must be (N,) int32")
    if allowed.dim() != 1 or not 1 <= allowed.shape[0] <= MAX_FILTER or allowed.dtype != torch.int32:
        raise ValueError(f"allowed must be (F,) int32 with 1 <= F <= {MAX_FILTER}")


def _check_on_card(what: str, packed, scales, source_ids, qi8, qscale, allowed) -> None:
    dev = packed.device
    for name, t in (("scales", scales), ("source_ids", source_ids), ("qi8", qi8), ("qscale", qscale),
                    ("allowed", allowed)):
        if t.device != dev:
            raise ValueError(f"{what}: {name} on {t.device}, matrix on {dev}")
    if not (packed.is_contiguous() and scales.is_contiguous() and source_ids.is_contiguous()):
        raise ValueError(f"{what} needs contiguous matrix, scales and source ids")


def int2_scores(packed, scales, source_ids, qi8, qscale, allowed, n_sweep: int = 0):
    """K5: masked (Q, n_sweep) f32 coarse scores of int8 queries against the
    packed (D/4, N) matrix with (N,) f32 row scales.  On the card N must be
    a multiple of 16 (the kernel reads 16 rows of a plane-row at once; the
    matrices the package builds have capacities that are multiples of
    ROW_ALIGN = 512)."""
    global LAUNCHES_SCORES
    _check_int2(packed, scales, source_ids, qi8, qscale, allowed)
    if _device_of(packed, "int2_scores") == "cpu":
        return int2_scores_plain(packed, scales, source_ids, qi8, qscale, allowed, n_sweep)
    _check_on_card("int2_scores", packed, scales, source_ids, qi8, qscale, allowed)
    if packed.shape[1] % 16:
        raise ValueError(f"int2_scores: N must be a multiple of 16, got {packed.shape[1]}")
    dev = packed.device
    nq, d = qi8.shape
    n = _sweep_n(packed.shape[1], n_sweep)
    out = torch.empty((nq, n), dtype=torch.float32, device=dev)
    if nq == 0 or n == 0:
        return out
    lib = _cuda.library()
    qi8, qscale, allowed = qi8.contiguous(), qscale.contiguous(), allowed.contiguous()
    code = lib.perceive_int2_scores(packed.data_ptr(), packed.shape[1], scales.data_ptr(),
                                    source_ids.data_ptr(), qi8.data_ptr(), qscale.data_ptr(),
                                    allowed.data_ptr(), allowed.shape[0], nq, d, n, out.data_ptr(),
                                    _cuda.stream_of(packed))
    _cuda.check(code, "int2_scores")
    LAUNCHES_SCORES += 1
    return out


def int2_tiletop(packed, scales, source_ids, qi8, qscale, allowed, n_sweep: int = 0, kc: int = 0,
                 m_top: int = 0):
    """K10: K5's masked scores of the first n_sweep rows, kept per tile of
    tile_n rows (``_pick_tile_int2``) and stride-128 lane bin: the best
    M / 128 of each bin (M from ``_tiletop_depth(kc)`` unless ``m_top``
    pins it), by (score, lower row first), then (-inf, the bin's first row)
    once its finite scores run out -> ((Q, T * M) f32, (Q, T * M) int32
    global rows), bin l of tile t's j-th entry at t * M + j * 128 + l.  On
    the card N must be a multiple of 16, as for ``int2_scores``."""
    global LAUNCHES_TILETOP
    _check_int2(packed, scales, source_ids, qi8, qscale, allowed)
    if _device_of(packed, "int2_tiletop") == "cpu":
        return int2_tiletop_plain(packed, scales, source_ids, qi8, qscale, allowed, n_sweep, kc, m_top)
    _check_on_card("int2_tiletop", packed, scales, source_ids, qi8, qscale, allowed)
    if packed.shape[1] % 16:
        raise ValueError(f"int2_tiletop: N must be a multiple of 16, got {packed.shape[1]}")
    dev = packed.device
    nq, d = qi8.shape
    n = _sweep_n(packed.shape[1], n_sweep)
    tile_n, m_top = _tiletop_geometry(n, nq, packed.shape[0], kc, m_top)
    width = n // tile_n * m_top
    vals = torch.empty((nq, width), dtype=torch.float32, device=dev)
    rows = torch.empty((nq, width), dtype=torch.int32, device=dev)
    if nq == 0:
        return vals, rows
    lib = _cuda.library()
    qi8, qscale, allowed = qi8.contiguous(), qscale.contiguous(), allowed.contiguous()
    code = lib.perceive_int2_tiletop(packed.data_ptr(), packed.shape[1], scales.data_ptr(),
                                     source_ids.data_ptr(), qi8.data_ptr(), qscale.data_ptr(),
                                     allowed.data_ptr(), allowed.shape[0], nq, d, n, tile_n, m_top,
                                     vals.data_ptr(), rows.data_ptr(), _cuda.stream_of(packed))
    _cuda.check(code, "int2_tiletop")
    LAUNCHES_TILETOP += 1
    return vals, rows


def select_topk(scores: torch.Tensor, kc: int):
    """K6: exact top-kc of each row of (Q, n) f32 scores, 1 <= kc <= n ->
    ((Q, kc) scores, (Q, kc) int32 rows, ordered by row; (Q,) floor)."""
    global LAUNCHES_SELECT
    if scores.dim() != 2 or scores.dtype != torch.float32:
        raise ValueError(f"scores must be (Q, n) float32, got {tuple(scores.shape)} {scores.dtype}")
    nq, n = scores.shape
    if not 1 <= kc <= n:
        raise ValueError(f"kc={kc} outside [1, {n}]")
    if _device_of(scores, "select_topk") == "cpu":
        return select_topk_plain(scores, kc)
    dev = scores.device
    vals = torch.empty((nq, kc), dtype=torch.float32, device=dev)
    rows = torch.empty((nq, kc), dtype=torch.int32, device=dev)
    floor = torch.empty((nq,), dtype=torch.float32, device=dev)
    if nq == 0:
        return vals, rows, floor
    lib = _cuda.library()
    scores = scores.contiguous()
    ws = torch.empty(lib.perceive_select_topk_workspace(nq, n), dtype=torch.uint8, device=dev)
    code = lib.perceive_select_topk(scores.data_ptr(), nq, n, kc, vals.data_ptr(), rows.data_ptr(),
                                    floor.data_ptr(), ws.data_ptr(), _cuda.stream_of(scores))
    _cuda.check(code, "select_topk")
    LAUNCHES_SELECT += 1
    return vals, rows, floor


# -- the pipeline ----------------------------------------------------------------


def fine_phase(cvals, idx, fine, fscales, qi8, qscale, k: int):
    """Rescore the (Q, kc) candidates ``idx`` (rows, coarse scores
    ``cvals``; -inf = no candidate) against the companion, the (D, N) int8
    matrix or the (D/2, N) uint8 packed int4 one, and keep the best k:
    ((Q, k) fine scores best first, (Q, k) int32 rows, (-inf, -1) past the
    matches).  Equal fine scores keep candidate order."""
    nq, depth = idx.shape
    cols = fine.index_select(1, idx.reshape(-1).long())
    if fine.dtype == torch.uint8:
        cols = unpack_int4(cols)
    cols = cols.reshape(-1, nq, depth)
    dots = torch.stack([int8_dots(qi8[i : i + 1], cols[:, i])[0] for i in range(nq)])
    fsc = fscales[idx.long()]
    scores = (dots * fsc * qscale).masked_fill(~torch.isfinite(cvals), float("-inf"))
    vals, pos = _select_topk(scores, min(k, depth))
    rows = torch.where(pos >= 0, torch.gather(idx, 1, pos.clamp(min=0).long()), pos)
    if vals.shape[1] < k:
        vals = torch.nn.functional.pad(vals, (0, k - vals.shape[1]), value=float("-inf"))
        rows = torch.nn.functional.pad(rows, (0, k - rows.shape[1]), value=-1)
    return vals, rows.to(torch.int32)


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` of each row of (Q, m) f32: ((Q, k) values best first,
    (Q, k) int64 indices), equal values to the lower index, -inf included."""
    top = torch.topk(_order_keys(x, 0), k, dim=1, largest=True, sorted=True).values
    idx = (1 << 31) - 1 - (top & ((1 << 31) - 1))
    return torch.gather(x, 1, idx), idx


def _window_rows(widx: torch.Tensor) -> torch.Tensor:
    """The rows of windows ``widx``, window by window."""
    return (widx[:, None] * _INT2_WINDOW + torch.arange(_INT2_WINDOW, device=widx.device)).reshape(-1)


def _select_topk_hier(scores_row: torch.Tensor, k: int):
    """The JAX ``_select_topk_hier``: the top-k windows by window max
    (value order), their scores gathered in that order, the top k of those
    (ties to the earlier place in that order) -> ((k,) values, (k,) rows)."""
    blocks = scores_row.reshape(-1, _INT2_WINDOW)
    _, widx = _top_k(blocks.amax(dim=1)[None], k)
    v, p = _top_k(blocks[widx[0]].reshape(1, -1), k)
    return v[0], _window_rows(widx[0])[p[0]]


def _top_windows(coarse_row: torch.Tensor, kc: int):
    """The kc windows of highest max: ((kc,) maxima best first, (kc,) window
    numbers ascending, (nw, 128) scores)."""
    sc_w = coarse_row.reshape(-1, _INT2_WINDOW)
    wv, widx = _top_k(sc_w.amax(dim=1)[None], kc)
    return wv[0], torch.sort(widx[0]).values, sc_w


def _select_window_fine(coarse_row, fine, fscales, qi8_row, qscale_row, kc: int, kf: int):
    """The JAX ``_select_window_fine`` for one query: every row of the kc
    windows of highest max rescored against the companion, the best kf
    kept -> ((kf,) fine scores best first, (kf,) rows, () floor: the kc-th
    window max, -inf when every window was taken)."""
    wv, widx, sc_w = _top_windows(coarse_row, kc)
    floor = wv[-1] if kc < sc_w.shape[0] else torch.tensor(float("-inf"), device=wv.device)
    cblk = sc_w[widx].reshape(-1)
    sblk = fscales.reshape(-1, _INT2_WINDOW)[widx].reshape(-1)
    blk = fine.reshape(fine.shape[0], -1, _INT2_WINDOW)[:, widx].reshape(fine.shape[0], -1)
    lv = unpack_int4(blk) if fine.dtype == torch.uint8 else blk
    scores = (int8_dots(qi8_row[None], lv)[0] * sblk * qscale_row).masked_fill(~torch.isfinite(cblk),
                                                                             float("-inf"))
    v, p = _select_topk_hier(scores, kf)
    return v, _window_rows(widx)[p], floor


def _select_threshold(coarse_row, kc: int, kcap: int):
    """The JAX ``_select_threshold`` for one query: the rows of the kc
    windows of highest max that score at least the kc-th window max, in row
    order and padded with (-inf, row 0) to kcap (``_compact_ge``); where
    more than kcap tie in, the top kcap of those windows by score instead
    (its ``lax.cond``; here a host branch) -> ((kcap,) scores, (kcap,) rows,
    () floor: the threshold, or the kcap-th score kept)."""
    wv, widx, sc_w = _top_windows(coarse_row, kc)
    theta = wv[kc - 1]
    blocks = sc_w[widx].reshape(-1)
    rows = _window_rows(widx)
    keep = blocks >= theta
    cnt = int(keep.sum())
    if cnt <= kcap:
        cv = torch.full((kcap,), float("-inf"), device=blocks.device)
        cr = torch.zeros((kcap,), dtype=rows.dtype, device=rows.device)
        cv[:cnt], cr[:cnt] = blocks[keep], rows[keep]
        return cv, cr, theta
    cv, p = _top_k(blocks[None], kcap)
    cr = rows[p[0]]
    order = torch.sort(cr, stable=True).indices
    return cv[0][order], cr[order], cv[0, kcap - 1]


def _resolve_select(select: str, n: int, kc: int) -> str:
    """The JAX package's dispatch rules for ``select``."""
    if select == "tiletop" and kc >= n:
        return "exact"  # full fetch: nothing to select away
    if select in ("auto", "approx"):
        return "exact"
    if select not in SELECTS:
        raise ValueError(f"unknown select {select!r}")
    if select in ("window", "threshold") and not (n % _INT2_WINDOW == 0 and n // _INT2_WINDOW >= kc):
        raise ValueError(
            f"select {select!r} requires n % {_INT2_WINDOW} == 0 and "
            f"n // {_INT2_WINDOW} >= k_coarse (n={n}, k_coarse={kc})"
        )
    return select


def _coarse_fine(score_fn, select_fn, tiletop_fn, packed2, scales2, fine, fscales, source_ids, q, allowed,
                 k: int, k_coarse: int, n_sweep: int, fetch: int, select: str):
    n = _sweep_n(packed2.shape[1], n_sweep)
    kc = min(k_coarse or int2_coarse_depth(k, n, fetch), n)
    select = _resolve_select(select, n, kc)
    qi8, qscale = quantize_queries(q)
    if select == "tiletop":
        tvals, trows = tiletop_fn(packed2, scales2, source_ids, qi8, qscale, allowed, n, kc=kc)
        # the top kc of the buffer by (score, lower place), as lax.top_k
        # takes them, then in row order: a stable sort keeps a bin's rows
        # emitted twice (once finite, then as -inf fill) in place order
        cvals, pos, floor = select_fn(tvals, min(kc, tvals.shape[1]))
        idx = torch.gather(trows, 1, pos.long())
        order = torch.sort(idx, dim=1, stable=True).indices
        return (*fine_phase(torch.gather(cvals, 1, order), torch.gather(idx, 1, order), fine, fscales, qi8,
                            qscale, k), floor)
    coarse = score_fn(packed2, scales2, source_ids, qi8, qscale, allowed, n)
    if select == "window":
        kf = min(k, kc)
        outs = [_select_window_fine(coarse[i], fine, fscales, qi8[i], qscale[i, 0], kc, kf)
                for i in range(q.shape[0])]
        vals = torch.stack([v for v, _, _ in outs])
        rows = torch.stack([r for _, r, _ in outs])
        rows = torch.where(torch.isfinite(vals), rows, -1).to(torch.int32)
        if kf < k:
            vals = torch.nn.functional.pad(vals, (0, k - kf), value=float("-inf"))
            rows = torch.nn.functional.pad(rows, (0, k - kf), value=-1)
        return vals, rows, torch.stack([f for _, _, f in outs])
    if select == "threshold":
        kcap = min(kc + _INT2_CAP_SLACK, kc * _INT2_WINDOW)
        outs = [_select_threshold(coarse[i], kc, kcap) for i in range(q.shape[0])]
        cvals, idx, floor = (torch.stack(x) for x in zip(*outs))
    else:
        cvals, idx, floor = select_fn(coarse, kc)
        if kc >= n:
            floor = torch.full_like(floor, float("-inf"))
    vals, rows = fine_phase(cvals, idx, fine, fscales, qi8, qscale, k)
    return vals, rows, floor


def scan_int2_coarse_fine(packed2, scales2, fine, fscales, source_ids, q, allowed, k: int, *,
                          k_coarse: int = 0, n_sweep: int = 0, fetch: int = 0, select: str = "exact"):
    """Coarse-to-fine int2 scan of f32 queries (quantized here): the coarse
    pass and ``select`` (module docstring: "exact" K5 -> K6, "tiletop" K10
    -> K6, "window" and "threshold" K5 -> glue), then the fine phase against
    ``fine``, the int8 or the packed int4 companion (``fine_phase``; the
    window select rescores its windows itself).  Returns ((Q, k) fine
    scores best first, (Q, k) int32 rows, (Q,) coarse floor: an upper bound
    on the coarse score of every row outside the candidates, statistical
    only for "tiletop"; -inf when the whole sweep was fetched).  The
    searcher reranks the rows in f32."""
    return _coarse_fine(int2_scores, select_topk, int2_tiletop, packed2, scales2, fine, fscales, source_ids, q,
                        allowed, k, k_coarse, n_sweep, fetch, select)


def scan_int2_coarse_fine_plain(packed2, scales2, fine, fscales, source_ids, q, allowed, k: int, *,
                                k_coarse: int = 0, n_sweep: int = 0, fetch: int = 0, select: str = "exact"):
    """``scan_int2_coarse_fine`` through the plain versions of K5, K6 and
    K10, on any device (the card's check of the composed kernels)."""
    return _coarse_fine(int2_scores_plain, select_topk_plain, int2_tiletop_plain, packed2, scales2, fine,
                        fscales, source_ids, q, allowed, k, k_coarse, n_sweep, fetch, select)
