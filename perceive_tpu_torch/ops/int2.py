"""The int2 tier's coarse-to-fine scan: 2-bit coarse scores, an exact top-kc
select, and a fine rescore against the int8 or packed-int4 companion.

Port of perceive_tpu/ops/topk.py's int2 section (``scan_int2_coarse_fine``
with the exact select, ``_int2_fine_phase``).  Two hand-written CUDA
kernels, each beside its plain PyTorch version and a launch counter:

    K5  int2_scores   masked (Q, n_sweep) coarse scores   csrc/scan_int2.cu
    K6  select_topk   exact top-kc of each score row      csrc/select_topk.cu

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel or raises.

Layout of the coarse matrix ((D/4, N) uint8, transposed): byte [r, n] packs
dims r, r + D/4, r + 2D/4 and r + 3D/4 of row n as 2-bit crumbs, levels
{-3, -1, 1, 3}.  Planes 0-2 store c with level 2c - 3; plane 3 stores t in
two's complement with level 2t + 1.  Scores are ``f32(int32 dot) * row
scale * query scale``, multiplied in that order.

The select is exact (the JAX package's default, ``approx_max_k``, is a TPU
custom call; on the CPU it lowers to an exact top-k, so the JAX package's
CPU results are this module's).  Its floor is the kc-th coarse score: every
row outside the candidates scores at most that.  The candidates go to the
fine phase in row order, so equal fine scores fall to the lower row.  The
fine phase is glue, as in JAX: a gather of the kc candidate columns of the
(D, N) int8 companion, or of the (D/2, N) packed int4 one then unpacked
(``topk.unpack_int4``), and an int32-exact dot (``topk.int8_dots``).
"""

from __future__ import annotations

import torch

from . import _cuda
from .topk import (
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

LAUNCHES_SCORES = 0  # K5
LAUNCHES_SELECT = 0  # K6


def launch_counts() -> dict:
    return {"int2_scores": LAUNCHES_SCORES, "select_topk": LAUNCHES_SELECT}


def reset_launch_counts() -> None:
    global LAUNCHES_SCORES, LAUNCHES_SELECT
    LAUNCHES_SCORES = LAUNCHES_SELECT = 0


def int2_coarse_depth(k: int, n: int, fetch: int = 0) -> int:
    """Coarse candidate depth for a fine fetch of ``k``: the audit's
    adaptive ``fetch`` (0 = INT2_COARSE_FETCH), at least 2k, at most n."""
    return min(max(fetch or INT2_COARSE_FETCH, 2 * k), n)


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


def int2_scores(packed, scales, source_ids, qi8, qscale, allowed, n_sweep: int = 0):
    """K5: masked (Q, n_sweep) f32 coarse scores of int8 queries against the
    packed (D/4, N) matrix with (N,) f32 row scales."""
    global LAUNCHES_SCORES
    _check_int2(packed, scales, source_ids, qi8, qscale, allowed)
    if _device_of(packed, "int2_scores") == "cpu":
        return int2_scores_plain(packed, scales, source_ids, qi8, qscale, allowed, n_sweep)
    dev = packed.device
    for name, t in (("scales", scales), ("source_ids", source_ids), ("qi8", qi8), ("qscale", qscale),
                    ("allowed", allowed)):
        if t.device != dev:
            raise ValueError(f"int2_scores: {name} on {t.device}, matrix on {dev}")
    if not (packed.is_contiguous() and scales.is_contiguous() and source_ids.is_contiguous()):
        raise ValueError("int2_scores needs contiguous matrix, scales and source ids")
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


def _coarse_fine(score_fn, select_fn, packed2, scales2, fine, fscales, source_ids, q, allowed,
                 k: int, k_coarse: int, n_sweep: int, fetch: int):
    n = _sweep_n(packed2.shape[1], n_sweep)
    kc = min(k_coarse or int2_coarse_depth(k, n, fetch), n)
    qi8, qscale = quantize_queries(q)
    coarse = score_fn(packed2, scales2, source_ids, qi8, qscale, allowed, n)
    cvals, idx, floor = select_fn(coarse, kc)
    if kc >= n:
        floor = torch.full_like(floor, float("-inf"))
    vals, rows = fine_phase(cvals, idx, fine, fscales, qi8, qscale, k)
    return vals, rows, floor


def scan_int2_coarse_fine(packed2, scales2, fine, fscales, source_ids, q, allowed, k: int, *,
                          k_coarse: int = 0, n_sweep: int = 0, fetch: int = 0):
    """Coarse-to-fine int2 scan of f32 queries (quantized here):
    K5 -> K6 -> the fine phase, against ``fine``, the int8 or the packed
    int4 companion (``fine_phase``).  Returns ((Q, k) fine scores best first,
    (Q, k) int32 rows, (Q,) coarse floor: the k_coarse-th coarse score, an
    upper bound on the coarse score of every row outside the candidates;
    -inf when the whole sweep was fetched).  The searcher reranks the rows
    in f32."""
    return _coarse_fine(int2_scores, select_topk, packed2, scales2, fine, fscales, source_ids, q,
                        allowed, k, k_coarse, n_sweep, fetch)


def scan_int2_coarse_fine_plain(packed2, scales2, fine, fscales, source_ids, q, allowed, k: int, *,
                                k_coarse: int = 0, n_sweep: int = 0, fetch: int = 0):
    """``scan_int2_coarse_fine`` through the plain versions of K5 and K6, on
    any device (the card's check of the composed kernels)."""
    return _coarse_fine(int2_scores_plain, select_topk_plain, packed2, scales2, fine, fscales,
                        source_ids, q, allowed, k, k_coarse, n_sweep, fetch)
