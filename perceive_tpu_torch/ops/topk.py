"""Exact scan with top-k over the embedding matrix, at the bf16/f32, int8
and packed-int4 tiers and over the int2 tier's int8 or int4 companion.

Port of perceive_tpu/ops/topk.py's scans.  Eight hand-written CUDA kernels,
each beside its plain PyTorch version and a launch counter:

    K1  scan_topk_flat         bf16/f32, Q < 256            csrc/scan_flat_rows.cu
    K2  scan_topk_slab         bf16, Q >= 256               csrc/scan_slab_rows.cu
    K3  scan_topk_int8_flat    int8, Q < 256                csrc/scan_flat_rows.cu
    K4  scan_topk_int8_slab    int8, Q >= 256               csrc/scan_slab_rows.cu
    K7  scan_topk_int8t_flat   int8 (D, N) transposed, Q < 256   csrc/scan_flat_cols.cu
    K8  scan_topk_int8t_slab   int8 (D, N) transposed, Q >= 256  csrc/scan_slab_cols.cu
    K9  scan_topk_int4_flat    packed int4 (D/2, N), Q < 256     csrc/scan_flat_cols.cu
    K9  scan_topk_int4_slab    packed int4 (D/2, N), Q >= 256    csrc/scan_slab_cols.cu

The int2 tier's coarse pass (K5, K6) is ops/int2.py.

A kernel wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches its kernel or raises: nothing falls back.  The entry
points ``scan_topk``, ``scan_topk_int8``, ``scan_topk_int8t`` and
``scan_topk_int4`` route as the JAX package does:
batches split into sweeps of at most MAX_QUERY_SLAB queries, a sweep of at
least 2 * QUERY_SLAB queries is zero-padded to a multiple of QUERY_SLAB
(``_slab_pad``) and takes the slab kernel, every other sweep the flat one.
An f32 matrix has no slab kernel and stays on K1 at every width.

Semantics, shared by all:
  * bf16/f32: q is cast to the matrix dtype; dot products accumulate in f32;
  * int8: queries quantize per query (``quantize_queries``); scores are
    ``f32(int32 dot) * row scale * query scale``, multiplied in that order,
    so kernel and plain version agree bit for bit; the transposed companion
    scores the same way (``scores_int8t``), and so does the packed int4
    matrix (``scores_int4``; layout at ``unpack_int4``);
  * rows whose source id is negative (tombstones, unallocated tail) or not
    in ``allowed`` are excluded; ``allowed[0] == ALLOW_ALL`` disables the
    source filter;
  * only the first ``n_sweep`` rows are read (0 = every row);
  * results are sorted best first; equal scores order by the lower row;
  * slots past the number of matching rows carry -inf and row -1.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _cuda

ALLOW_ALL = -2  # sentinel in allowed[0]: disable source filtering
MAX_FILTER = 16
QUERY_SLAB = 128  # the slab kernels take sweeps of whole slabs
SLAB_QUERIES = 64  # query chunks of the slab kernels align to this (a consumer warpgroup's queries)
# queries per sweep; larger batches run as consecutive sweeps
MAX_QUERY_SLAB = 2048
# workspace budget per launch (every scan keeps one list per row range and
# query); query chunks, or the flat row-major scans' ranges, shrink to fit
_WORKSPACE_BYTES = 1 << 30
# the plain versions' (Q, N) temporaries are bounded by this many bytes
_PLAIN_BYTES = 1 << 30
# the plain int8 version sums in f32: exact while every partial sum stays
# below 2**24, i.e. D * 127 * 127 < 2**24
_MAX_EXACT_INT8_DIM = 1040

# kernel launches, one per C-entry call (a query chunk)
LAUNCHES = 0  # K1
LAUNCHES_SLAB = 0  # K2
LAUNCHES_INT8 = 0  # K3
LAUNCHES_INT8_SLAB = 0  # K4
LAUNCHES_INT8T = 0  # K7
LAUNCHES_INT8T_SLAB = 0  # K8
LAUNCHES_INT4 = 0  # K9, flat
LAUNCHES_INT4_SLAB = 0  # K9, slab


def launch_counts() -> dict:
    return {"scan_topk": LAUNCHES, "scan_slab": LAUNCHES_SLAB,
            "scan_int8": LAUNCHES_INT8, "scan_int8_slab": LAUNCHES_INT8_SLAB,
            "scan_int8t": LAUNCHES_INT8T, "scan_int8t_slab": LAUNCHES_INT8T_SLAB,
            "scan_int4": LAUNCHES_INT4, "scan_int4_slab": LAUNCHES_INT4_SLAB}


def reset_launch_counts() -> None:
    global LAUNCHES, LAUNCHES_SLAB, LAUNCHES_INT8, LAUNCHES_INT8_SLAB, LAUNCHES_INT8T, LAUNCHES_INT8T_SLAB
    global LAUNCHES_INT4, LAUNCHES_INT4_SLAB
    LAUNCHES = LAUNCHES_SLAB = LAUNCHES_INT8 = LAUNCHES_INT8_SLAB = LAUNCHES_INT8T = LAUNCHES_INT8T_SLAB = 0
    LAUNCHES_INT4 = LAUNCHES_INT4_SLAB = 0


def _sweep_n(n: int, n_sweep: int) -> int:
    """Rows a sweep reads: the live prefix ``n_sweep``, or all rows when 0."""
    if not n_sweep or n_sweep >= n:
        return n
    return n_sweep


def _slab_pad(nq: int) -> int:
    """Zero queries that make a sweep of at least 2 * QUERY_SLAB queries a
    multiple of QUERY_SLAB, so that it takes the slab kernel."""
    if nq >= 2 * QUERY_SLAB and nq % QUERY_SLAB:
        return QUERY_SLAB - nq % QUERY_SLAB
    return 0


def _is_slab(nq: int) -> bool:
    return nq >= 2 * QUERY_SLAB and nq % QUERY_SLAB == 0


# -- reference math ------------------------------------------------------------


def mask_scores(scores: torch.Tensor, source_ids: torch.Tensor, allowed: torch.Tensor) -> torch.Tensor:
    """(Q, N) scores with excluded rows (source id < 0, or a source not
    in ``allowed`` unless ``allowed[0] == ALLOW_ALL``) forced to -inf."""
    keep = source_ids >= 0
    if int(allowed[0]) != ALLOW_ALL:
        keep &= torch.isin(source_ids, allowed)
    return scores.masked_fill(~keep[None, :], float("-inf"))


# 1/127 rounded to f32: the JAX package divides by the constant 127, and XLA
# compiles that division into a multiplication by this reciprocal; every
# JAX path runs it compiled, so the port multiplies too
_INV_127 = float(np.float32(1.0 / 127.0))


def quantize_queries(q: torch.Tensor):
    """(Q, D) f32 -> ((Q, D) int8, (Q, 1) f32 scales), symmetric per query:
    scale = max(max|q|, 1e-12) * f32(1/127), values rint(q / scale) (half
    to even) clipped to [-127, 127]."""
    q = q.float()
    scale = torch.clamp(q.abs().amax(dim=1, keepdim=True), min=1e-12) * _INV_127
    qi8 = torch.clamp(torch.round(q / scale), -127, 127).to(torch.int8)
    return qi8, scale


def int8_dots(qi8: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """(Q, N) f32 equal to the int32 dot products of (Q, D) int8 queries with
    (D, N) columns of small integers (int8 values, int2 levels), run as an
    f32 matmul: exact while D <= _MAX_EXACT_INT8_DIM (every partial sum stays
    below 2**24).  The one home of the TF32 switch: on a CUDA device it turns
    ``torch.backends.cuda.matmul.allow_tf32`` off for the process, since
    TF32 would round the integer sums (PyTorch's own default is off too)."""
    if cols.shape[0] > _MAX_EXACT_INT8_DIM:
        raise ValueError(f"dim {cols.shape[0]} > {_MAX_EXACT_INT8_DIM}: f32 sums of int8 products would round")
    if cols.device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    return qi8.float() @ cols.float()


def scores_int8(matrix: torch.Tensor, scales: torch.Tensor, qi8: torch.Tensor, qscale: torch.Tensor) -> torch.Tensor:
    """(Q, N) f32 scores of int8 queries against an (N, D) int8 matrix (or
    its values in f32): f32(int32 dot) * row scale * query scale."""
    return int8_dots(qi8, matrix.T) * scales[None, :] * qscale


def scores_int8t(m8t: torch.Tensor, scales: torch.Tensor, qi8: torch.Tensor, qscale: torch.Tensor) -> torch.Tensor:
    """``scores_int8`` over the TRANSPOSED (D, N) int8 matrix (the JAX
    ``xla_scores_int8t``)."""
    return int8_dots(qi8, m8t) * scales[None, :] * qscale


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """(D/2, N) uint8 -> (D, N) int8 (the JAX ``unpack_int4_xla``).  The
    packed matrix is stored transposed: byte [r, n] holds dim r of row n in
    the low nibble, biased +8 (``(p & 15) - 8``), and dim r + D/2 in the high
    nibble, two's complement.  Every byte decodes, a low nibble of 0 to -8."""
    p = packed.to(torch.int32)
    hb = p >> 4
    return torch.cat([(p & 15) - 8, torch.where(hb >= 8, hb - 16, hb)], dim=0).to(torch.int8)


def scores_int4(packed, scales, qi8, qscale) -> torch.Tensor:
    """(Q, N) f32 scores of int8 queries against the packed (D/2, N) int4
    matrix (the JAX ``xla_scores_int4``): f32(int32 dot) * row scale *
    query scale."""
    return int8_dots(qi8, unpack_int4(packed)) * scales[None, :] * qscale


def _order_keys(scores: torch.Tensor, row0: int, rows: torch.Tensor | None = None) -> torch.Tensor:
    """int64 keys that order like (score, -row): the kernels' 64-bit key
    (order-preserving f32 bits above the complement of the row), shifted to
    fit a signed integer.  Unique, so a top-k of keys is exact and equal
    scores order by the lower row.  Rows are row0, row0 + 1, ... unless
    ``rows`` (same shape as ``scores``, below 2**31 - 1) gives them."""
    bits = (scores + 0.0).view(torch.int32).to(torch.int64)  # -0 -> +0
    order = torch.where(bits < 0, ~bits, bits + (1 << 31))  # [0, 2**32), monotone
    if rows is None:
        rows = torch.arange(row0, row0 + scores.shape[1], device=scores.device, dtype=torch.int64)
    return order * (1 << 31) + ((1 << 31) - 1 - rows.to(torch.int64))


def _select_topk(scores: torch.Tensor, k: int):
    """Best-first top k of (Q, N) masked f32 scores -> ((Q, k) f32, (Q, k)
    int32 rows); equal scores order by the lower row; past the matching rows
    the slots carry (-inf, -1)."""
    nq, n = scores.shape
    kk = min(k, n)
    keys = _order_keys(scores, 0)
    top = torch.topk(keys, kk, dim=1, largest=True, sorted=True).values
    idx = (1 << 31) - 1 - (top & ((1 << 31) - 1))
    vals = torch.gather(scores, 1, idx)
    rows = torch.where(torch.isfinite(vals), idx, torch.full_like(idx, -1)).to(torch.int32)
    if kk < k:
        vals = torch.nn.functional.pad(vals, (0, k - kk), value=float("-inf"))
        rows = torch.nn.functional.pad(rows, (0, k - kk), value=-1)
    return vals, rows


def _plain_in_chunks(score_fn, nq: int, n: int, k: int, device):
    """Run ``score_fn(lo, hi) -> (hi - lo, n) masked scores`` over query
    chunks whose temporaries stay under _PLAIN_BYTES, selecting each."""
    step = max(1, _PLAIN_BYTES // max(1, n * 12))
    vals = torch.empty((nq, k), dtype=torch.float32, device=device)
    rows = torch.empty((nq, k), dtype=torch.int32, device=device)
    for lo in range(0, nq, step):
        hi = min(nq, lo + step)
        vals[lo:hi], rows[lo:hi] = _select_topk(score_fn(lo, hi), k)
    return vals, rows


def _merge_topk(vals: torch.Tensor, rows: torch.Tensor, k: int):
    """Best-first top k of (Q, M) candidates (score, row), rows unique per
    query; (-inf, -1) slots rank last and come out as (-inf, -1)."""
    fin = torch.isfinite(vals)
    keys = _order_keys(vals, 0, torch.where(fin, rows.to(torch.int64), (1 << 31) - 2))
    pos = torch.topk(keys, k, dim=1, largest=True, sorted=True).indices
    v = torch.gather(vals, 1, pos)
    r = torch.where(torch.isfinite(v), torch.gather(rows, 1, pos), -1)
    return v, r.to(torch.int32)


def scan_topk_plain(matrix, source_ids, q, allowed, k: int, n_sweep: int = 0):
    """Plain PyTorch version of K1 and K2 (see module docstring)."""
    n = _sweep_n(matrix.shape[0], n_sweep)
    m, src = matrix[:n].float(), source_ids[:n]
    qc = q.to(matrix.dtype).float()
    allowed = allowed.to(src.device)
    return _plain_in_chunks(lambda lo, hi: mask_scores(qc[lo:hi] @ m.T, src, allowed),
                            q.shape[0], n, k, matrix.device)


def scan_topk_int8_plain(matrix, scales, source_ids, qi8, qscale, allowed, k: int, n_sweep: int = 0):
    """Plain PyTorch version of K3 and K4 (see module docstring); ties
    break as a stable sort would, by the lower row."""
    n = _sweep_n(matrix.shape[0], n_sweep)
    m, s, src = matrix[:n].float(), scales[:n], source_ids[:n]
    allowed = allowed.to(src.device)
    return _plain_in_chunks(
        lambda lo, hi: mask_scores(scores_int8(m, s, qi8[lo:hi], qscale[lo:hi]), src, allowed),
        qi8.shape[0], n, k, matrix.device)


def scan_topk_int8t_plain(m8t, scales, source_ids, qi8, qscale, allowed, k: int, n_sweep: int = 0):
    """Plain PyTorch version of K7 and K8: ``scan_topk_int8_plain`` over the
    transposed (D, N) matrix."""
    n = _sweep_n(m8t.shape[1], n_sweep)
    m, s, src = m8t[:, :n], scales[:n], source_ids[:n]
    allowed = allowed.to(src.device)
    return _plain_in_chunks(
        lambda lo, hi: mask_scores(scores_int8t(m, s, qi8[lo:hi], qscale[lo:hi]), src, allowed),
        qi8.shape[0], n, k, m8t.device)


def scan_topk_int4_plain(packed, scales, source_ids, qi8, qscale, allowed, k: int, n_sweep: int = 0):
    """Plain PyTorch version of K9 (flat and slab): ``scan_topk_int8_plain``
    over the packed (D/2, N) int4 matrix.  Row chunks of the sweep unpack
    one at a time (unpacked to f32, a 25M x 384 matrix would take 38.7 GB),
    each is selected, and the chunks' top k merge by the same keys."""
    n = _sweep_n(packed.shape[1], n_sweep)
    d = 2 * packed.shape[0]
    step = max(4096, _PLAIN_BYTES // (24 * d))  # the unpack's int32 temporaries
    allowed = allowed.to(source_ids.device)
    vals = rows = None
    for lo in range(0, max(n, 1), step):
        hi = min(n, lo + step)
        m = unpack_int4(packed[:, lo:hi]).float()
        s, src = scales[lo:hi], source_ids[lo:hi]
        v, r = _plain_in_chunks(
            lambda a, b: mask_scores(int8_dots(qi8[a:b], m) * s[None, :] * qscale[a:b], src, allowed),
            qi8.shape[0], hi - lo, k, packed.device)
        r = torch.where(r >= 0, r + lo, r)
        if vals is None:
            vals, rows = v, r
        else:
            vals, rows = _merge_topk(torch.cat([vals, v], 1), torch.cat([rows, r], 1), k)
    return vals, rows


# -- kernel wrappers -----------------------------------------------------------


def _check_args(n: int, d: int, source_ids, q, allowed, k: int) -> None:
    if q.dim() != 2 or q.shape[1] != d:
        raise ValueError(f"queries must be (Q, {d}), got {tuple(q.shape)}")
    if source_ids.shape != (n,) or source_ids.dtype != torch.int32:
        raise ValueError("source_ids must be (N,) int32")
    if allowed.dim() != 1 or not 1 <= allowed.shape[0] <= MAX_FILTER or allowed.dtype != torch.int32:
        raise ValueError(f"allowed must be (F,) int32 with 1 <= F <= {MAX_FILTER}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")


def _check(matrix, source_ids, q, allowed, k: int, dtypes) -> None:
    if matrix.dtype not in dtypes:
        raise TypeError(f"the matrix must be one of {dtypes}, got {matrix.dtype}")
    if matrix.dim() != 2:
        raise ValueError(f"the matrix must be (N, D), got {tuple(matrix.shape)}")
    _check_args(matrix.shape[0], matrix.shape[1], source_ids, q, allowed, k)


def _check_cols(mat, scales, source_ids, q, allowed, k: int, dtype, dims_per_row: int) -> None:
    """``_check`` for the column-major matrices: the int2 tier's (D, N)
    int8 companion (``dims_per_row`` 1) and the packed (D/2, N) int4 matrix
    (2); the capacity N is a multiple of 4 (the kernels read 4 rows a
    word)."""
    if mat.dtype != dtype or mat.dim() != 2 or mat.shape[1] % 4:
        raise ValueError(f"the matrix must be (D/{dims_per_row}, N) {dtype} with N a multiple of 4, got "
                         f"{tuple(mat.shape)} {mat.dtype}")
    _check_args(mat.shape[1], dims_per_row * mat.shape[0], source_ids, q, allowed, k)
    if scales.shape != (mat.shape[1],) or scales.dtype != torch.float32:
        raise ValueError("scales must be (N,) float32")


def _check_qi8(qi8, qscale) -> None:
    if qi8.dtype != torch.int8 or qscale.shape != (qi8.shape[0], 1) or qscale.dtype != torch.float32:
        raise ValueError("queries must be (Q, D) int8 with (Q, 1) float32 scales")


def _check_int8(matrix, scales, qi8, qscale) -> None:
    if scales.shape != (matrix.shape[0],) or scales.dtype != torch.float32:
        raise ValueError("scales must be (N,) float32")
    _check_qi8(qi8, qscale)


def _arg(t):
    return t.data_ptr() if isinstance(t, torch.Tensor) else t


def query_chunks(nq: int, ws_bytes, q_align: int, budget: int) -> list[tuple[int, int]]:
    """[start, end) query chunks of at most MAX_QUERY_SLAB queries whose
    workspace ``ws_bytes(n)`` stays within ``budget``: one chunk where the
    whole sweep's fits, else the budget over one query's bytes (which no
    larger launch exceeds per query), rounded down to a multiple of
    ``q_align`` where it holds one."""
    chunk = min(MAX_QUERY_SLAB, max(nq, 1))
    if ws_bytes(chunk) > budget:
        chunk = max(1, min(chunk, budget // ws_bytes(1)))
        if chunk >= q_align:
            chunk -= chunk % q_align
    return [(s, min(nq, s + chunk)) for s in range(0, nq, chunk)]


# The launch plans of K1-K4, K7, K8 and K9 (csrc/hopper_common.cuh,
# kSortK and kSortCap): rows a tile; each (query, range) keeps a running
# list in the workspace at every k, of 64 keys (compacted by a sort) up to
# k = 32 and of 2k keys past it
SLAB_BF16_ROWS = 128
SLAB_BF16_SORT_K = 32
SLAB_BF16_SORT_CAP = 64
# K1 and K3 score sweeps of up to this many queries on the CUDA cores (and
# every f32 sweep, and every sweep whose d is no multiple of the tensor
# cores' box), by operand; wider sweeps take K2's or K4's tensor-core pass
# 1.  Measured on an H100 80GB HBM3 at 700 W (`chip_smoke.py --ladder`,
# PERF.md section 6); int8 at k = 128 over 2,064,384 rows: the CUDA cores
# win up to 64 queries (2.52 against 2.64 ms at 64), the tensor cores from
# 96 (2.91 against 3.47)
FLAT_ROWS_CORE_QUERIES = {"bf16": 8, "int8": 64}
# K7 and K9 flat score sweeps of up to this many queries on the CUDA cores
# (and every sweep whose d is no multiple of 128), by decode (the int4
# decode costs more CUDA-core operations a byte); wider sweeps take K8's
# and K9 slab's tensor-core pass 1.  Measured for each decode on an H100
# 80GB HBM3 at 700 W (`chip_smoke.py --ladder`, PERF.md section 6): at 16
# queries the CUDA cores win (K7 1.63 against 2.02 ms, K9 flat 1.85
# against 2.42), at 32 the tensor cores (2.41 against 2.70, 2.72 against
# 2.95)
FLAT_COLS_CORE_QUERIES = {"int8": 16, "int4": 16}
# list_pass2 (csrc/hopper_common.cuh) stages a query's ranges x cap keys in
# shared memory beside its sort buffer where they fit in a block's
# 232,448 bytes with its select scratch (1,040) and 1,024 to spare; past
# that K7 and K9 flat take the multi-block select, whose scratch is a
# 32-byte state, a 2,048-bin histogram and k keys (rounded up to 32) a query
_SMEM_MAX = 232_448
_SELECT_SCRATCH = 1_040
_KEYS_BINS = 2048


def _pow2_at_least(k: int) -> int:
    return 1 << max(0, k - 1).bit_length()


def list_pass2_staged(ncand: int, k: int) -> bool:
    """Whether list_pass2 stages a query's ``ncand`` keys in shared memory
    at depth k (csrc/hopper_common.cuh ``launch_list_pass2``)."""
    sort_n = _pow2_at_least(k)
    return (((sort_n + 1) & ~1) + ncand) * 8 + _SELECT_SCRATCH + 1024 <= _SMEM_MAX


def keys_select_bytes(nq: int, k: int) -> int:
    """Scratch of the multi-block select for nq queries at depth k
    (csrc/hopper_common.cuh ``keys_select_bytes``)."""
    return nq * (32 + _KEYS_BINS * 4 + -(-k // 32) * 32 * 8)


def _list_cap(k: int) -> int:
    """A (query, range) list's capacity at depth k."""
    return SLAB_BF16_SORT_CAP if k <= SLAB_BF16_SORT_K else -(-2 * k // 32) * 32


def _list_plan(nq: int, qt: int, n_sweep: int, k: int, blocks: int, span: int = 4, most: int = 65_535):
    """(workspace bytes, (qt, row ranges, rows a range, list capacity)) of
    a list-keeping launch of nq queries, qt a block: (query tiles) x
    (ranges) comes to about ``blocks``, at most ``most`` ranges, each range
    at least one row tile and, past k = 32, at least ``span`` x k rows (at
    4k its list of 2k keys compacts rarely and a one-block pass 2 has few
    keys to read; at 2k a list holds no more keys than its range has rows).
    Each (query, range) leaves ``cap`` keys for pass 2."""
    cap = _list_cap(k)
    qtiles = -(-nq // qt)
    tiles = -(-n_sweep // SLAB_BF16_ROWS)
    ranges = min(most, max(1, blocks // qtiles))
    if k > SLAB_BF16_SORT_K:
        ranges = min(ranges, max(1, n_sweep // (span * k)))
    ranges = min(ranges, tiles)
    per = -(-tiles // ranges)
    ranges = -(-tiles // per)
    return nq * ranges * cap * 8, (qt, ranges, per * SLAB_BF16_ROWS, cap)


def slab_bf16_plan(nq: int, d: int, n_sweep: int, k: int, sms: int):
    """K2's launch of nq queries: (workspace bytes, (queries a block, row
    ranges, rows a range, list capacity)).  A block holds 128 queries (two
    warpgroups) up to d = 384 and 64 past it, so the query tile fits in
    shared memory beside the ring; about one block per SM."""
    return _list_plan(nq, 128 if d <= 384 else 64, n_sweep, k, sms)


def _with_pass2(nq: int, k: int, plan):
    """A list plan with its pass 2: the multi-block select (``multi``, its
    scratch after the lists) where a query's ranges x cap keys pass what
    list_pass2 stages."""
    ws, (qt, ranges, per, cap) = plan
    multi = not list_pass2_staged(ranges * cap, k)
    if multi:
        ws += keys_select_bytes(nq, k)
    return ws, (qt, ranges, per, cap, int(multi))


def flat_rows_plan(nq: int, d: int, n_sweep: int, k: int, sms: int, operand: str):
    """The launch of K1 (``operand`` "bf16" or "f32") or K3 ("int8") for nq
    < 256 queries: (workspace bytes, (queries a block, row ranges, rows a
    range, list capacity, multi)).  Up to FLAT_ROWS_CORE_QUERIES[operand]
    queries (at f32, and where d is no multiple of the tensor cores' box,
    64 dims at bf16 and 128 at int8, always) the power of two at or above
    nq, at most 16, on the CUDA cores, two blocks an SM; past that K2's or
    K4's tensor-core pass 1 with a tile of 64 queries (128 past 64, at bf16
    only where d <= 384, as K2), one block an SM, so a sweep of up to 64
    queries reads each row once.  Past k = 32 a range holds at least 4k rows
    at bf16 and f32 and 2k at int8 (as K7's); the ranges are cut so that
    the lists and the multi-block select's scratch fit _WORKSPACE_BYTES,
    so any sweep (255 queries at k = 8,192 too) is one launch.  Pass 2 as
    in ``flat_cols_plan``.  The workspace does not grow with the rows."""
    box, span = (128, 2) if operand == "int8" else (64, 4)
    most = max(1, (_WORKSPACE_BYTES - keys_select_bytes(nq, k)) // (nq * _list_cap(k) * 8))
    if operand == "f32" or nq <= FLAT_ROWS_CORE_QUERIES[operand] or d % box:
        plan = _list_plan(nq, min(16, _pow2_at_least(nq)), n_sweep, k, 2 * sms, span, most)
    else:
        wide = 64 if nq <= 64 or (operand == "bf16" and d > 384) else 128
        plan = _list_plan(nq, wide, n_sweep, k, sms, span, most)
    return _with_pass2(nq, k, plan)


def slab_s8_plan(nq: int, d: int, n_sweep: int, k: int, sms: int):
    """The launch of the int8-operand batch scans, K4, K8 and K9's slab
    kernel, as ``slab_bf16_plan``: a block holds 128 queries at every d (an
    int8 query tile takes half a bf16 one); no launch dimension grows with
    the rows.  At Q = 2,048 and k = 256 the workspace is ~67 MB at any row
    count, so a sweep is one launch within _WORKSPACE_BYTES."""
    return _list_plan(nq, 128, n_sweep, k, sms)


def flat_cols_plan(nq: int, d: int, n_sweep: int, k: int, sms: int, int4: bool):
    """The launch of K7 (int8 (D, N) companion) or K9 flat (``int4``:
    packed (D/2, N)) for nq < 256 queries: (workspace bytes, (queries a
    block, row ranges, rows a range, list capacity, multi)).  Up to
    FLAT_COLS_CORE_QUERIES[decode] queries (and wherever d is no multiple of
    128) the power of two at or above nq, at most 16, on the CUDA cores, two
    blocks an SM; past that K8's and K9 slab's tensor-core pass 1 with a
    tile of 64 queries (128 past 64), one block an SM.  Past k = 32 a range
    holds at least 2k rows, no fewer than its list's keys; where a query's
    ranges x cap keys pass what list_pass2 stages, pass 2 is the
    multi-block select (``multi``), whose scratch follows the lists.  The
    workspace, nq x ranges x cap x 8 bytes and that scratch, does not grow
    with the rows."""
    if nq <= FLAT_COLS_CORE_QUERIES["int4" if int4 else "int8"] or d % 128:
        plan = _list_plan(nq, min(16, _pow2_at_least(nq)), n_sweep, k, 2 * sms, 2)
    else:
        plan = _list_plan(nq, 64 if nq <= 64 else 128, n_sweep, k, sms, 2)
    return _with_pass2(nq, k, plan)


@functools.lru_cache(maxsize=None)
def _sm_count_of(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sm_count(dev) -> int:
    return _sm_count_of(dev.index if dev.index is not None else torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _kernel_limits() -> tuple[int, int]:
    """The scan kernels' largest k and dim (csrc/topk_common.cuh)."""
    lib = _cuda.library()
    return lib.perceive_scan_topk_max_k(), lib.perceive_scan_topk_max_dim()


def _launch(entry: str, what: str, matrix, source_ids, q, allowed, k: int, n_sweep: int,
            lead: tuple, per_query: tuple, q_align: int, row_align: int, plan):
    """Shared body of the CUDA wrappers: check placement and shapes, size
    the workspace within _WORKSPACE_BYTES, and call the C entry ``entry``
    once per query chunk as
    ``entry(*lead, source_ids, q, *per_query, allowed, ..., k, *extra, ...)``;
    ``lead`` and ``per_query`` hold tensors, ints or None (a null pointer),
    and the tensors of ``per_query`` are cut into the same query chunks as
    ``q``.  ``plan(n, d, n_sweep, k)`` gives a launch of n queries its
    workspace bytes and ``extra`` ints.  Returns (vals, rows, launches)."""
    dev = matrix.device
    tensors = [("source_ids", source_ids), ("q", q), ("allowed", allowed)]
    tensors += [("argument", t) for t in (*lead, *per_query) if isinstance(t, torch.Tensor)]
    for name, t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: {name} on {t.device}, matrix on {dev}")
    lib = _cuda.library()
    max_k, max_dim = _kernel_limits()
    n, d = source_ids.shape[0], q.shape[1]  # (N, D) matrices and (D, N) alike
    if k > max_k:
        raise ValueError(f"k={k} exceeds the kernel's {max_k}")
    row_bytes = d * matrix.element_size()
    if row_bytes % row_align or d > max_dim:
        raise ValueError(f"{what}: rows of {row_bytes} bytes must be a multiple of {row_align} "
                         f"and dim <= {max_dim}")
    if not (matrix.is_contiguous() and source_ids.is_contiguous()) or matrix.data_ptr() % 16:
        raise ValueError(f"{what} needs a contiguous, 16-byte aligned matrix")
    nq = q.shape[0]
    out = torch.empty((2, nq, k), dtype=torch.int32, device=dev)  # one allocation for both results
    vals, rows = out[0].view(torch.float32), out[1]
    ns = _sweep_n(n, n_sweep)
    if nq == 0:
        return vals, rows, 0
    if ns == 0:  # an empty matrix matches nothing
        return vals.fill_(float("-inf")), rows.fill_(-1), 0
    q = q.contiguous()
    per_query = tuple(t.contiguous() if isinstance(t, torch.Tensor) else t for t in per_query)
    allowed = allowed.contiguous()
    chunks = query_chunks(nq, lambda n: plan(n, d, ns, k)[0], q_align, _WORKSPACE_BYTES)
    plans = [plan(e - s, d, ns, k) for s, e in chunks]
    ws = torch.empty(max(p[0] for p in plans), dtype=torch.uint8, device=dev)
    stream = _cuda.stream_of(matrix)
    fn = getattr(lib, entry)
    launches = 0
    for (s, e), (_, extra) in zip(chunks, plans):
        code = fn(*map(_arg, lead), source_ids.data_ptr(), q[s:e].data_ptr(),
                  *(_arg(t[s:e] if isinstance(t, torch.Tensor) else t) for t in per_query),
                  allowed.data_ptr(), allowed.shape[0], e - s, d, ns, k, *extra,
                  vals[s:].data_ptr(), rows[s:].data_ptr(), ws.data_ptr(), stream)
        _cuda.check(code, what)
        launches += 1
    return vals, rows, launches


def _device_of(matrix, what: str) -> str:
    if matrix.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{what}: no kernel for device {matrix.device}")
    return matrix.device.type


def scan_topk_flat(matrix, source_ids, q, allowed, k: int, n_sweep: int = 0):
    """K1: exact top-k of ``q @ matrix.T`` over a bf16 or f32 matrix, any Q:
    persistent blocks over row ranges (TMA ring, running thresholds), CUDA
    cores or tensor cores by width (``flat_rows_plan``)."""
    global LAUNCHES
    _check(matrix, source_ids, q, allowed, k, (torch.bfloat16, torch.float32))
    if _device_of(matrix, "scan_topk_flat") == "cpu":
        return scan_topk_plain(matrix, source_ids, q, allowed, k, n_sweep)
    operand = "f32" if matrix.dtype == torch.float32 else "bf16"
    vals, rows, n = _launch("perceive_scan_flat_rows", "scan_topk_flat", matrix, source_ids,
                            q.to(matrix.dtype), allowed, k, n_sweep, (matrix, 0 if operand == "f32" else 1, None),
                            (None,), 1, 16,
                            lambda n, d, ns, kk: flat_rows_plan(n, d, ns, kk, _sm_count(matrix.device), operand))
    LAUNCHES += n
    return vals, rows


def scan_topk_slab(matrix, source_ids, q, allowed, k: int, n_sweep: int = 0):
    """K2: the same function as K1 for batches, over a bf16 matrix: about
    one block per SM walks a row range for a resident query tile (wgmma,
    TMA), keeping each query's running top k behind a threshold."""
    global LAUNCHES_SLAB
    _check(matrix, source_ids, q, allowed, k, (torch.bfloat16,))
    if _device_of(matrix, "scan_topk_slab") == "cpu":
        return scan_topk_plain(matrix, source_ids, q, allowed, k, n_sweep)
    vals, rows, n = _launch("perceive_scan_slab_bf16", "scan_topk_slab", matrix, source_ids,
                            q.to(torch.bfloat16), allowed, k, n_sweep,
                            (matrix,), (), SLAB_QUERIES, 128,
                            lambda n, d, ns, kk: slab_bf16_plan(n, d, ns, kk, _sm_count(matrix.device)))
    LAUNCHES_SLAB += n
    return vals, rows


def scan_topk_int8_flat(matrix, scales, source_ids, qi8, qscale, allowed, k: int, n_sweep: int = 0):
    """K3: exact top-k of int8 scores (see ``scores_int8``), any Q: K1's
    kernel with int8 operands (``dp4a`` on the CUDA cores, K4's ``wgmma``
    pass 1 past the crossover; ``flat_rows_plan``)."""
    global LAUNCHES_INT8
    _check(matrix, source_ids, qi8, allowed, k, (torch.int8,))
    _check_int8(matrix, scales, qi8, qscale)
    if _device_of(matrix, "scan_topk_int8_flat") == "cpu":
        return scan_topk_int8_plain(matrix, scales, source_ids, qi8, qscale, allowed, k, n_sweep)
    vals, rows, n = _launch("perceive_scan_flat_rows", "scan_topk_int8_flat", matrix, source_ids,
                            qi8, allowed, k, n_sweep, (matrix, 2, scales.contiguous()), (qscale,), 1, 16,
                            lambda n, d, ns, kk: flat_rows_plan(n, d, ns, kk, _sm_count(matrix.device), "int8"))
    LAUNCHES_INT8 += n
    return vals, rows


def scan_topk_int8_slab(matrix, scales, source_ids, qi8, qscale, allowed, k: int, n_sweep: int = 0):
    """K4: K3 for batches, K2's kernel with int8 operands: about one block
    per SM walks a row range for a resident tile of 128 queries (TMA boxes
    straight into wgmma, running thresholds; ``slab_s8_plan``)."""
    global LAUNCHES_INT8_SLAB
    _check(matrix, source_ids, qi8, allowed, k, (torch.int8,))
    _check_int8(matrix, scales, qi8, qscale)
    if _device_of(matrix, "scan_topk_int8_slab") == "cpu":
        return scan_topk_int8_plain(matrix, scales, source_ids, qi8, qscale, allowed, k, n_sweep)
    vals, rows, n = _launch("perceive_scan_topk_slab", "scan_topk_int8_slab", matrix, source_ids,
                            qi8, allowed, k, n_sweep, (matrix, scales), (qscale,), SLAB_QUERIES, 128,
                            lambda n, d, ns, kk: slab_s8_plan(n, d, ns, kk, _sm_count(matrix.device)))
    LAUNCHES_INT8_SLAB += n
    return vals, rows


def _cols_scan(what: str, entry: str, int4: bool, mat, scales, source_ids, qi8, qscale, allowed, k: int,
               n_sweep: int, q_align: int, row_align: int, plan) -> tuple:
    """Shared body of the K7, K8 and K9 wrappers over a column-major matrix
    (int8 (D, N), or packed int4 (D/2, N) where ``int4``): check, then the
    plain version for a CPU matrix, else the kernel (``_launch``: TMA's
    column rule, ``_check_tma_cols``, then the C entry with the launch plan
    ``plan(n, d, n_sweep, k)``).  Returns (vals, rows, launches)."""
    _check_cols(mat, scales, source_ids, qi8, allowed, k, torch.uint8 if int4 else torch.int8, 2 if int4 else 1)
    _check_qi8(qi8, qscale)
    if _device_of(mat, what) == "cpu":
        plain = scan_topk_int4_plain if int4 else scan_topk_int8t_plain
        return (*plain(mat, scales, source_ids, qi8, qscale, allowed, k, n_sweep), 0)
    _check_tma_cols(mat, what)
    return _launch(entry, what, mat, source_ids, qi8, allowed, k, n_sweep, (mat, mat.shape[1], scales),
                   (qscale,), q_align, row_align, plan)


def _check_tma_cols(mat, what: str) -> None:
    """Every kernel over a column-major matrix (K7, K8, K9) reads it by TMA,
    whose strides are multiples of 16 bytes: on the card its N must be one.
    The matrices the package builds have capacities that are multiples of
    ROW_ALIGN = 512, so the main path passes no other."""
    if mat.device.type == "cuda" and mat.dim() == 2 and mat.shape[1] % 16:
        raise ValueError(f"{what}: N must be a multiple of 16, got {mat.shape[1]}")


def scan_topk_int8t_flat(m8t, scales, source_ids, qi8, qscale, allowed, k: int, n_sweep: int = 0):
    """K7: exact top-k of int8 scores over the transposed (D, N) companion
    of the int2 tier, any Q: persistent blocks over row ranges (TMA ring,
    running thresholds), CUDA cores or tensor cores by width
    (``flat_cols_plan``).  On the card N must be a multiple of 16
    (``_check_tma_cols``)."""
    global LAUNCHES_INT8T
    vals, rows, n = _cols_scan("scan_topk_int8t_flat", "perceive_scan_flat_int8t", False, m8t, scales, source_ids,
                               qi8, qscale, allowed, k, n_sweep, 1, 16,
                               lambda n, d, ns, kk: flat_cols_plan(n, d, ns, kk, _sm_count(m8t.device), False))
    LAUNCHES_INT8T += n
    return vals, rows


def scan_topk_int8t_slab(m8t, scales, source_ids, qi8, qscale, allowed, k: int, n_sweep: int = 0):
    """K8: K7 for batches, K9's slab kernel with a plain 4 x 4 byte
    transpose for its decode: about one block per SM walks a row range for
    a resident tile of 128 queries (``slab_s8_plan``)."""
    global LAUNCHES_INT8T_SLAB
    vals, rows, n = _cols_scan("scan_topk_int8t_slab", "perceive_scan_topk_int8t_slab", False, m8t, scales,
                               source_ids, qi8, qscale, allowed, k, n_sweep, SLAB_QUERIES, 128,
                               lambda n, d, ns, kk: slab_s8_plan(n, d, ns, kk, _sm_count(m8t.device)))
    LAUNCHES_INT8T_SLAB += n
    return vals, rows


def scan_topk_int4_flat(packed, scales, source_ids, qi8, qscale, allowed, k: int, n_sweep: int = 0):
    """K9, flat: exact top-k of int4 scores (see ``scores_int4``) over the
    packed (D/2, N) matrix, any Q: K7's kernel with a nibble decode
    (``flat_cols_plan``).  On the card N must be a multiple of 16
    (``_check_tma_cols``)."""
    global LAUNCHES_INT4
    vals, rows, n = _cols_scan("scan_topk_int4_flat", "perceive_scan_flat_int4", True, packed, scales, source_ids,
                               qi8, qscale, allowed, k, n_sweep, 1, 32,
                               lambda n, d, ns, kk: flat_cols_plan(n, d, ns, kk, _sm_count(packed.device), True))
    LAUNCHES_INT4 += n
    return vals, rows


def scan_topk_int4_slab(packed, scales, source_ids, qi8, qscale, allowed, k: int, n_sweep: int = 0):
    """K9, slab: the flat kernel's function for batches.  About one block
    per SM walks a row range for a resident tile of 128 queries: TMA ring
    of packed boxes, nibbles decoded into wgmma operands, running
    thresholds (``slab_s8_plan``).  N must be a multiple of 16
    (``_check_tma_cols``)."""
    global LAUNCHES_INT4_SLAB
    vals, rows, n = _cols_scan("scan_topk_int4_slab", "perceive_scan_slab_int4", True, packed, scales,
                               source_ids, qi8, qscale, allowed, k, n_sweep, SLAB_QUERIES, 128,
                               lambda n, d, ns, kk: slab_s8_plan(n, d, ns, kk, _sm_count(packed.device)))
    LAUNCHES_INT4_SLAB += n
    return vals, rows


# -- entry points ----------------------------------------------------------------


def _sweeps(q: torch.Tensor):
    """(offset, padded sweep) pairs: MAX_QUERY_SLAB chunks, each padded by
    ``_slab_pad``."""
    for s in range(0, max(q.shape[0], 1), MAX_QUERY_SLAB):
        part = q[s : s + MAX_QUERY_SLAB]
        pad = _slab_pad(part.shape[0])
        if pad:
            part = torch.nn.functional.pad(part, (0, 0, 0, pad))
        yield s, part


def _gather(nq: int, k: int, device, parts):
    if len(parts) == 1:
        _, v, r = parts[0]
        return v[:nq], r[:nq]
    vals = torch.empty((nq, k), dtype=torch.float32, device=device)
    rows = torch.empty((nq, k), dtype=torch.int32, device=device)
    for s, v, r in parts:
        e = min(nq, s + v.shape[0])
        vals[s:e], rows[s:e] = v[: e - s], r[: e - s]
    return vals, rows


def scan_topk(matrix, source_ids, q, allowed, k: int, n_sweep: int = 0):
    """Exact top-k of ``q @ matrix.T`` with row validity and source filter.

    matrix: (N, D) bf16 or f32; source_ids: (N,) int32; q: (Q, D) float;
    allowed: (F <= 16,) int32.  Returns ((Q, k) f32 scores, (Q, k) int32
    rows), sorted best first.  Routes each sweep to K2 or K1."""
    _check(matrix, source_ids, q, allowed, k, (torch.bfloat16, torch.float32))
    parts = []
    for s, part in _sweeps(q):
        slab = _is_slab(part.shape[0]) and matrix.dtype == torch.bfloat16
        fn = scan_topk_slab if slab else scan_topk_flat
        parts.append((s, *fn(matrix, source_ids, part, allowed, k, n_sweep)))
    return _gather(q.shape[0], k, matrix.device, parts)


def _scan_quantized(flat, slab, matrix, scales, source_ids, q, allowed, k: int, n_sweep: int):
    """Routing shared by the quantized entry points: each sweep's queries
    quantize (on their device), then take ``slab`` or ``flat``."""
    parts = []
    for s, part in _sweeps(q):
        qi8, qscale = quantize_queries(part)
        fn = slab if _is_slab(part.shape[0]) else flat
        parts.append((s, *fn(matrix, scales, source_ids, qi8, qscale, allowed, k, n_sweep)))
    return _gather(q.shape[0], k, matrix.device, parts)


def scan_topk_int8(matrix, scales, source_ids, q, allowed, k: int, n_sweep: int = 0):
    """Top-k of int8 scores of f32 queries (quantized here, on the
    queries' device) against an (N, D) int8 matrix with (N,) f32 row
    scales.  Approximate scores: the searcher reranks the candidates in
    f32.  Routes each sweep to K4 or K3."""
    _check(matrix, source_ids, q, allowed, k, (torch.int8,))
    return _scan_quantized(scan_topk_int8_flat, scan_topk_int8_slab, matrix, scales, source_ids, q, allowed,
                           k, n_sweep)


def scan_topk_int8t(m8t, scales, source_ids, q, allowed, k: int, n_sweep: int = 0):
    """``scan_topk_int8`` over the int2 tier's transposed (D, N) int8
    companion (the JAX ``scan_topk_pallas_int8t``).  Routes each sweep to
    K8 or K7."""
    _check_cols(m8t, scales, source_ids, q, allowed, k, torch.int8, 1)
    return _scan_quantized(scan_topk_int8t_flat, scan_topk_int8t_slab, m8t, scales, source_ids, q, allowed,
                           k, n_sweep)


def scan_topk_int4(packed, scales, source_ids, q, allowed, k: int, n_sweep: int = 0):
    """``scan_topk_int8`` over the packed (D/2, N) int4 matrix: the int4
    tier, and the int2 tier's int4 companion (the JAX
    ``scan_topk_pallas_int4``).  Routes each sweep to K9's slab or flat
    kernel."""
    _check_cols(packed, scales, source_ids, q, allowed, k, torch.uint8, 2)
    return _scan_quantized(scan_topk_int4_flat, scan_topk_int4_slab, packed, scales, source_ids, q, allowed,
                           k, n_sweep)
