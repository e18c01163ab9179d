"""Exact scan with top-k over the embedding matrix (the bf16/f32 tier).

Port of perceive_tpu/ops/topk.py's unquantized path (``scan_topk_pallas``
and its Pallas kernel ``pallas_topk_unsorted``).  ``scan_topk`` is the one
entry point: on a CUDA matrix it launches the hand-written kernel in
``csrc/scan_topk.cu``; on a CPU matrix it runs ``scan_topk_plain``, the same
function in plain PyTorch.  A CUDA launch that fails raises — nothing falls
back to the plain version.

Semantics, shared by both:
  * q is cast to the matrix dtype; dot products accumulate in f32;
  * rows whose source id is negative (tombstones, unallocated tail) or not
    in ``allowed`` are excluded; ``allowed[0] == ALLOW_ALL`` disables the
    source filter;
  * only the first ``n_sweep`` rows are read (0 = every row);
  * results are sorted best first; equal scores order by the lower row;
  * slots past the number of matching rows carry -inf and row -1.
"""

from __future__ import annotations

import torch

from . import _cuda

ALLOW_ALL = -2  # sentinel in allowed[0]: disable source filtering
MAX_FILTER = 16
# queries per kernel launch; larger batches run as consecutive launches
MAX_QUERY_SLAB = 2048
# workspace budget per launch (the kernel keeps up to min(k, 512)
# candidates per 512-row block and query); query slabs shrink to fit
_WORKSPACE_BYTES = 1 << 30

# kernel launches made by scan_topk (one per query slab)
LAUNCHES = 0


def _sweep_n(n: int, n_sweep: int) -> int:
    """Rows a sweep reads: the live prefix ``n_sweep``, or all rows when 0."""
    if not n_sweep or n_sweep >= n:
        return n
    return n_sweep


def mask_scores(scores: torch.Tensor, source_ids: torch.Tensor, allowed: torch.Tensor) -> torch.Tensor:
    """(Q, N) scores with excluded rows (source id < 0, or a source not
    in ``allowed`` unless ``allowed[0] == ALLOW_ALL``) forced to -inf."""
    keep = source_ids >= 0
    if int(allowed[0]) != ALLOW_ALL:
        keep &= torch.isin(source_ids, allowed)
    return scores.masked_fill(~keep[None, :], float("-inf"))


def scan_topk_plain(matrix, source_ids, q, allowed, k: int, n_sweep: int = 0):
    """Plain PyTorch version of the kernel (see module docstring)."""
    n = _sweep_n(matrix.shape[0], n_sweep)
    m, src = matrix[:n], source_ids[:n]
    qc = q.to(matrix.dtype).float()
    scores = mask_scores(qc @ m.float().T, src, allowed.to(src.device))
    # a stable sort keeps equal scores in row order: the lower row first
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    if vals.shape[1] < k:
        pad = k - vals.shape[1]
        vals = torch.nn.functional.pad(vals, (0, pad), value=float("-inf"))
        idx = torch.nn.functional.pad(idx, (0, pad), value=-1)
    rows = torch.where(torch.isfinite(vals), idx, torch.full_like(idx, -1))
    return vals, rows.to(torch.int32)


def _check(matrix, source_ids, q, allowed, k: int) -> None:
    if matrix.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"scan_topk takes a bfloat16 or float32 matrix, got {matrix.dtype}")
    if matrix.dim() != 2 or q.dim() != 2 or q.shape[1] != matrix.shape[1]:
        raise ValueError(f"shapes: matrix {tuple(matrix.shape)}, q {tuple(q.shape)}")
    if source_ids.shape != (matrix.shape[0],) or source_ids.dtype != torch.int32:
        raise ValueError("source_ids must be (N,) int32")
    if allowed.dim() != 1 or not 1 <= allowed.shape[0] <= MAX_FILTER or allowed.dtype != torch.int32:
        raise ValueError(f"allowed must be (F,) int32 with 1 <= F <= {MAX_FILTER}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")


def scan_topk(matrix, source_ids, q, allowed, k: int, n_sweep: int = 0):
    """Exact top-k of ``q @ matrix.T`` with row validity and source filter.

    matrix: (N, D) bf16 or f32; source_ids: (N,) int32; q: (Q, D) float;
    allowed: (F <= 16,) int32.  Returns ((Q, k) f32 scores, (Q, k) int32
    rows), sorted best first.  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    _check(matrix, source_ids, q, allowed, k)
    if matrix.device.type == "cpu":
        return scan_topk_plain(matrix, source_ids, q, allowed, k, n_sweep)
    if matrix.device.type != "cuda":
        raise RuntimeError(f"scan_topk: no kernel for device {matrix.device}")
    return _scan_topk_cuda(matrix, source_ids, q, allowed, k, n_sweep)


def _scan_topk_cuda(matrix, source_ids, q, allowed, k: int, n_sweep: int):
    global LAUNCHES
    dev = matrix.device
    for name, t in (("source_ids", source_ids), ("q", q), ("allowed", allowed)):
        if t.device != dev:
            raise ValueError(f"scan_topk: {name} on {t.device}, matrix on {dev}")
    lib = _cuda.library()
    n, d = matrix.shape
    if k > lib.perceive_scan_topk_max_k():
        raise ValueError(f"k={k} exceeds the kernel's {lib.perceive_scan_topk_max_k()}")
    vec = 16 // matrix.element_size()
    if d % vec or d > lib.perceive_scan_topk_max_dim():
        raise ValueError(f"dim {d} must be a multiple of {vec} and <= {lib.perceive_scan_topk_max_dim()}")
    if not (matrix.is_contiguous() and source_ids.is_contiguous()) or matrix.data_ptr() % 16:
        raise ValueError("scan_topk needs a contiguous, 16-byte aligned matrix")
    nq = q.shape[0]
    vals = torch.empty((nq, k), dtype=torch.float32, device=dev)
    rows = torch.empty((nq, k), dtype=torch.int32, device=dev)
    ns = _sweep_n(n, n_sweep)
    if nq == 0:
        return vals, rows
    if ns == 0:  # an empty matrix matches nothing
        return vals.fill_(float("-inf")), rows.fill_(-1)
    qc = q.to(matrix.dtype).contiguous()
    allowed = allowed.contiguous()
    per_query = lib.perceive_scan_topk_workspace(1, ns, k)
    slab = max(1, min(MAX_QUERY_SLAB, _WORKSPACE_BYTES // per_query))
    ws = torch.empty(min(slab, nq) * per_query, dtype=torch.uint8, device=dev)
    dtype_code = 1 if matrix.dtype == torch.bfloat16 else 0
    stream = _cuda.stream_of(matrix)
    for s in range(0, nq, slab):
        qs = qc[s : s + slab]
        code = lib.perceive_scan_topk(
            matrix.data_ptr(), dtype_code, source_ids.data_ptr(), qs.data_ptr(),
            allowed.data_ptr(), allowed.shape[0], qs.shape[0], d, ns, k,
            vals[s:].data_ptr(), rows[s:].data_ptr(), ws.data_ptr(), stream,
        )
        _cuda.check(code, "scan_topk")
        LAUNCHES += 1
    return vals, rows
