"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):
  1. environment: CUDA present, card name and power limit, versions;
  2. build the CUDA kernels from perceive_tpu_torch/csrc;
  3. K1 and K2 (bf16 scan + top-k, flat and slab) against their plain
     version at 1M x 384 bf16;
  4. K3 and K4 (int8 scan + top-k, flat and slab) against their plain
     version, bit for bit, at 2M x 384 int8;
  5. K11 (attention) against its plain version at the encoder's long buckets;
  6. the bf16 slice: an all-MiniLM-L6-v2-width model with seeded random
     weights embeds a generated corpus into SQLite (filled to 1M rows),
     AppState builds the searcher on the card, and 16 queries run through
     the CLI;
  7. the bf16 batch path: 1,024 vector queries from 16 threads through a
     BatchingSearchExecutor, then search_vectors_batch on 2,048 queries
     (half near a stored window, half random) and on 2,048 random ones;
  8. the int8 slice: 1M more filler rows (2M in all), a fresh AppState whose
     auto rule picks the int8 tier, the same 16 queries through the CLI,
     hits held against an exact f32 top-10 over the host mirror;
  9. the int8 batch path, as phase 7;
 10. K5 (int2 coarse scores), K6 (exact top-kc select), K7 and K8 (int8
     scans over the transposed companion) against their plain versions, bit
     for bit, at the int2 slice's shape (4,194,304 x 384);
 11. the int2 slice: 2,194,304 more filler rows (4,194,304 in all), a fresh
     AppState whose auto rule picks the int2 tier (coarse pass + int8
     companion), its self-audit's verdict, the same 16 queries through the
     CLI, the composed device pipeline held against the composed plain one
     for every query, hits against an exact f32 top-10
     (``served_recall_at_10``), the fine phase's gather and dot timed;
 12. the int2 batch path, as phase 7.
Each kernel is timed beside its plain version, one PyTorch call for the same
function (``library_ms``: a yardstick the port never calls; null where no
single call computes it) and its bound.
The second-to-last line is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "scan_topk": ("perceive_tpu_torch/csrc/scan_topk.cu", "perceive_tpu/ops/topk.py:966"),
    "scan_slab": ("perceive_tpu_torch/csrc/scan_slab.cu", "perceive_tpu/ops/topk.py:927"),
    "scan_int8": ("perceive_tpu_torch/csrc/scan_topk.cu", "perceive_tpu/ops/topk.py:273"),
    "scan_int8_slab": ("perceive_tpu_torch/csrc/scan_slab.cu", "perceive_tpu/ops/topk.py:234"),
    "attention": ("perceive_tpu_torch/csrc/attention.cu", "perceive_tpu/ops/attention.py:58"),
    "int2_scores": ("perceive_tpu_torch/csrc/scan_int2.cu", "perceive_tpu/ops/topk.py:1222"),
    "select_topk": ("perceive_tpu_torch/csrc/select_topk.cu", "perceive_tpu/ops/topk.py:1748"),
    "scan_int8t": ("perceive_tpu_torch/csrc/scan_topk.cu", "perceive_tpu/ops/topk.py:753"),
    "scan_int8t_slab": ("perceive_tpu_torch/csrc/scan_slab.cu", "perceive_tpu/ops/topk.py:835"),
}
# the H100 SXM data sheet: device memory rate and dense tensor-core peaks
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12}
DIM = 384
KS = (16, 64, 128, 1024, 8192)
BF16_KB = 32  # the bf16 slice's sweep depth: k=10, doubled for chunk dedupe
INT8_KB = 128  # the int8 slice's: k=10, x4 over-fetch, doubled for chunk dedupe
INT2_KCS = (1024, 4096)  # coarse depths: the audit's shallowest, and the default
SCAN_TOL = 1e-4  # bf16 scans: f32 sums of bf16 products in another order


def log(msg: str) -> None:
    print(msg, flush=True)


def launch_counts() -> dict:
    """Every kernel wrapper's launch count."""
    from perceive_tpu_torch.ops import attention as attn
    from perceive_tpu_torch.ops import int2, topk

    return {**topk.launch_counts(), **int2.launch_counts(), "attention": attn.LAUNCHES}


def reset_launch_counts() -> None:
    from perceive_tpu_torch.ops import attention as attn
    from perceive_tpu_torch.ops import int2, topk

    topk.reset_launch_counts()
    int2.reset_launch_counts()
    attn.LAUNCHES = 0


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    log(f"== {name}")
    yield
    log(f"== {name}: {time.perf_counter() - t0:.1f} s")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps: int = 20, warmup: int = 1) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs (3 when one run
    takes over 100 ms), timed with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    while len(times) < (reps if not times or times[0] < 100 else 3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(n_bytes: float, ops: float, kind: str) -> tuple[float, str]:
    """The least milliseconds the card could take: the larger of the bytes
    over the memory rate and the operations over the peak for their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scan_bound(live: int, n_sweep: int, nq: int, k: int, elem: int, kind: str):
    """Bound of a scan with top-k: each live row read once (with its scale at
    int8), every source id once, the queries once, the (Q, k) result written
    once; 2 * D operations per live row and query."""
    scale = 4 * live if kind == "int8" else 0
    n_bytes = live * DIM * elem + scale + 4 * n_sweep + nq * DIM * elem + nq * k * 8
    return bound(n_bytes, 2.0 * nq * live * DIM, kind)


# -- phase 1-2 -------------------------------------------------------------


def environment():
    import torch

    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is False")
        sys.exit(1)
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.pop("PERCEIVE_TPU_MATRIX_DTYPE", None)  # the auto tier rule decides
    log(card)  # name, power limit: as nvidia-smi prints them
    log(f"torch {torch.__version__}  cuda {torch.version.cuda}  python {sys.version.split()[0]}")
    return card


def build_kernels(card: str) -> None:
    from perceive_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    _cuda.library()
    log(f"kernel build+load {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_cuda.build_seconds} s)  [{card}]")
    if _cuda.build_log is not None:
        for line in _cuda.build_log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log("  ptxas: " + line.strip())


# -- phases 3-4: the scans ----------------------------------------------------


def compare_topk(vk, rk, vp, rp, tol: float):
    """(max abs score error, rows outside the tie band) between a kernel's
    and a plain top-k.  Rows may differ only where the plain score lies
    within 2 * tol of a neighbour's or within tol of the last matching
    score; past the matching rows both must read (-inf, -1)."""
    import torch

    fin_k, fin_p = torch.isfinite(vk), torch.isfinite(vp)
    if not torch.equal(fin_k, fin_p):
        return math.inf, -1
    err = float((vk - vp).abs().masked_fill(~fin_p, 0.0).max()) if vp.numel() else 0.0
    gap = (vp[:, 1:] - vp[:, :-1]).abs() <= 2 * tol
    near = torch.nn.functional.pad(gap, (1, 0)) | torch.nn.functional.pad(gap, (0, 1))
    last = (fin_p.sum(dim=1, keepdim=True) - 1).clamp(min=0)
    near |= (vp - vp.gather(1, last)).abs() <= tol
    bad = int(((rk != rp) & fin_p & ~near).sum()) + int(((rk != -1) & ~fin_p).sum())
    return err, bad


def filters(dev) -> dict:
    import torch

    from perceive_tpu_torch.ops import topk

    no_filter = torch.full((16,), -9, dtype=torch.int32, device=dev)
    no_filter[0] = topk.ALLOW_ALL
    two = torch.full((16,), -9, dtype=torch.int32, device=dev)
    two[0], two[1] = 0, 2
    return {"all": no_filter, "2src": two}


def corpus_rows(g, dev, n: int, hwm: int):
    """Seeded unit rows in (n, DIM) f32 chunks, source ids in {0, 1, 2} with
    5% tombstones and an unallocated tail from ``hwm``, and the sweep prefix
    the matrix's ladder gives that high-water mark."""
    import torch

    from perceive_tpu_torch.index.matrix import sweep_rows_for

    def chunks():
        for lo in range(0, n, 131072):
            blk = torch.randn((min(131072, n - lo), DIM), generator=g, device=dev)
            yield lo, blk / blk.norm(dim=1, keepdim=True)

    src = torch.randint(0, 3, (n,), generator=g, device=dev, dtype=torch.int32)
    src[torch.rand((n,), generator=g, device=dev) < 0.05] = -1  # tombstones
    src[hwm:] = -1  # unallocated tail
    ns = sweep_rows_for(hwm, n)
    assert ns < n
    return chunks(), src, ns


def check_case(name: str, got, want, tol: float) -> float:
    err, bad = compare_topk(*got, *want, tol)
    exact = tol == 0.0
    ok = (torch_equal(got, want) if exact else err <= tol and bad == 0)
    log(f"{name} max_abs_err={err:.3g} rows_outside_ties={bad} "
        f"{'bit-exact ' if exact and ok else ''}{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{name.split()[0]} disagrees with its plain version ({name})")
    return err


def torch_equal(got, want) -> bool:
    import torch

    return torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def check_bf16_scans(card: str) -> dict:
    """K1 (flat) and K2 (slab) at 1,048,576 x 384 bf16."""
    import torch

    from perceive_tpu_torch.ops import topk

    dev = torch.device("cuda:0")
    n, hwm = 1_048_576, 950_000
    g = torch.Generator(device=dev).manual_seed(1)
    chunks, src, ns = corpus_rows(g, dev, n, hwm)
    m = torch.empty((n, DIM), dtype=torch.bfloat16, device=dev)
    for lo, blk in chunks:
        m[lo : lo + blk.shape[0]] = blk.to(torch.bfloat16)
    allowed = filters(dev)
    worst = {"K1": 0.0, "K2": 0.0}

    def queries(nq):
        q = torch.randn((nq, DIM), generator=g, device=dev)
        return q / q.norm(dim=1, keepdim=True)

    for kid, fn, widths in (("K1", topk.scan_topk_flat, (1, 8, 64, 512)),
                            ("K2", topk.scan_topk_slab, (256, 512, 2048))):
        ks = (16, 32, 1024, 8192) if kid == "K1" else KS  # 32: the bf16 slice's kb
        for nq in widths:
            q = queries(nq)
            for k in ks:
                for fname, al in allowed.items():
                    got = fn(m, src, q, al, k, ns)
                    want = topk.scan_topk_plain(m, src, q, al, k, ns)
                    err = check_case(f"{kid} Q={nq:<4d} k={k:<5d} filter={fname:<4s}", got, want, SCAN_TOL)
                    worst[kid] = max(worst[kid], err)
    before = topk.LAUNCHES_SLAB
    topk.scan_topk(m, src, queries(300), allowed["all"], 16, ns)  # padded to 384: K2's route
    if topk.LAUNCHES_SLAB != before + 1:
        raise SystemExit("scan_topk did not route a 300-query sweep to K2")

    # tie rule: duplicate rows must come out lower row first.  Small integer
    # entries keep every dot product exact, so equal rows score equal bits
    # in any summation order.
    base = torch.randint(-3, 4, (8, DIM), generator=g, device=dev).to(torch.bfloat16)
    tm = base.repeat(512, 1).contiguous()
    tsrc = torch.zeros((tm.shape[0],), dtype=torch.int32, device=dev)
    for kid, fn, nq in (("K1", topk.scan_topk_flat, 4), ("K2", topk.scan_topk_slab, 256)):
        tq = torch.randint(-3, 4, (nq, DIM), generator=g, device=dev).float()
        got = fn(tm, tsrc, tq, allowed["all"], 64)
        if not torch_equal(got, topk.scan_topk_plain(tm, tsrc, tq, allowed["all"], 64)):
            raise SystemExit(f"{kid} tie order differs from the plain version")
    log("K1, K2 tie rule: equal scores order by the lower row  ok")

    live = int((src[:ns] >= 0).sum())
    keep = src[:ns] >= 0
    mv = m[:ns]

    def library(q, k):  # bf16 matmul + masked_fill + topk
        return torch.topk(torch.matmul(q.to(torch.bfloat16), mv.T).masked_fill(~keep, float("-inf")), k)

    times = {}
    for kid, fn, nq, k in (("K1", topk.scan_topk_flat, 1, 16), ("K1", topk.scan_topk_flat, 64, 16),
                           ("K1", topk.scan_topk_flat, 1, BF16_KB), ("K1", topk.scan_topk_flat, 512, BF16_KB),
                           ("K2", topk.scan_topk_slab, 512, BF16_KB), ("K2", topk.scan_topk_slab, 2048, BF16_KB)):
        q = queries(nq)
        t = {"ms": cuda_ms(lambda: fn(m, src, q, allowed["all"], k, ns)),
             "plain_ms": cuda_ms(lambda: topk.scan_topk_plain(m, src, q, allowed["all"], k, ns)),
             "library_ms": cuda_ms(lambda: library(q, k))}
        t["bound_ms"], t["bound_by"] = scan_bound(live, ns, nq, k, 2, "bf16")
        times[(kid, nq, k)] = t
        log(f"{kid} time Q={nq} k={k} n_sweep={ns}: kernel {t['ms']:.4f} ms  plain {t['plain_ms']:.4f} ms  "
            f"library {t['library_ms']:.4f} ms  bound {t['bound_ms']:.4f} ms ({t['bound_by']})  [{card}]")
    del m, mv
    torch.cuda.empty_cache()
    return {"K1": {"max_abs_err": worst["K1"], **times[("K1", 1, BF16_KB)]},
            "K2": {"max_abs_err": worst["K2"], **times[("K2", 512, BF16_KB)]}}


def check_int8_scans(card: str) -> dict:
    """K3 (flat) and K4 (slab) at 2,097,152 x 384 int8, bit for bit."""
    import torch

    from perceive_tpu_torch.ops import topk

    dev = torch.device("cuda:0")
    n, hwm = 2_097_152, 1_900_000
    g = torch.Generator(device=dev).manual_seed(3)
    chunks, src, ns = corpus_rows(g, dev, n, hwm)
    m = torch.empty((n, DIM), dtype=torch.int8, device=dev)
    scales = torch.empty((n,), dtype=torch.float32, device=dev)
    for lo, blk in chunks:  # the matrix's per-row symmetric quantization
        s = torch.clamp(blk.abs().amax(dim=1), min=1e-12) / 127.0
        m[lo : lo + blk.shape[0]] = torch.clamp(torch.round(blk / s[:, None]), -127, 127).to(torch.int8)
        scales[lo : lo + blk.shape[0]] = s
    allowed = filters(dev)

    def queries(nq):
        return topk.quantize_queries(torch.randn((nq, DIM), generator=g, device=dev))

    for kid, fn, widths in (("K3", topk.scan_topk_int8_flat, (1, 8)),
                            ("K4", topk.scan_topk_int8_slab, (256, 512, 2048))):
        for nq in widths:
            qi8, qs = queries(nq)
            for k in KS:
                for fname, al in allowed.items():
                    got = fn(m, scales, src, qi8, qs, al, k, ns)
                    want = topk.scan_topk_int8_plain(m, scales, src, qi8, qs, al, k, ns)
                    check_case(f"{kid} Q={nq:<4d} k={k:<5d} filter={fname:<4s}", got, want, 0.0)
    before = topk.LAUNCHES_INT8_SLAB
    topk.scan_topk_int8(m, scales, src, torch.randn((300, DIM), generator=g, device=dev), allowed["all"], 16, ns)
    if topk.LAUNCHES_INT8_SLAB != before + 1:
        raise SystemExit("scan_topk_int8 did not route a 300-query sweep to K4")

    # ties: every row 8 times over, so equal scores are everywhere
    tn = 262_144
    tm, tsc, tsrc = m[: tn // 8].repeat(8, 1).contiguous(), scales[: tn // 8].repeat(8), src[: tn // 8].repeat(8)
    for kid, fn, nq in (("K3", topk.scan_topk_int8_flat, 8), ("K4", topk.scan_topk_int8_slab, 256)):
        qi8, qs = queries(nq)
        got = fn(tm, tsc, tsrc, qi8, qs, allowed["all"], 64)
        want = topk.scan_topk_int8_plain(tm, tsc, tsrc, qi8, qs, allowed["all"], 64)
        v, r = got
        same = (v[:, 1:] == v[:, :-1]) & torch.isfinite(v[:, 1:])
        if not (torch_equal(got, want) and bool(same.any()) and bool((r[:, 1:][same] > r[:, :-1][same]).all())):
            raise SystemExit(f"{kid} tie order differs from the plain version")
    log("K3, K4 duplicated rows: bit-exact, equal scores order by the lower row  ok")
    del tm, tsc, tsrc

    live = int((src[:ns] >= 0).sum())
    keep = src[:ns] >= 0
    mv, sv = m[:ns], scales[:ns]

    def library(qi8, qs, k):
        """torch._int_mm where its shape rules allow (more than 16 queries),
        else an f32 matmul of the int8 values (exact: sums below 2**24);
        then the scale products, masked_fill and topk."""
        if qi8.shape[0] > 16:
            dots = torch._int_mm(qi8, mv.T).float()
        else:
            dots = qi8.float() @ mv.float().T
        return torch.topk((dots * sv * qs).masked_fill(~keep, float("-inf")), k)

    times = {}
    for kid, fn, nq in (("K3", topk.scan_topk_int8_flat, 1), ("K3", topk.scan_topk_int8_flat, 512),
                        ("K4", topk.scan_topk_int8_slab, 512), ("K4", topk.scan_topk_int8_slab, 2048)):
        qi8, qs = queries(nq)
        k = INT8_KB
        t = {"ms": cuda_ms(lambda: fn(m, scales, src, qi8, qs, allowed["all"], k, ns)),
             "plain_ms": cuda_ms(lambda: topk.scan_topk_int8_plain(m, scales, src, qi8, qs, allowed["all"], k, ns))}
        t["library_ms"] = cuda_ms(lambda: library(qi8, qs, k)) if nq <= 512 else None
        t["bound_ms"], t["bound_by"] = scan_bound(live, ns, nq, k, 1, "int8")
        times[(kid, nq)] = t
        lib = "not timed (its (Q, N) int32 product would take 16 GB)" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
        log(f"{kid} time Q={nq} k={k} n_sweep={ns}: kernel {t['ms']:.4f} ms  plain {t['plain_ms']:.4f} ms  "
            f"library {lib}  bound {t['bound_ms']:.4f} ms ({t['bound_by']})  [{card}]")
    del m, mv, scales
    torch.cuda.empty_cache()
    return {"K3": {"max_abs_err": 0.0, **times[("K3", 1)]}, "K4": {"max_abs_err": 0.0, **times[("K4", 512)]}}


def int2_corpus(g, dev, n: int, hwm: int):
    """Seeded unit rows as the int2 tier stores them, built on the card: the
    (DIM/4, n) packed coarse matrix with its row scales (crumbs of the
    rows on the {-3, -1, 1, 3} * rms/2 grid) and the (DIM, n) int8
    companion with its scales; source ids and the sweep prefix as
    corpus_rows gives them."""
    import torch

    chunks, src, ns = corpus_rows(g, dev, n, hwm)
    d4 = DIM // 4
    packed = torch.empty((d4, n), dtype=torch.uint8, device=dev)
    fine = torch.empty((DIM, n), dtype=torch.int8, device=dev)
    s2 = torch.empty((n,), dtype=torch.float32, device=dev)
    s8 = torch.empty((n,), dtype=torch.float32, device=dev)
    for lo, blk in chunks:
        hi = lo + blk.shape[0]
        sc = torch.clamp(blk.pow(2).mean(dim=1).sqrt() / 2.0, min=1e-12)
        c = torch.clamp(torch.round((blk / sc[:, None] + 3.0) / 2.0), 0, 3).to(torch.int32)
        c[:, 3 * d4 :] = (c[:, 3 * d4 :] - 2) & 3
        packed[:, lo:hi] = (c[:, :d4] | (c[:, d4 : 2 * d4] << 2) | (c[:, 2 * d4 : 3 * d4] << 4)
                            | (c[:, 3 * d4 :] << 6)).to(torch.uint8).T
        s2[lo:hi] = sc
        s8[lo:hi] = torch.clamp(blk.abs().amax(dim=1), min=1e-12) / 127.0
        fine[:, lo:hi] = torch.clamp(torch.round(blk / s8[lo:hi, None]), -127, 127).to(torch.int8).T
    return packed, s2, fine, s8, src, ns


def check_int2_kernels(card: str) -> dict:
    """K5, K6, K7 and K8 at 4,194,304 x 384, bit for bit."""
    import torch

    from perceive_tpu_torch.ops import int2, topk

    dev = torch.device("cuda:0")
    n, hwm = 4_194_304, 3_800_000  # a prefix sweep of 3,809,280 rows
    g = torch.Generator(device=dev).manual_seed(5)
    packed, s2, fine, s8, src, ns = int2_corpus(g, dev, n, hwm)
    allowed = filters(dev)

    def queries(nq):
        return topk.quantize_queries(torch.randn((nq, DIM), generator=g, device=dev))

    scores = {}
    for nq in (1, 8):
        qi8, qs = queries(nq)
        for fname, al in allowed.items():
            got = int2.int2_scores(packed, s2, src, qi8, qs, al, ns)
            want = int2.int2_scores_plain(packed, s2, src, qi8, qs, al, ns)
            same = torch.equal(got, want)
            log(f"K5 Q={nq:<4d} n_sweep={ns} filter={fname:<4s} {'bit-exact ok' if same else 'FAIL'}")
            if not same:
                raise SystemExit(f"K5 disagrees with its plain version (Q={nq}, {fname})")
            scores[(nq, fname)] = got
            for kc in INT2_KCS:
                vk, rk, fk = int2.select_topk(got, kc)
                vp, rp, fp = int2.select_topk_plain(got, kc)
                ok = torch.equal(vk, vp) and torch.equal(rk, rp) and torch.equal(fk, fp)
                log(f"K6 Q={nq:<4d} kc={kc:<5d} filter={fname:<4s} set, order and floor "
                    f"{'bit-exact ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit(f"K6 disagrees with its plain version (Q={nq}, kc={kc}, {fname})")
    # K6 on dense ties: every score of a row 8 times over, and on a row that
    # matches nothing
    tied = scores[(8, "all")][:, : n // 8].repeat(1, 8).contiguous()
    tied[7] = float("-inf")
    for kc in INT2_KCS:
        got, want = int2.select_topk(tied, kc), int2.select_topk_plain(tied, kc)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise SystemExit(f"K6 disagrees with its plain version on dense ties (kc={kc})")
    log("K6 dense ties and an all -inf row: bit-exact, lower row first  ok")

    for kid, fn, widths, ks in (("K7", topk.scan_topk_int8t_flat, (1, 8, 32), KS),
                                ("K8", topk.scan_topk_int8t_slab, (512, 2048), (16, 128, 1024))):
        for nq in widths:
            qi8, qs = queries(nq)
            for k in ks:
                for fname, al in allowed.items():
                    got = fn(fine, s8, src, qi8, qs, al, k, ns)
                    want = topk.scan_topk_int8t_plain(fine, s8, src, qi8, qs, al, k, ns)
                    check_case(f"{kid} Q={nq:<4d} k={k:<5d} filter={fname:<4s}", got, want, 0.0)

    live = int((src[:ns] >= 0).sum())
    keep = src[:ns] >= 0
    times = {}
    for nq in (1, 8):  # K5
        qi8, qs = queries(nq)
        t = {"ms": cuda_ms(lambda: int2.int2_scores(packed, s2, src, qi8, qs, allowed["all"], ns)),
             "plain_ms": cuda_ms(lambda: int2.int2_scores_plain(packed, s2, src, qi8, qs, allowed["all"], ns)),
             "library_ms": None}  # no single PyTorch call unpacks 2-bit crumbs
        # packed bytes, scales and ids of the sweep read once, the queries
        # once, the (Q, n_sweep) scores written once; 2 * D int8 operations
        # a row and query
        t["bound_ms"], t["bound_by"] = bound(ns * (DIM // 4 + 8) + nq * DIM + nq * ns * 4,
                                             2.0 * nq * ns * DIM, "int8")
        times[("K5", nq)] = t
        log(f"K5 time Q={nq} n_sweep={ns}: kernel {t['ms']:.4f} ms  plain {t['plain_ms']:.4f} ms  "
            f"library n/a  bound {t['bound_ms']:.4f} ms ({t['bound_by']})  [{card}]")
    for nq, kc in ((1, 4096), (1, 1024), (8, 4096)):  # K6
        sc = scores[(nq, "all")]
        t = {"ms": cuda_ms(lambda: int2.select_topk(sc, kc)),
             "plain_ms": cuda_ms(lambda: int2.select_topk_plain(sc, kc)),
             "library_ms": cuda_ms(lambda: torch.topk(sc, kc))}
        # the scores read once, (score, row) pairs and the floor written once
        t["bound_ms"], t["bound_by"] = bound(nq * ns * 4 + nq * kc * 8 + nq * 4, 0.0, "int8")
        times[("K6", nq, kc)] = t
        log(f"K6 time Q={nq} kc={kc} n={ns}: kernel {t['ms']:.4f} ms  plain {t['plain_ms']:.4f} ms  "
            f"library {t['library_ms']:.4f} ms (torch.topk)  bound {t['bound_ms']:.4f} ms ({t['bound_by']})  [{card}]")
    mv, sv = fine[:, :ns], s8[:ns]

    def library(qi8, qs, k):
        """As check_int8_scans' yardstick, over the transposed matrix."""
        dots = torch._int_mm(qi8, mv).float() if qi8.shape[0] > 16 else qi8.float() @ mv.float()
        return torch.topk((dots * sv * qs).masked_fill(~keep, float("-inf")), k)

    for kid, fn, nq in (("K7", topk.scan_topk_int8t_flat, 1), ("K7", topk.scan_topk_int8t_flat, 32),
                        ("K8", topk.scan_topk_int8t_slab, 512), ("K8", topk.scan_topk_int8t_slab, 2048)):
        qi8, qs = queries(nq)
        k = INT8_KB
        t = {"ms": cuda_ms(lambda: fn(fine, s8, src, qi8, qs, allowed["all"], k, ns)),
             "plain_ms": cuda_ms(lambda: topk.scan_topk_int8t_plain(fine, s8, src, qi8, qs, allowed["all"], k, ns))}
        t["library_ms"] = cuda_ms(lambda: library(qi8, qs, k)) if nq <= 512 else None
        t["bound_ms"], t["bound_by"] = scan_bound(live, ns, nq, k, 1, "int8")
        times[(kid, nq)] = t
        lib = "not timed (its (Q, N) int32 product would take 34 GB)" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
        log(f"{kid} time Q={nq} k={k} n_sweep={ns}: kernel {t['ms']:.4f} ms  plain {t['plain_ms']:.4f} ms  "
            f"library {lib}  bound {t['bound_ms']:.4f} ms ({t['bound_by']})  [{card}]")
    del packed, fine, mv, scores, tied
    torch.cuda.empty_cache()
    return {"K5": {"max_abs_err": 0.0, **times[("K5", 1)]}, "K6": {"max_abs_err": 0.0, **times[("K6", 1, 4096)]},
            "K7": {"max_abs_err": 0.0, **times[("K7", 1)]}, "K8": {"max_abs_err": 0.0, **times[("K8", 512)]}}


# -- phase 5: K11 ------------------------------------------------------------


def check_k11(card: str) -> dict:
    import torch

    from perceive_tpu_torch.ops import attention as attn

    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(2)
    worst, times = 0.0, {}
    for b, s, nh, dh in ((64, 384, 12, 32), (64, 512, 12, 32), (8, 512, 12, 64)):
        # unit-variance q and k (scores ~ N(0, 1)); v at half scale keeps
        # |out| near 1, where one bf16 rounding of the output is ~4e-3
        q, k, v = (
            (torch.randn((b, s, nh, dh), generator=g, device=dev) * sd).to(torch.bfloat16)
            for sd in (1.0, 1.0, 0.5)
        )
        lens = torch.randint(1, s + 1, (b,), generator=g, device=dev)
        mask = (torch.arange(s, device=dev)[None, :] < lens[:, None]).to(torch.int32)
        got = attn.attention(q, k, v, mask)
        want = attn.attention_plain(q.float(), k.float(), v.float(), mask)
        torch.cuda.synchronize()
        err = float((got.float() - want).abs().max())
        status = "ok" if err <= 1e-2 else "FAIL"
        log(f"K11 B={b} S={s} NH={nh} DH={dh} max_abs_err={err:.3g} (vs f32 plain; "
            f"max |out| {float(want.abs().max()):.3g}) {status}")
        if status != "ok":
            raise SystemExit(f"K11 disagrees with its plain version at {(b, s, nh, dh)}")
        worst = max(worst, err)
        # the yardstick: PyTorch's fused attention with the additive mask
        add = ((1.0 - mask.to(torch.bfloat16)) * -1e9).to(torch.bfloat16)[:, None, None, :]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        t = {"ms": cuda_ms(lambda: attn.attention(q, k, v, mask)),
             "plain_ms": cuda_ms(lambda: attn.attention_plain(q, k, v, mask)),
             "library_ms": cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=add))}
        # q, k, v read and the output written once; q.k and p.v at 2 ops a product
        t["bound_ms"], t["bound_by"] = bound(4 * b * s * nh * dh * 2 + b * s * 4, 4.0 * b * nh * s * s * dh, "bf16")
        times[(b, s, nh, dh)] = t
        log(f"K11 time B={b} S={s} NH={nh} DH={dh}: kernel {t['ms']:.4f} ms  plain {t['plain_ms']:.4f} ms  "
            f"library {t['library_ms']:.4f} ms  bound {t['bound_ms']:.4f} ms ({t['bound_by']})  [{card}]")
    return {"max_abs_err": worst, **times[(64, 512, 12, 32)]}


# -- phases 6-9: the slices ------------------------------------------------------

N_DOCS = 2048
N_LONG = N_DOCS // 4  # documents over 400 tokens
TOTAL_ROWS = 1_000_000
INT8_ROWS = 2_000_000
INT2_ROWS = 4_194_304  # 4.19M effective rows at 384 dims: past the int8 tier's 4M
ENCODE_BATCH = 64
N_SELF_QUERIES = 8
N_EXECUTOR_QUERIES = 1024
N_CLIENTS = 16
N_BATCH = 2048


def minilm_vocab(size: int = 30522) -> list[str]:
    """A deterministic 30522-entry WordPiece vocabulary: specials, the
    single-character pieces of tiny_test_vocab, then generated words and
    their continuation syllables."""
    from perceive_tpu_torch.models.tokenize import tiny_test_vocab

    base = tiny_test_vocab([])
    words = list(base)
    cons, vows = "bcdfghjklmnprstvz", "aeiou"
    syll = [c + v for c in cons for v in vows]
    words += ["##" + s for s in syll]
    words += [a + b for a in syll for b in syll]
    for a in syll:
        for b in syll:
            for c in syll:
                if len(words) >= size:
                    return words[:size]
                words.append(a + b + c)
    return words[:size]


def make_docs(rng, vocab: list[str]) -> list[str]:
    """N_DOCS texts of vocabulary words (one token each): the first N_LONG
    over 400 tokens, the rest 12-120 tokens."""
    words = [w for w in vocab[200:] if not w.startswith("##")]
    docs = []
    for i in range(N_DOCS):
        n = int(rng.integers(401, 1100)) if i < N_LONG else int(rng.integers(12, 121))
        docs.append(" ".join(words[j] for j in rng.integers(0, len(words), n)))
    return docs


def token_windows(tokenizer, texts, chunk_tokens: int, overlap: int):
    """The ingest pipeline's default chunking (perceive_tpu/sources/
    pipeline.py chunk_token_windows_batch): windows of the wrap budget with
    an eighth of it overlapping."""
    step = max(chunk_tokens - overlap, 1)
    out = []
    for enc in tokenizer.encode_untruncated(texts, fast=True):
        ids = [t for t, sp in zip(enc.ids, enc.special_tokens_mask) if not sp]
        if len(ids) <= chunk_tokens:
            out.append([ids])
            continue
        wins, start = [], 0
        while start < len(ids):
            wins.append(ids[start : start + chunk_tokens])
            if start + chunk_tokens >= len(ids):
                break
            start += step
        out.append(wins)
    return out


def write_filler(db, src_id: int, first_id: int, first_seq: int, n: int, gen, text: str, mid: int, ver: int):
    """``n`` seeded unit-vector rows under ids first_id.. with one embedding
    each, through the columns the ingest pipeline writes; the vectors come
    from ``gen``, a torch.Generator on the card (SQLite takes the time)."""
    import torch

    chunk = 500_000
    for lo in range(0, n, chunk):
        c = min(chunk, n - lo)
        v = torch.randn((c, DIM), generator=gen, device=gen.device)
        v = (v / v.norm(dim=1, keepdim=True)).cpu().numpy()
        ids = range(first_id + lo, first_id + lo + c)
        with db.write() as conn:
            conn.executemany(
                """INSERT INTO items (id, source_id, external_id, version, hash, content,
                     process_version) VALUES (?,?,?,?,?,?,?)""",
                ((i, src_id, f"fill{i}", 1, "", text, 0) for i in ids),
            )
            conn.executemany(
                """INSERT INTO item_embeddings (item_id, chunk_idx, item_index_version, embedding,
                     model_id, model_version, seq) VALUES (?,?,?,?,?,?,?)""",
                ((i, 0, 1, v[j].tobytes(), mid, ver, first_seq + lo + j) for j, i in enumerate(ids)),
            )


def build_corpus(card: str, workdir: str, dev) -> dict:
    """Phase 6's ingest: the model, the documents, their windows encoded on
    the card, and the SQLite database filled to TOTAL_ROWS rows."""
    import torch

    from perceive_tpu_torch.db import Database, add_source
    from perceive_tpu_torch.index.matrix import serialize_embedding
    from perceive_tpu_torch.models import EncoderArch, HeadConfig, Model, ModelType, TextTokenizer
    from perceive_tpu_torch.ops import attention as attn
    from perceive_tpu_torch.types import Source

    rng = np.random.default_rng(11)
    vocab_list = minilm_vocab()
    vocab = {w: i for i, w in enumerate(vocab_list)}
    tok = TextTokenizer.from_vocab(vocab, max_seq_length=512)
    arch = EncoderArch(vocab_size=30522, hidden_size=384, num_layers=6, num_heads=12,
                       intermediate_size=1536, max_position_embeddings=512)
    model = Model.random(arch, HeadConfig(pooling="mean", normalize=True), tok, seed=0,
                         device=dev, compute_dtype=torch.bfloat16)
    model.model_id = ModelType.ALL_MINILM_L6_V2.model_id
    docs = make_docs(rng, vocab_list)

    # ingest encode: tokenize, window, encode on the card
    t0 = time.perf_counter()
    wins = token_windows(tok, docs, tok.wrap_budget, tok.wrap_budget // 8)
    flat = [(d, c, w) for d, ws in enumerate(wins) for c, w in enumerate(ws)]
    embs = []
    for s in range(0, len(flat), ENCODE_BATCH):
        batch = [w for _, _, w in flat[s : s + ENCODE_BATCH]]
        embs.append(model.materialize(model.encode_dispatch_token_windows(batch)))
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    embs = np.concatenate(embs)
    n_tokens = sum(len(w) + 2 for _, _, w in flat)
    log(f"ingest encode: {N_DOCS} docs ({len(flat)} windows, {n_tokens} tokens) in {t_enc:.3f} s = "
        f"{N_DOCS / t_enc:.1f} docs/s  [{card}]")
    if attn.LAUNCHES == 0:
        raise SystemExit("ingest encode launched no attention kernel")
    log(f"attention kernel launches during ingest: {attn.LAUNCHES}")

    # SQLite, through the columns the ingest pipeline writes
    t0 = time.perf_counter()
    db_path = os.path.join(workdir, "smoke.sqlite3")
    db = Database(db_path)
    src_docs = add_source(db, Source(name="docs", config={"type": "fs"}, location="generated:docs"))
    src_fill = add_source(db, Source(name="filler", config={"type": "fs"}, location="generated:filler"))
    mid, ver = model.model_id, model.model_version
    with db.write() as conn:
        for d, text in enumerate(docs):
            conn.execute(
                """INSERT INTO items (id, source_id, external_id, version, hash, content,
                     process_version, name, modified) VALUES (?,?,?,?,?,?,?,?,?)""",
                (d + 1, src_docs.id, f"doc{d}.txt", 1, "", text, 0, f"doc {d}", 1_700_000_000 + d),
            )
        conn.executemany(
            """INSERT INTO item_embeddings (item_id, chunk_idx, item_index_version, embedding,
                 model_id, model_version, seq) VALUES (?,?,?,?,?,?,?)""",
            [(d + 1, c, 1, serialize_embedding(e), mid, ver, s + 1)
             for s, ((d, c, _), e) in enumerate(zip(flat, embs))],
        )
    n_fill = TOTAL_ROWS - len(flat)
    filler_text = " ".join(vocab_list[300:316])
    gen = torch.Generator(device=dev).manual_seed(12)
    write_filler(db, src_fill.id, N_DOCS + 1, len(flat) + 1, n_fill, gen, filler_text, mid, ver)
    db.close()
    log(f"sqlite corpus: {len(flat)} document rows + {n_fill} filler rows = {TOTAL_ROWS} rows "
        f"written in {time.perf_counter() - t0:.1f} s")

    # 16 text queries: 8 documents' own texts, 8 random word lists
    self_docs = [N_LONG + i * ((N_DOCS - N_LONG) // N_SELF_QUERIES) for i in range(N_SELF_QUERIES)]
    queries = [docs[d] for d in self_docs]
    words = vocab_list[200:]
    for _ in range(16 - N_SELF_QUERIES):
        queries.append(" ".join(words[j] for j in rng.integers(0, len(words), int(rng.integers(3, 9)))))
    # N_BATCH vector queries, half near a stored window and half random, and
    # N_BATCH random ones
    half = N_BATCH // 2
    near = embs[rng.integers(0, len(embs), half)] + 0.02 * rng.standard_normal((half, DIM)).astype(np.float32)
    vecs = np.concatenate([near, rng.standard_normal((N_BATCH - half, DIM)).astype(np.float32)])
    vecs = (vecs / np.linalg.norm(vecs, axis=1, keepdims=True))[rng.permutation(N_BATCH)]
    vecs_random = rng.standard_normal((N_BATCH, DIM)).astype(np.float32)
    vecs_random /= np.linalg.norm(vecs_random, axis=1, keepdims=True)
    return {"model": model, "tok": tok, "docs": docs, "db_path": db_path, "gen": gen,
            "fill_source": src_fill.id, "next_id": N_DOCS + 1 + n_fill, "next_seq": len(flat) + n_fill + 1,
            "filler_text": filler_text, "self_docs": self_docs, "queries": queries, "vecs": vecs,
            "vecs_random": vecs_random}


def cli_queries(card: str, state, ctx: dict, tier: str, kernel: str):
    """16 queries through the CLI after 2 warm-ups; checks that every query
    is answered and launched ``kernel``, the self-queries rank their
    document first, and snippets come from their documents."""
    from perceive_tpu_torch.cli import main as cli_main

    db_path, docs, queries, self_docs = ctx["db_path"], ctx["docs"], ctx["queries"], ctx["self_docs"]

    def run(q):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli_main(["--db", db_path, "search", q, "-n", "10", "--json"], state=state)
        if rc != 0:
            raise SystemExit(f"search exited {rc} for {q[:40]!r}")
        return json.loads(out.getvalue())

    for q in queries[:2]:  # warm-up
        run(q)
    walls, results = [], []
    for q in queries:
        before = launch_counts()[kernel]
        t0 = time.perf_counter()
        res = run(q)
        walls.append((time.perf_counter() - t0) * 1e3)
        if launch_counts()[kernel] <= before:
            raise SystemExit(f"a {tier} query launched no {kernel} kernel")
        results.append(res)

    contents = {d + 1: t for d, t in enumerate(docs)}
    for qi, res in enumerate(results):
        if not res:
            raise SystemExit(f"query {qi} returned no results")
        for r in res:
            text = contents.get(r["id"], ctx["filler_text"] if r["id"] > N_DOCS else None)
            if text is None or not r["snippet"] or r["snippet"] not in text:
                raise SystemExit(f"query {qi}: snippet of item {r['id']} is not from its document")
    firsts = sum(results[i][0]["id"] == self_docs[i] + 1 for i in range(N_SELF_QUERIES))
    log(f"{tier} queries answered: {sum(bool(r) for r in results)}/16; self-queries ranked first: "
        f"{firsts}/{N_SELF_QUERIES}")
    if firsts != N_SELF_QUERIES:
        raise SystemExit("a stored document's own text did not rank it first")
    p50, p95 = (float(np.percentile(walls, p)) for p in (50, 95))
    log(f"{tier} query wall time (CLI search -n 10 --json, incl. highlight) p50 {p50:.2f} ms  "
        f"p95 {p95:.2f} ms over 16 queries  [{card}]")
    return results, p50, p95


def query_vector(ctx: dict, q: str, dev):
    import torch

    ids = torch.from_numpy(ctx["tok"].encode_batch_ids([q], pad_batch_to=1)).to(dev)
    return ctx["model"].encode_ids(ids).float()


def hits_match(got, want, tol: float) -> bool:
    """The same ids in the same order with scores within ``tol``; two ids
    may trade places only where their scores lie within 2 * tol."""
    if len(got) != len(want):
        return False
    for j, ((gi, gs), (wi, ws)) in enumerate(zip(got, want)):
        if abs(gs - ws) > tol:
            return False
        if gi != wi and not any(abs(ws - want[i][1]) <= 2 * tol for i in (j - 1, j + 1) if 0 <= i < len(want)):
            return False
    return True


def batch_breakdown(searcher, qs) -> tuple:
    """One search_vectors_batch -> (its hits, the host seconds spent in the
    sweeps (launch to copy back), in the f32 rerank, in the rest, and in
    all)."""
    spent = {"sweep": 0.0, "rerank": 0.0}

    def timed(name, fn):
        def run(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            spent[name] += time.perf_counter() - t0
            return out
        return run

    searcher._device_scan = timed("sweep", searcher._device_scan)
    searcher._rerank = timed("rerank", searcher._rerank)
    try:
        t0 = time.perf_counter()
        out = searcher.search_vectors_batch(qs, 10)
        spent["all"] = time.perf_counter() - t0
        spent["rest"] = spent["all"] - spent["sweep"] - spent["rerank"]
    finally:
        del searcher._device_scan, searcher._rerank  # back to the class's methods
    return out, spent


def batch_path(card: str, state, ctx: dict, tier: str, kernel: str, drain_kernel: str = "",
               reps: int = 3) -> dict:
    """N_EXECUTOR_QUERIES vector queries from N_CLIENTS threads through a
    BatchingSearchExecutor, then search_vectors_batch on N_BATCH queries of
    each mix, ``reps`` times after a warm-up (once, and no warm-up, when
    ``reps`` is 1).  The launch counts are read right after (``kernel`` must
    have run, and ``drain_kernel`` too where given); then every executor
    answer is held against the same query through search_vector."""
    from perceive_tpu_torch.index import BatchingSearchExecutor

    searcher, vecs = state.searcher, ctx["vecs"]
    results = [None] * N_EXECUTOR_QUERIES
    esc0 = searcher.escalations
    reset_launch_counts()
    ex = BatchingSearchExecutor(searcher)
    try:
        def client(c):
            for i in range(c, N_EXECUTOR_QUERIES, N_CLIENTS):
                results[i] = ex.search(vecs[i], 10, timeout=120)

        threads = [threading.Thread(target=client, args=(c,)) for c in range(N_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        t_ex = time.perf_counter() - t0
        sweeps, served = ex.sweeps_total, ex.queries_total
    finally:
        ex.close()
    timed = {}
    for name, qs in (("mixed", vecs), ("random", ctx["vecs_random"])):
        if reps > 1:
            searcher.search_vectors_batch(qs, 10)  # warm-up
        esc, runs = searcher.escalations, []
        for _ in range(reps):
            runs.append(batch_breakdown(searcher, qs))
        median = sorted(runs, key=lambda r: r[1]["all"])[len(runs) // 2]
        timed[name] = (median[1], (searcher.escalations - esc) / reps)
        if name == "mixed":
            batch = median[0]
    launches = launch_counts()
    # the path ends here; the checks below launch per-query sweeps
    if served != N_EXECUTOR_QUERIES or any(r is None for r in results):
        raise SystemExit(f"the executor served {served} of {N_EXECUTOR_QUERIES} queries")
    for name in (kernel, drain_kernel):
        if name and launches[name] == 0:
            raise SystemExit(f"the {tier} batch path launched no {name} kernel")
    log(f"{tier} executor: {N_EXECUTOR_QUERIES} queries from {N_CLIENTS} threads in {t_ex:.3f} s = "
        f"{N_EXECUTOR_QUERIES / t_ex:.1f} QPS; sweeps_total {sweeps}, queries_total {served}  [{card}]")
    for name, (parts, esc) in timed.items():
        wall = parts["all"]
        log(f"{tier} search_vectors_batch, {N_BATCH} {name} queries: {wall * 1e3:.2f} ms "
            f"({'median of ' + str(reps) if reps > 1 else 'one cold run'}) = {N_BATCH / wall:.1f} QPS; "
            f"{esc:g} escalations a batch; host seconds: "
            + ", ".join(f"{k} {parts[k]:.4f}" for k in ("sweep", "rerank", "rest")) + f"  [{card}]")
    log(f"{tier} batch path: escalations {searcher.escalations - esc0}; launches {launches}")
    bad = sum(not hits_match(results[i], searcher.search_vector(vecs[i], 10), 1e-5)
              for i in range(N_EXECUTOR_QUERIES))
    bad += sum(not hits_match(batch[i], results[i], 1e-5) for i in range(N_EXECUTOR_QUERIES))
    log(f"{tier} executor and batch answers equal search_vector's: "
        f"{2 * N_EXECUTOR_QUERIES - bad}/{2 * N_EXECUTOR_QUERIES}")
    if bad:
        raise SystemExit(f"{bad} {tier} executor or batch answers differ from search_vector's")
    return {"launches": launches}


def bf16_slice(card: str, ctx: dict, dev) -> dict:
    """Phase 6 after the ingest: AppState on the card, 16 CLI queries, hits
    held against the plain scan."""
    import torch

    from perceive_tpu_torch.cli import AppState
    from perceive_tpu_torch.index.searcher import _k_bucket
    from perceive_tpu_torch.ops import topk

    t0 = time.perf_counter()
    model = ctx["model"]
    state = AppState(ctx["db_path"], model=model, highlights_model=model, device=dev)
    searcher = state.searcher
    m = searcher.matrix
    log(f"AppState build: {len(m)} rows, tier {m.tier_name}, sweep_rows {m.sweep_rows}, "
        f"capacity {m.capacity} in {time.perf_counter() - t0:.1f} s  [{card}]")
    if len(m) != TOTAL_ROWS or m.device != dev or m.dtype != torch.bfloat16:
        raise SystemExit(f"searcher holds {len(m)} {m.tier_name} rows on {m.device}")
    results, p50, p95 = cli_queries(card, state, ctx, "bf16", "scan_topk")
    launches = topk.launch_counts()["scan_topk"]

    # the hits equal the plain scan over the same device matrix and queries
    vectors, src, _ = m.device_view()
    kb = _k_bucket(searcher._first_fetch(10), m.sweep_rows)
    allowed = torch.from_numpy(searcher._allowed_arrays(None)[0]).to(dev)
    for qi, q in enumerate(ctx["queries"]):
        vals, rows = topk.scan_topk_plain(vectors, src, query_vector(ctx, q, dev), allowed, kb, m.sweep_rows)
        want = searcher._decode_hits(vals[0].cpu().numpy(), rows[0].cpu().numpy(), 10)
        got = [(r["id"], r["score"]) for r in results[qi]]
        if [i for i, _ in got] != [i for i, _ in want] or max(
            abs(a[1] - b[1]) for a, b in zip(got, want)
        ) > 1e-4:
            raise SystemExit(f"query {qi}: hits differ from the plain scan:\n{got}\n{want}")
    log("bf16 slice hits equal the plain scan's for 16/16 queries")
    return state, {"launches": launches, "p50": p50, "p95": p95}


def exact_top10(searcher, qvs, dev) -> list:
    """The exact f32 top-10 (chunk hits deduped) of each of the (Q, dim)
    queries over the host mirror, in one pass over it."""
    import torch

    m = searcher.matrix
    live = torch.from_numpy(m.item_ids[: m.rows] >= 0).to(dev)
    scores = torch.empty((qvs.shape[0], m.rows), dtype=torch.float32, device=dev)
    step = 262_144
    for lo in range(0, m.rows, step):
        hi = min(m.rows, lo + step)
        rows = torch.from_numpy(m.host_vectors_for(slice(lo, hi))).to(dev)
        scores[:, lo:hi] = qvs[:, : m.dim] @ rows.T
    vals, rows = torch.topk(scores.masked_fill(~live, float("-inf")), 256, dim=1)
    return [searcher._decode_hits(v, r, 10) for v, r in zip(vals.cpu().numpy(), rows.cpu().numpy())]


def int8_slice(card: str, ctx: dict, dev) -> tuple:
    """Phase 8: fill SQLite to INT8_ROWS rows, a fresh AppState (auto tier
    -> int8), 16 CLI queries, hits held against the exact f32 top-10."""
    import torch

    from perceive_tpu_torch.cli import AppState
    from perceive_tpu_torch.db import Database
    from perceive_tpu_torch.ops import topk

    t0 = time.perf_counter()
    model = ctx["model"]
    db = Database(ctx["db_path"])
    n_more = INT8_ROWS - TOTAL_ROWS
    write_filler(db, ctx["fill_source"], ctx["next_id"], ctx["next_seq"], n_more, ctx["gen"],
                 ctx["filler_text"], model.model_id, model.model_version)
    db.close()
    ctx["next_id"] += n_more
    ctx["next_seq"] += n_more
    log(f"sqlite corpus: {n_more} more filler rows = {INT8_ROWS} rows, written in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    state = AppState(ctx["db_path"], model=model, highlights_model=model, device=dev)
    searcher = state.searcher
    m = searcher.matrix
    log(f"AppState build: {len(m)} rows, tier {m.tier_name}, sweep_rows {m.sweep_rows}, "
        f"capacity {m.capacity} in {time.perf_counter() - t0:.1f} s  [{card}]")
    if len(m) != INT8_ROWS or m.device != dev or m.dtype != torch.int8:
        raise SystemExit(f"searcher holds {len(m)} {m.tier_name} rows on {m.device}; want int8 on {dev}")

    topk.reset_launch_counts()
    esc0 = searcher.escalations
    results, p50, p95 = cli_queries(card, state, ctx, "int8", "scan_int8")
    launches = topk.launch_counts()["scan_int8"]
    escalations = searcher.escalations - esc0

    worst = 0.0
    exact = exact_top10(searcher, torch.cat([query_vector(ctx, q, dev) for q in ctx["queries"]]), dev)
    for qi, want in enumerate(exact):
        got = [(r["id"], r["score"]) for r in results[qi]]
        err = max(abs(a[1] - b[1]) for a, b in zip(got, want))
        if [i for i, _ in got] != [i for i, _ in want] or err > 1e-5:
            raise SystemExit(f"int8 query {qi}: hits differ from the exact f32 top-10:\n{got}\n{want}")
        worst = max(worst, err)
    log(f"int8 slice hits equal the exact f32 top-10 for 16/16 queries (max score error {worst:.3g}); "
        f"escalations {escalations}; scan_int8 launches {launches}")
    return state, {"launches": launches, "p50": p50, "p95": p95, "escalations": escalations}


def int2_slice(card: str, ctx: dict, dev) -> tuple:
    """Phase 11: fill SQLite to INT2_ROWS rows, a fresh AppState (auto tier
    -> int2 with its int8 companion) and its self-audit, 16 CLI queries
    (K5, K6 and K7 must all run), the composed device pipeline against the
    plain one for every query, hits against the exact f32 top-10."""
    import torch

    from perceive_tpu_torch.cli import AppState
    from perceive_tpu_torch.db import Database
    from perceive_tpu_torch.index.matrix import INT2
    from perceive_tpu_torch.index.searcher import _k_bucket
    from perceive_tpu_torch.ops import int2, topk

    t0 = time.perf_counter()
    model = ctx["model"]
    db = Database(ctx["db_path"])
    n_more = INT2_ROWS - INT8_ROWS
    write_filler(db, ctx["fill_source"], ctx["next_id"], ctx["next_seq"], n_more, ctx["gen"],
                 ctx["filler_text"], model.model_id, model.model_version)
    db.close()
    ctx["next_id"] += n_more
    ctx["next_seq"] += n_more
    log(f"sqlite corpus: {n_more} more filler rows = {INT2_ROWS} rows, written in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    state = AppState(ctx["db_path"], model=model, highlights_model=model, device=dev)
    searcher = state.searcher
    m = searcher.matrix
    log(f"AppState build: {len(m)} rows, tier {m.tier_name}, sweep_rows {m.sweep_rows}, "
        f"capacity {m.capacity} in {time.perf_counter() - t0:.1f} s  [{card}]")
    if len(m) != INT2_ROWS or m.device != dev or m.dtype != INT2:
        raise SystemExit(f"searcher holds {len(m)} {m.tier_name} rows on {m.device}; want int2 on {dev}")
    log(f"int2 coarse self-audit: {json.dumps(searcher.coarse_audit)}")
    if not m.coarse_trusted:
        raise SystemExit(f"the self-audit demoted the coarse pass ({searcher.coarse_audit}): "
                         "the CLI path would run no K5 or K6")

    reset_launch_counts()
    esc0 = searcher.escalations
    results, p50, p95 = cli_queries(card, state, ctx, "int2", "int2_scores")
    counts = launch_counts()
    launches = {name: counts[name] for name in ("int2_scores", "select_topk", "scan_int8t")}
    escalations = searcher.escalations - esc0
    log(f"int2 CLI path: escalations {escalations}; launches {launches}")
    for name, c in launches.items():
        if c == 0:
            raise SystemExit(f"the int2 CLI path launched no {name} kernel (audit {searcher.coarse_audit})")

    # the composed device pipeline equals the composed plain one, per query
    (packed2, fine), src, (scales2, fscales) = m.device_view()
    kb = _k_bucket(searcher._first_fetch(10), m.sweep_rows)
    allowed = torch.from_numpy(searcher._allowed_arrays(None)[0]).to(dev)
    qvs = torch.cat([query_vector(ctx, q, dev) for q in ctx["queries"]])
    qp = torch.nn.functional.pad(qvs, (0, m.padded_dim - m.dim))
    kw = dict(n_sweep=m.sweep_rows, fetch=m.coarse_fetch)
    for qi in range(len(ctx["queries"])):
        args = (packed2, scales2, fine, fscales, src, qp[qi : qi + 1], allowed, kb)
        got, want = int2.scan_int2_coarse_fine(*args, **kw), int2.scan_int2_coarse_fine_plain(*args, **kw)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise SystemExit(f"int2 query {qi}: the device pipeline differs from the plain one")
    kc = int2.int2_coarse_depth(kb, m.sweep_rows, m.coarse_fetch)
    log(f"int2 device pipeline (K5 -> K6 -> fine phase, kb={kb}, kc={kc}) equals the plain pipeline "
        f"for 16/16 queries: vals, rows and floor bit for bit")

    # where the pipeline's time goes, at Q = 1
    qi8, qscale = topk.quantize_queries(qp[:1])
    coarse = int2.int2_scores(packed2, scales2, src, qi8, qscale, allowed, m.sweep_rows)
    cvals, idx, _ = int2.select_topk(coarse, kc)
    t = {"pipeline": cuda_ms(lambda: int2.scan_int2_coarse_fine(*args[:5], qp[:1], allowed, kb, **kw)),
         "K5": cuda_ms(lambda: int2.int2_scores(packed2, scales2, src, qi8, qscale, allowed, m.sweep_rows)),
         "K6": cuda_ms(lambda: int2.select_topk(coarse, kc)),
         "gather": cuda_ms(lambda: fine.index_select(1, idx.reshape(-1).long())),
         "fine phase": cuda_ms(lambda: int2.fine_phase(cvals, idx, fine, fscales, qi8, qscale, kb))}
    log("int2 pipeline at Q=1 (ms): " + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
        + f"  (the fine phase: gather of {kc} columns + int32-exact dot + select)  [{card}]")

    exact = exact_top10(searcher, qvs, dev)
    hit = total = 0
    worst = 0.0
    for qi, want in enumerate(exact):
        got = dict((r["id"], r["score"]) for r in results[qi])
        hit += sum(i in got for i, _ in want)
        total += len(want)
        worst = max([worst] + [abs(got[i] - s) for i, s in want if i in got])
    recall = hit / max(total, 1)
    log(f"int2 served_recall_at_10 {recall:.6f} ({hit}/{total}) against the exact f32 top-10; "
        f"max score error {worst:.3g}")
    if recall < 0.99 or worst > 1e-5:
        raise SystemExit(f"int2 hits miss the exact f32 top-10 (recall {recall}, score error {worst})")
    return state, {"launches": launches, "p50": p50, "p95": p95, "escalations": escalations,
                   "recall": recall, "pipeline_ms": t}


def main() -> int:
    card = environment()
    import torch

    from perceive_tpu_torch.ops import attention as attn

    t_start = time.perf_counter()
    dev = torch.device("cuda:0")
    with phase("build"):
        build_kernels(card)
    with phase("K1, K2 against their plain version"):
        bf16 = check_bf16_scans(card)
    with phase("K3, K4 against their plain version"):
        int8 = check_int8_scans(card)
    with phase("K11 against its plain version"):
        k11 = check_k11(card)
    with phase("K5, K6, K7, K8 against their plain version"):
        int2k = check_int2_kernels(card)

    # every main path runs with the launch counts set to 0 just before it
    # and read just after it; the comparisons above do not count
    launches = {}
    with tempfile.TemporaryDirectory() as workdir:
        with phase("bf16 slice: ingest, 1M rows, 16 CLI queries"):
            reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            ctx = build_corpus(card, workdir, dev)
            state, bf16_sl = bf16_slice(card, ctx, dev)
            launches["scan_topk"], launches["attention"] = bf16_sl["launches"], attn.LAUNCHES
        with phase("bf16 batch path"):
            bf16_batch = batch_path(card, state, ctx, "bf16", "scan_slab")
            launches["scan_slab"] = bf16_batch["launches"]["scan_slab"]
        state.close()
        del state
        torch.cuda.empty_cache()
        with phase("int8 slice: 2M rows, 16 CLI queries"):
            state, int8_sl = int8_slice(card, ctx, dev)
            launches["scan_int8"] = int8_sl["launches"]
        with phase("int8 batch path"):
            int8_batch = batch_path(card, state, ctx, "int8", "scan_int8_slab")
            launches["scan_int8_slab"] = int8_batch["launches"]["scan_int8_slab"]
        state.close()
        del state  # release the int8 tier's mirror and device matrix
        gc.collect()
        torch.cuda.empty_cache()
        with phase("int2 slice: 4.19M rows, 16 CLI queries"):
            state, int2_sl = int2_slice(card, ctx, dev)
            launches.update(int2_sl["launches"])
        with phase("int2 batch path"):
            # one cold batch of each mix: the host rerank bounds them (PERF.md)
            int2_batch = batch_path(card, state, ctx, "int2", "scan_int8t_slab", "scan_int8t", reps=1)
            launches["scan_int8t_slab"] = int2_batch["launches"]["scan_int8t_slab"]
        state.close()
    log(f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB  [{card}]")
    log(f"kernel launches on the main paths: {launches}")
    for name, n in launches.items():
        if n == 0:
            raise SystemExit(f"the main path launched no {name} kernel")

    measured = {"scan_topk": bf16["K1"], "scan_slab": bf16["K2"], "scan_int8": int8["K3"],
                "scan_int8_slab": int8["K4"], "attention": k11, "int2_scores": int2k["K5"],
                "select_topk": int2k["K6"], "scan_int8t": int2k["K7"], "scan_int8t_slab": int2k["K8"]}
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0], "replaces": KERNELS[name][1],
         "launches": launches[name], "max_abs_err": measured[name]["max_abs_err"],
         "ms": measured[name]["ms"], "plain_ms": measured[name]["plain_ms"],
         "bound_ms": measured[name]["bound_ms"], "bound_by": measured[name]["bound_by"],
         "library_ms": measured[name]["library_ms"]}
        for name in KERNELS
    ]}
    log(f"total {time.perf_counter() - t_start:.1f} s  [{card}]")
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
