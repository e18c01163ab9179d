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
  9. the int8 batch path, as phase 7.
Each kernel is timed beside its plain version, one PyTorch call for the same
function (``library_ms``: a yardstick the port never calls) and its bound.
The second-to-last line is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
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
}
# the H100 SXM data sheet: device memory rate and dense tensor-core peaks
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12}
DIM = 384
KS = (16, 64, 128, 1024, 8192)
BF16_KB = 32  # the bf16 slice's sweep depth: k=10, doubled for chunk dedupe
INT8_KB = 128  # the int8 slice's: k=10, x4 over-fetch, doubled for chunk dedupe
SCAN_TOL = 1e-4  # bf16 scans: f32 sums of bf16 products in another order


def log(msg: str) -> None:
    print(msg, flush=True)


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


def write_filler(db, src_id: int, first_id: int, first_seq: int, n: int, rng, text: str, mid: int, ver: int):
    """``n`` seeded unit-vector rows under ids first_id.. with one embedding
    each, through the columns the ingest pipeline writes."""
    chunk = 100_000
    for lo in range(0, n, chunk):
        c = min(chunk, n - lo)
        v = rng.standard_normal((c, DIM)).astype(np.float32)
        v /= np.linalg.norm(v, axis=1, keepdims=True)
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
    write_filler(db, src_fill.id, N_DOCS + 1, len(flat) + 1, n_fill, rng, filler_text, mid, ver)
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
    return {"model": model, "tok": tok, "docs": docs, "db_path": db_path, "rng": rng,
            "fill_source": src_fill.id, "next_id": N_DOCS + 1 + n_fill, "next_seq": len(flat) + n_fill + 1,
            "filler_text": filler_text, "self_docs": self_docs, "queries": queries, "vecs": vecs,
            "vecs_random": vecs_random}


def cli_queries(card: str, state, ctx: dict, tier: str, kernel: str):
    """16 queries through the CLI after 2 warm-ups; checks that every query
    is answered and launched ``kernel``, the self-queries rank their
    document first, and snippets come from their documents."""
    from perceive_tpu_torch.cli import main as cli_main
    from perceive_tpu_torch.ops import topk

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
        before = topk.launch_counts()[kernel]
        t0 = time.perf_counter()
        res = run(q)
        walls.append((time.perf_counter() - t0) * 1e3)
        if topk.launch_counts()[kernel] <= before:
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


def batch_breakdown(searcher, qs) -> dict:
    """One search_vectors_batch, with the host seconds spent in the sweeps
    (launch to copy back), in the f32 rerank, and in the rest."""
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
        searcher.search_vectors_batch(qs, 10)
        spent["rest"] = time.perf_counter() - t0 - spent["sweep"] - spent["rerank"]
    finally:
        del searcher._device_scan, searcher._rerank  # back to the class's methods
    return spent


def batch_path(card: str, state, ctx: dict, tier: str, kernel: str) -> dict:
    """N_EXECUTOR_QUERIES vector queries from N_CLIENTS threads through a
    BatchingSearchExecutor, then search_vectors_batch on N_BATCH queries.
    The launch counts are read right after; then every executor answer is
    held against the same query through search_vector."""
    from perceive_tpu_torch.index import BatchingSearchExecutor
    from perceive_tpu_torch.ops import topk

    searcher, vecs = state.searcher, ctx["vecs"]
    results = [None] * N_EXECUTOR_QUERIES
    esc0 = searcher.escalations
    topk.reset_launch_counts()
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
        searcher.search_vectors_batch(qs, 10)  # warm-up
        esc, walls = searcher.escalations, []
        for _ in range(3):
            t0 = time.perf_counter()
            out = searcher.search_vectors_batch(qs, 10)
            walls.append(time.perf_counter() - t0)
        timed[name] = (float(np.median(walls)), (searcher.escalations - esc) / 3)
        if name == "mixed":
            batch = out
    launches = topk.launch_counts()
    # the path ends here; the checks below launch per-query sweeps
    if served != N_EXECUTOR_QUERIES or any(r is None for r in results):
        raise SystemExit(f"the executor served {served} of {N_EXECUTOR_QUERIES} queries")
    if launches[kernel] == 0:
        raise SystemExit(f"the {tier} batch path launched no {kernel} kernel")
    log(f"{tier} executor: {N_EXECUTOR_QUERIES} queries from {N_CLIENTS} threads in {t_ex:.3f} s = "
        f"{N_EXECUTOR_QUERIES / t_ex:.1f} QPS; sweeps_total {sweeps}, queries_total {served}  [{card}]")
    for name, (wall, esc) in timed.items():
        log(f"{tier} search_vectors_batch, {N_BATCH} {name} queries: {wall * 1e3:.2f} ms (median of 3) = "
            f"{N_BATCH / wall:.1f} QPS; {esc:g} escalations a batch  [{card}]")
    log(f"{tier} batch path: escalations {searcher.escalations - esc0}; launches {launches}")
    for name, qs in (("mixed", vecs), ("random", ctx["vecs_random"])):
        parts = batch_breakdown(searcher, qs)
        log(f"{tier} search_vectors_batch, {N_BATCH} {name} queries, host seconds: "
            + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()) + f"  [{card}]")
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


def exact_top10(searcher, qv, dev) -> list:
    """The exact f32 top-10 (chunk hits deduped) over the host mirror."""
    import torch

    m = searcher.matrix
    live = torch.from_numpy(m.item_ids[: m.rows] >= 0).to(dev)
    scores = torch.empty((m.rows,), dtype=torch.float32, device=dev)
    step = 262_144
    for lo in range(0, m.rows, step):
        hi = min(m.rows, lo + step)
        rows = torch.from_numpy(m.host_vectors_for(slice(lo, hi))).to(dev)
        scores[lo:hi] = rows @ qv[0, : m.dim]
    vals, rows = torch.topk(scores.masked_fill(~live, float("-inf")), 256)
    return searcher._decode_hits(vals.cpu().numpy(), rows.cpu().numpy(), 10)


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
    write_filler(db, ctx["fill_source"], ctx["next_id"], ctx["next_seq"], n_more, ctx["rng"],
                 ctx["filler_text"], model.model_id, model.model_version)
    db.close()
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
    for qi, q in enumerate(ctx["queries"]):
        want = exact_top10(searcher, query_vector(ctx, q, dev), dev)
        got = [(r["id"], r["score"]) for r in results[qi]]
        err = max(abs(a[1] - b[1]) for a, b in zip(got, want))
        if [i for i, _ in got] != [i for i, _ in want] or err > 1e-5:
            raise SystemExit(f"int8 query {qi}: hits differ from the exact f32 top-10:\n{got}\n{want}")
        worst = max(worst, err)
    log(f"int8 slice hits equal the exact f32 top-10 for 16/16 queries (max score error {worst:.3g}); "
        f"escalations {escalations}; scan_int8 launches {launches}")
    return state, {"launches": launches, "p50": p50, "p95": p95, "escalations": escalations}


def main() -> int:
    card = environment()
    import torch

    from perceive_tpu_torch.ops import attention as attn
    from perceive_tpu_torch.ops import topk

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

    # every main path runs with the launch counts set to 0 just before it
    # and read just after it; the comparisons above do not count
    launches = {}
    with tempfile.TemporaryDirectory() as workdir:
        with phase("bf16 slice: ingest, 1M rows, 16 CLI queries"):
            topk.reset_launch_counts()
            attn.LAUNCHES = 0
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
    log(f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB  [{card}]")
    log(f"kernel launches on the main paths: {launches}")
    for name, n in launches.items():
        if n == 0:
            raise SystemExit(f"the main path launched no {name} kernel")

    measured = {"scan_topk": bf16["K1"], "scan_slab": bf16["K2"], "scan_int8": int8["K3"],
                "scan_int8_slab": int8["K4"], "attention": k11}
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
