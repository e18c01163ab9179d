"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--audit-case CASE.npz]
    python3 chip_smoke.py --ladder
    python3 chip_smoke.py --only widths|families|default [--only ...]

``--audit-case`` also writes the int2+int4 self-audit's worst sample and
the rows around it to CASE.npz, for ``tests/audit_case.py`` to reproduce
off the card in the port and in the JAX package.  ``--ladder`` runs only
the build and the flat scans' times by depth and by width (K3, K7 and K9
flat), and K5's, K6's and K10's at 1 and 8 queries (``ladders``), and
prints no result line.  ``--only`` runs the build and the named phases
alone (the kernels at the registry's other widths, the registry families,
the default configuration) and prints no result line either.

Phases (any failure exits non-zero before the final line):
  1. environment: CUDA present, card name and power limit, versions;
  2. build the CUDA kernels from perceive_tpu_torch/csrc, and beside them
     the compiled tokenizer (g++: native/tokenizer.cpp and its Unicode
     tables) and the fs walker;
  3. K1 and K2 (bf16 scan + top-k, flat and slab) against their plain
     version at 1M x 384 bf16, K1 also over the same rows in f32, and K1
     replayed 40 times on one input; K1 again at one query over 1M x 768
     bf16 rows (the tokenizer.json families' width);
  4. K3 and K4 (int8 scan + top-k, flat and slab) against their plain
     version, bit for bit, at 2M x 384 int8 (K3 on both sides of its
     crossover to the tensor cores and at 255 queries), a sweep of 2,048
     queries in one K4 launch and of 255 queries at k = 8,192 in one K3
     launch, K3 timed by depth on the escalation ladder and by width on
     either pass 1, and replayed 40 times on one input; the library call of
     K4 at 2,048 queries (a 17 GB int32 product) timed alone;
  5. K11 (attention) against its plain version at every encoder bucket
     (timed beside the short-bucket route), at the ingest path's batch of
     1,024 windows at 512 tokens, at head width 64 (batches of 64 and
     1,024 at 512 tokens: the 768-wide families'), and on masks with whole
     padded key tiles and one kept key;
  6. the bf16 slice: 2,048 generated documents written as files (beside a
     hidden, a gitignored and an empty one) are ingested through the CLI's
     ``source add fs`` and ``source scan`` with an all-MiniLM-L6-v2-width
     model (seeded random weights) on the card, gated on exact item,
     embedding-row and matrix-row counts, K11 launched during the scan and
     the stored vectors against a direct encode, and the compiled
     tokenizer held to its plain version (ids, offsets and special masks)
     over all 2,048 documents; SQLite is filled to 1M
     rows, AppState builds the searcher on the card, and 16 queries run
     through the CLI;
  7. the bf16 batch path: 1,024 vector queries from 16 threads through a
     BatchingSearchExecutor, then search_vectors_batch on 2,048 queries
     (half near a stored window, half random) and on 2,048 random ones;
     then the serve phase (``serve_phase``): the 1M-row state behind the
     port's HTTP server, its readiness, the 16 CLI queries served
     uncontended (GET, then POST from the result cache) against the CLI's
     hits, 256 distinct queries from 16 threads against their uncontended
     answers (K1 on every drain), the filters and guards, ``tag``,
     ``hide`` and unhide, a background refresh re-embedding a rewritten
     long document through K11 with the dispatch gauge unmoved, ``stats``,
     ``print``, ``model``, ``doctor``, and ``python3 -m
     perceive_tpu_torch.cli`` ``source add``, ``source scan`` and
     ``serve`` in subprocesses, the last stopped by SIGTERM (exit 0),
     within 120 s; then the CLI's ``snapshot`` saves a format-v2 base of
     the 1M rows, which the manifest must name; then the mesh steps
     (``mesh_bf16``, ``mesh_encode``): that base adopted into a
     ShardedSearcher over 4 slots of the card, the 16 query texts through
     its fused path against the CLI's hits (4 K1 launches a sweep), a
     2,048-query batch (K2 on every shard) against the one-device answers,
     ``dryrun_multichip(4)`` over 4 slots, and the documents' 2,593 windows
     re-encoded through ``Model.shard_over`` at model-parallel 1 (2 slots)
     and 2 (2 x 2) against the stored vectors, K11 on every slot; then the
     registry families (``family_phase``): all-distilroberta-v1
     (byte-level BPE tokenizer.json), paraphrase-albert-small-v2 (Unigram),
     msmarco-distilbert-base-tas-b (DistilBERT, WordPiece vocab.txt, CLS
     pooling, no Normalize) and distiluse-base-multilingual-cased
     (DistilBERT, a cased 119,547-entry vocabulary with accented words and
     CJK ideographs, a Dense 768 -> 512 tanh head, max_seq_length 128) at
     their published widths with seeded weights, each written under
     PERCEIVE_TPU_MODEL_DATA, ``model set`` on a fresh database, a fresh
     AppState that must load the checkpoint, 256 files through ``source
     add fs`` + ``source scan`` (the ingest gates, the engine against the
     plain pipeline over the 256 documents; K11 at head width 64, none at
     distiluse's 128 tokens), 65,536 filler rows at the model's width with
     the scanned windows' norms, and 16 CLI queries (K1 over the 768- or
     512-d rows) against an exact f32 top-10, every tolerance scaled by the
     operands' norms; then the default configuration (``default_phase``):
     msmarco-bert-base-dot-v5 (12 layers, 768 wide, mean pooling, no
     Normalize) and all-MiniLM-L6-v2 loaded by AppState's own defaults
     from PERCEIVE_TPU_MODEL_DATA with no fallback, the 2,048 files scanned
     (K11 through 12 layers; the ingest gates), ``python3 -m
     perceive_tpu_torch.cli serve`` in a subprocess over the scanned rows
     (its /search against the CLI's, SIGTERM exit 0), 786,432 filler rows
     with the windows' norms (the int8 tier by auto at 1.58M effective
     rows: 16 CLI queries equal to an exact f32 top-10, highlight on the
     MiniLM model, a 2,048-query batch through K4 equal to search_vector's),
     and the same database pinned to int2 (streamed from the int8 state's
     snapshot: K5, K6 and K7, the pipeline against the plain one,
     served_recall_at_10 >= 0.99), within 150 s.  The kernel checks run
     in two parts, the card busy and the host all but idle, while worker
     processes (``host_job``) write to disk: phases 3-5 after the bf16
     slice's scan (meanwhile the checkpoints, ~1.4 GB of seeded weights,
     and the bf16 slice's filler rows), the rest after the default
     configuration's scan and server (meanwhile its filler rows, then the
     int8 slice's, and a copy of that database which takes the int2
     slice's rows);
  8. the int8 slice: 1M more filler rows (2M in all), a fresh AppState whose
     auto rule picks the int8 tier, built from the bf16 base (another
     tier: its f32 rows stream) and the rows written since, replayed from
     SQLite (exactly the 1M new rows), the same 16 queries through the
     CLI, hits held against an exact f32 top-10 over the host mirror;
  9. the int8 batch path, as phase 7;
 10. K5 (int2 coarse scores), K6 (exact top-kc select), K7 and K8 (int8
     scans over the transposed companion) and K10 (coarse scores kept per
     tile lane bin: the tiletop select) against their plain versions, bit
     for bit, at the int2 slice's shape (4,194,304 x 384), K7 on both sides
     of its crossover to the tensor cores and on duplicated columns at k =
     8,192 (its multi-block pass 2), a sweep of 2,048 queries in one K8
     launch, K7 timed by depth on the escalation ladder, K5 replayed 40
     times on one input at 1 and 8 queries, K6 on dense ties and on the
     rows that overflow its candidate region (1,000 finite scores; 64
     values in one bin) and timed at kc 1,024 to 16,384, K10 timed at 1 and
     8 queries, K6 over K10's buffer, each of K6, K10 and K6 over the
     buffer replayed 40 times on one input; then the library call of K8 at
     2,048 queries (a 31 GB int32 product) timed alone;
 11. K10 against its plain version, bit for bit, near the int2 tier's
     upper end (22.5M live rows of 25,165,824 x 384, generated on the card),
     timed at 1 and 8 queries;
 12. the int2 slice: 2,194,304 more filler rows (4,194,304 in all), a fresh
     AppState whose auto rule picks the int2 tier (coarse pass + int8
     companion), built cold (the bf16 base removed), its self-audit's verdict by stratum (the filler samples
     must pass the audit's gates; the docs source's one sample, which the
     ingest order places, is logged beside every document window's
     overlap), the same 16 queries through the CLI on the audited route
     and, where the audit demotes, with the audit off (K5, K6, K7), the
     composed device pipeline held against the composed plain one for every
     query, hits against an exact f32 top-10 (``served_recall_at_10``), the
     fine phase's gather and dot timed;
 13. the int2 batch path, as phase 7;
 14. the int2 slice's state with its coarse select pinned to tiletop (K10),
     window and threshold in turn: 16 CLI queries each, the device pipeline
     held against the plain one for every query, ``served_recall_at_10``
     (gated at 0.99 for window and threshold, reported for tiletop, whose
     lane bins drop rows), tiletop's candidate recall beside the exact
     select's;
 15. the int2 adopt: the CLI's ``snapshot`` saves that state (a full base
     with the int2 payload), and a fresh AppState adopts it with 0 rows from
     SQLite: device tensors, host mirror, ids, scale_hw/norm_hw and the
     self-audit's verdict equal the cold build's, and 16 CLI queries on
     each route give the cold build's hits (K5, K6 and K7 launched); then
     (``mesh_int2``) the same base adopted into a ShardedSearcher over 4
     slots, its self-audit logged beside the one-device verdict, the 16
     query texts through its fused path on each audit route (K5, K6 and K7
     on every shard) gated on served_recall_at_10 >= 0.99, every shard's
     pipeline equal to its plain one bit for bit with the floors
     max-merged, and a 2,048-query batch (K8 on every shard) against the
     one-device answers; the mesh steps log their seconds (budget 60 s);
 16. K9 (packed-int4 scan + top-k, flat and slab) against its plain version,
     bit for bit, at the int4 tier's own size (25,165,824 x 384, past the
     int2 tier's 24M, generated on the card), with K7 and K8 timed on the
     same rows unpacked to int8 beside it, a sweep of 2,048 queries in one
     slab launch, K9 flat on both sides of its crossover, on duplicated
     columns at k = 8,192, a 32-query k = 8,192 sweep in one launch, and
     timed by depth on the escalation ladder over the int4 slice's
     4,194,304 rows and over all 25,165,824; then K9's slab kernel bit for
     bit and timed at 34,603,008 rows, and on the same rows unpacked to the companion's (D, N) int8
     layout and transposed to (N, D) rows, K8 and K4: the three agree bit
     for bit (and with the plain version on a filter), each timed once;
 16b. K1-K10 at the registry's other widths (``check_wide_kernels``), each
     against its plain version under both filters (K3-K10 bit for bit, K1
     and K2 within SCAN_TOL) and timed by events and by device time beside
     its plain version, its library call and its bound: K3 and K4 over
     1,572,864 x 768 int8, K5 + K6, K7, K10 and K8 over 4,194,304 x 768
     int2 with its (768, N) companion, K9 flat and slab over 12,582,912 x
     768 packed int4 (the rows where auto puts a 768-d corpus on each
     tier), K1 and K2 over 1,048,576 x 512 bf16 (distiluse's Dense width);
 17. the int4 slice: a fresh AppState pinned to the int4 tier on the int2
     slice's corpus, streamed from the int2 base (another tier) with 0 rows
     from SQLite, the same 16 queries through the CLI (flat K9), hits
     against the exact f32 top-10 (``served_recall_at_10``);
 18. the int4 batch path, as phase 13 (slab K9);
 19. the int2 tier with the int4 companion: that state retiered to int2
     under PERCEIVE_TPU_INT2_FINE=int4, its self-audit's verdict (redrawn
     sample by sample and by stratum, as in phase 12, then a second audit on
     the audit's next seeded sample), the 16 CLI queries (K5, K6 and flat
     K9), the composed device pipeline held against
     the plain one for every query, ``served_recall_at_10``, and one batch
     of each mix;
 20. the delta: in phase 15's adopted state (kept open), the docs
     source's rows removed and 300 filler rows upserted through the
     Searcher's ingest hooks (the database changed to match: the docs
     items hidden), ``snapshot`` answering "delta", and a build from base
     + delta holding SQLite's live keys and the exact f32 top-10 over
     SQLite's rows (the adopted rows less the docs, plus the 300 new).
Each kernel is timed beside its plain version, one PyTorch call for the same
function (``library_ms``: a yardstick the port never calls; null where no
single call computes it) and its bound.
The second-to-last line is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import gc
import io
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "scan_topk": ("perceive_tpu_torch/csrc/scan_flat_rows.cu", "perceive_tpu/ops/topk.py:966"),
    "scan_slab": ("perceive_tpu_torch/csrc/scan_slab_rows.cu", "perceive_tpu/ops/topk.py:927"),
    "scan_int8": ("perceive_tpu_torch/csrc/scan_flat_rows.cu", "perceive_tpu/ops/topk.py:273"),
    "scan_int8_slab": ("perceive_tpu_torch/csrc/scan_slab_rows.cu", "perceive_tpu/ops/topk.py:234"),
    "attention": ("perceive_tpu_torch/csrc/attention.cu", "perceive_tpu/ops/attention.py:58"),
    "int2_scores": ("perceive_tpu_torch/csrc/scan_int2.cu", "perceive_tpu/ops/topk.py:1222"),
    "select_topk": ("perceive_tpu_torch/csrc/select_topk.cu", "perceive_tpu/ops/topk.py:1748"),
    "scan_int8t": ("perceive_tpu_torch/csrc/scan_flat_cols.cu", "perceive_tpu/ops/topk.py:753"),
    "scan_int8t_slab": ("perceive_tpu_torch/csrc/scan_slab_cols.cu", "perceive_tpu/ops/topk.py:835"),
    "scan_int4": ("perceive_tpu_torch/csrc/scan_flat_cols.cu", "perceive_tpu/ops/topk.py:519"),
    "scan_int4_slab": ("perceive_tpu_torch/csrc/scan_slab_cols.cu", "perceive_tpu/ops/topk.py:618"),
    "int2_tiletop": ("perceive_tpu_torch/csrc/scan_int2.cu", "perceive_tpu/ops/topk.py:1347"),
}
# the H100 SXM data sheet: device memory rate and dense tensor-core peaks
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12}
# special-function (exp2) rate: 132 SMs x 16 a clock at ~1.83 GHz, the
# figure the FlashAttention-3 paper gives for the H100 SXM
SFU_OPS_PER_S = 3.9e12
DIM = 384
KS = (16, 64, 128, 1024, 8192)
BF16_KB = 32  # the bf16 slice's sweep depth: k=10, doubled for chunk dedupe
INT8_KB = 128  # the int8 slice's: k=10, x4 over-fetch, doubled for chunk dedupe
INT4_KB = 256  # the int4 slices': k=10, x8 over-fetch, doubled for chunk dedupe
# the escalation ladder's rungs (index/searcher.py _OVERFETCH_BUCKETS, 4x a
# rung): K3 sweeps the int8 tier and K7 the int2 tier's companion from the
# fused first sweep's 128 (INT8_KB), K9 flat the int4 tier from INT4_KB
INT8_LADDER = (INT8_KB, 512, 2048, 8192)
K9_LADDER = (INT4_KB, 1024, 4096, 8192)
INT4_SLICE_ROWS = 4_194_304  # the int4 slice's corpus: K9 flat's main-path sweep
INT2_KCS = (1024, 4096)  # coarse depths: the audit's shallowest, and the default
INT4_KERNEL_ROWS = 25_165_824  # the int4 tier's own size: past 24M rows
INT4_WIDE_ROWS = 34_603_008  # past 33,553,920 rows, where K9's first slab kernel ran out of grid
INT2_TOP_ROWS, INT2_TOP_HWM = 25_165_824, 22_500_000  # K10 near the int2 tier's upper end (24M rows)
SELECTS = ("tiletop", "window", "threshold")  # the int2 selects pinned on the int2 slice's state
SCAN_TOL = 1e-4  # bf16 scans: f32 sums of bf16 products in another order
# a bf16 row's score against its f32 row's: at most 2**-7 of |row| |query|
# (both unit), one bf16 rounding (2**-8 relative) of each product's operands
BF16_SCORE_TOL = 2.0 ** -7


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


PEAK_BYTES = [0]  # the run's peak device memory, across resets of the peak


def note_peak() -> None:
    import torch

    PEAK_BYTES[0] = max(PEAK_BYTES[0], torch.cuda.max_memory_allocated())


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
    while len(times) < (reps if not times or times[0] < 100 else min(reps, 3)):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_times(fn, reps: int = 20) -> dict:
    """Device milliseconds a call of ``fn`` takes in each kernel (and
    memset), by name: torch.profiler's ``key_averages()`` over ``reps``
    calls after a warm-up, over ``reps``.  Unlike ``cuda_ms`` it leaves out
    the host's work before and between the launches (a wrapper's Python
    prologue)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = {}
    for e in prof.key_averages():
        name = e.key.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
        times[name] = times.get(name, 0.0) + e.device_time_total / reps / 1e3
    return times


def device_ms(fn, reps: int = 20) -> float:
    """Device milliseconds a call of ``fn`` takes, all its kernels."""
    return sum(device_times(fn, reps).values())


def device_split(fn) -> str:
    """``fn``'s device milliseconds by kernel, as a log line."""
    return "  ".join(f"{name[:24]} {ms:.4f}" for name, ms in device_times(fn).items())


def bound(n_bytes: float, ops: float, kind: str, transcendentals: float = 0.0) -> tuple[float, str]:
    """The least milliseconds the card could take: the largest of the bytes
    over the memory rate, the operations over the peak for their type, and
    the transcendental operations (exponentials) over the special-function
    rate; the last two are both "operations"."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / PEAK_OPS_PER_S[kind], transcendentals / SFU_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scan_bound(live: int, n_sweep: int, nq: int, k: int, elem: int, kind: str, dim: int = DIM):
    """Bound of a scan with top-k: each live row read once (with its scale at
    int8), every source id once, the queries once, the (Q, k) result written
    once; 2 * D operations per live row and query."""
    scale = 4 * live if kind == "int8" else 0
    n_bytes = live * dim * elem + scale + 4 * n_sweep + nq * dim * elem + nq * k * 8
    return bound(n_bytes, 2.0 * nq * live * dim, kind)


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
    os.environ.pop("PERCEIVE_TPU_INT2_FINE", None)  # and the int2 companion's budget rule
    log(card)  # name, power limit: as nvidia-smi prints them
    log(f"torch {torch.__version__}  cuda {torch.version.cuda}  python {sys.version.split()[0]}")
    return card


def build_walker(card: str) -> None:
    """The fs connector's native walker (g++ into perceive_tpu_torch/_build/),
    built here so that the ingest scan times the walk and not the build."""
    from perceive_tpu_torch.native import fastwalk_available

    t0 = time.perf_counter()
    built = fastwalk_available()
    log(f"fs walker build+load {time.perf_counter() - t0:.2f} s: "
        f"{'native' if built else 'unavailable, the Python walk serves'}  [{card}]")


def build_tokenizer(card: str) -> None:
    """The compiled tokenizer (g++ into perceive_tpu_torch/_build/, its
    tables generated from this Python's unicodedata): no model loads
    without it."""
    from perceive_tpu_torch.native import tokenizer as native_tokenizer

    t0 = time.perf_counter()
    native_tokenizer.library()
    log(f"tokenizer library build+load {time.perf_counter() - t0:.2f} s (tables and g++ "
        f"{native_tokenizer.build_seconds} s): {native_tokenizer.library_path().name}  [{card}]")


def hold_tokenizer(card: str, tok, docs: list, tag: str) -> None:
    """The compiled tokenizer against its plain version over every document:
    ids, offsets and special-token masks equal, untruncated, as the
    highlight path asks for them; both sides' seconds on this host."""
    t0 = time.perf_counter()
    got = tok.encode_untruncated(docs)
    t_engine = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = [tok.tokenizer.encode(d) for d in docs]
    t_plain = time.perf_counter() - t0
    bad = [i for i, (a, b) in enumerate(zip(got, want))
           if (a.ids, a.offsets, a.special_tokens_mask) != (b.ids, b.offsets, b.special_tokens_mask)]
    n_tok = sum(len(e.ids) for e in want)
    log(f"{tag}: the compiled tokenizer against its plain {type(tok.tokenizer).__name__} over {len(docs)} documents "
        f"({sum(map(len, docs))} chars, {n_tok} tokens): {len(docs) - len(bad)} equal; engine {t_engine:.3f} s "
        f"({tok.engine.threads} threads), plain {t_plain:.3f} s  [{card}]")
    if bad or len(got) != len(docs):
        raise SystemExit(f"{tag}: the compiled tokenizer differs from its plain version on documents {bad[:8]}")


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


def corpus_rows(g, dev, n: int, hwm: int, dim: int = DIM):
    """Seeded unit rows in (n, dim) f32 chunks, source ids in {0, 1, 2} with
    5% tombstones and an unallocated tail from ``hwm``, and the sweep prefix
    the matrix's ladder gives that high-water mark."""
    import torch

    from perceive_tpu_torch.index.matrix import sweep_rows_for

    def chunks():
        for lo in range(0, n, 131072):
            blk = torch.randn((min(131072, n - lo), dim), generator=g, device=dev)
            yield lo, blk / blk.norm(dim=1, keepdim=True)

    src = torch.randint(0, 3, (n,), generator=g, device=dev, dtype=torch.int32)
    src[torch.rand((n,), generator=g, device=dev) < 0.05] = -1  # tombstones
    src[hwm:] = -1  # unallocated tail
    ns = sweep_rows_for(hwm, n)
    assert ns < n
    return chunks(), src, ns


def one_launch(kid: str, counter: str, run, ns: int) -> None:
    """Fails unless ``run`` (a sweep of N_BATCH queries at INT8_KB) takes
    exactly one launch of the kernel counted by topk's ``counter``."""
    from perceive_tpu_torch.ops import topk

    before = getattr(topk, counter)
    run()
    took = getattr(topk, counter) - before
    if took != 1:
        raise SystemExit(f"{kid} took {took} launches for {N_BATCH} queries over {ns:,} rows at k={INT8_KB}")
    log(f"{kid}: {N_BATCH} queries over {ns:,} rows at k={INT8_KB} took one launch  ok")


def depth_times(card: str, kid: str, run, nq: int, ns: int, ks=(1, 16, INT8_KB, 1024), bound_of=None,
                library=None) -> dict:
    """Logs and returns ``run(k)``'s time at each k of ``ks`` (by default 1,
    16, INT8_KB and 1,024), each beside ``bound_of(k)``'s (ms, what bounds
    it) and ``library(k)``'s time where given: the running lists' appends
    and compactions, and pass 2, grow with k, the stream and the products
    do not, so the spread is what the epilogue costs at each depth."""
    ms = {k: cuda_ms(lambda: run(k)) for k in ks}
    extra = {k: (f" (bound {bound_of(k)[0]:.4f}, {bound_of(k)[1]}" if bound_of else "")
             + (f"; library {cuda_ms(lambda: library(k)):.4f} ms" if library else "")
             + (")" if bound_of else "") for k in ks}
    log(f"{kid} time by depth Q={nq} n_sweep={ns}: "
        + "  ".join(f"k={k} {t:.4f} ms{extra[k]}" for k, t in ms.items()) + f"  [{card}]")
    return ms


def int8_yardstick(m, scales, keep, cols: bool = False):
    """The library call for an int8 scan with top-k over a sweep's rows
    ``m`` ((n, D) int8, or the (D, n) companion where ``cols``) with their
    scales and live mask: torch._int_mm where its shape rules allow (more
    than 16 queries), else an f32 matmul of the int8 values (exact: sums
    below 2**24); then the scale products, masked_fill and topk."""
    import torch

    mt = m if cols else m.T

    def library(qi8, qs, k):  # scaled in place: one (Q, n) f32 beside the int32 product at most
        dots = torch._int_mm(qi8, mt).float() if qi8.shape[0] > 16 else qi8.float() @ mt.float()
        return torch.topk(dots.mul_(scales).mul_(qs).masked_fill_(~keep, float("-inf")), k)

    return library


def wide_library_ms(card: str, kid: str, library, nq: int, n: int, queries) -> float | None:
    """The library call of an int8 batch scan at ``nq`` queries over ``n``
    rows (a (Q, n) int32 product, then its f32 copy), timed alone after the
    phase's other tensors are freed; None, with the gigabytes it needed and
    those free, where the card runs out of memory."""
    import torch

    qi8, qs = queries(nq)
    need = 8 * nq * n / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0] / 1e9
    try:
        ms = cuda_ms(lambda: library(qi8, qs, INT8_KB), reps=3)
    except torch.cuda.OutOfMemoryError:
        log(f"{kid} library Q={nq} k={INT8_KB} n_sweep={n}: out of memory (the product and its f32 copy "
            f"need {need:.1f} GB, {free:.1f} GB free)  [{card}]")
        torch.cuda.empty_cache()
        return None
    log(f"{kid} library Q={nq} k={INT8_KB} n_sweep={n}: {ms:.4f} ms (torch._int_mm + scales + topk; "
        f"{need:.1f} GB of product and f32 copy, {free:.1f} GB free)  [{card}]")
    return ms


def replay(kid: str, name: str, run, want, times: int = 40) -> None:
    """Runs ``run()`` ``times`` times back to back on one input (the
    wrapper's workspace reused from PyTorch's cache) and fails unless each
    answer equals ``want`` (the checked first answer) bit for bit: a race
    between a ring stage's release and the next TMA write shows as a few
    wrong rows now and then (PERF.md section 6)."""
    import torch

    bad = 0
    for _ in range(times):
        got = run()
        bad += not (torch.equal(got, want) if isinstance(got, torch.Tensor) else torch_equal(got, want))
    log(f"{kid} {name}: {times} replays, {bad} differ  {'ok' if bad == 0 else 'FAIL'}")
    if bad:
        raise SystemExit(f"{kid} answered differently in {bad} of {times} replays ({name})")


def int2_bound(n_sweep: int, nq: int, dim: int = DIM):
    """Bound of K5: the sweep's packed bytes, scales and ids read once, the
    queries once, the (Q, n_sweep) scores written once; 2 * D int8
    operations a row and query."""
    return bound(n_sweep * (dim // 4 + 8) + nq * dim + nq * n_sweep * 4, 2.0 * nq * n_sweep * dim, "int8")


def int4_bound(live: int, n_sweep: int, nq: int, k: int, dim: int = DIM):
    """Bound of a packed-int4 scan: the live rows' packed bytes and scales
    read once, every source id of the sweep once, the queries once, the
    (Q, k) result written once; 2 * D int8 operations a live row and
    query."""
    return bound(live * (dim // 2 + 4) + 4 * n_sweep + nq * dim + nq * k * 8, 2.0 * nq * live * dim, "int8")


def crossover_widths(widths: tuple, table: str, key: str) -> tuple:
    """``widths`` and the two sides of a flat scan's crossover from the
    CUDA cores to the tensor cores, ``topk.<table>[key]`` (K1 and K3:
    FLAT_ROWS_CORE_QUERIES by operand; K7 and K9 flat:
    FLAT_COLS_CORE_QUERIES by decode), where the tree has one."""
    from perceive_tpu_torch.ops import topk

    cross = getattr(topk, table, {}).get(key)
    return tuple(sorted(set(widths) | ({cross, cross + 1} if cross else set())))


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

    return len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))


def check_bf16_scans(card: str) -> dict:
    """K1 (flat) and K2 (slab) at 1,048,576 x 384 bf16, K1 also over the
    same rows in f32 (its CUDA-core path at every width)."""
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

    def check(kid, fn, m, src, ns, q, k, suffix=""):
        for fname, al in allowed.items():
            err = check_case(f"{kid} Q={q.shape[0]:<4d} k={k:<5d} filter={fname:<4s}{suffix}",
                             fn(m, src, q, al, k, ns), topk.scan_topk_plain(m, src, q, al, k, ns), SCAN_TOL)
            worst[kid] = max(worst[kid], err)

    def timed(kid, fn, m, src, ns, q, k):
        """Kernel, plain and library (bf16 matmul + masked_fill + topk)
        times beside the bound, logged with the card."""
        keep = src[:ns] >= 0
        mv = m[:ns]
        nq, dim = q.shape
        t = {"ms": cuda_ms(lambda: fn(m, src, q, allowed["all"], k, ns)),
             "plain_ms": cuda_ms(lambda: topk.scan_topk_plain(m, src, q, allowed["all"], k, ns)),
             "library_ms": cuda_ms(lambda: torch.topk(
                 torch.matmul(q.to(torch.bfloat16), mv.T).masked_fill(~keep, float("-inf")), k))}
        t["bound_ms"], t["bound_by"] = scan_bound(int(keep.sum()), ns, nq, k, 2, "bf16", dim=dim)
        log(f"{kid} time Q={nq} k={k} n_sweep={ns}{'' if dim == DIM else f' D={dim}'}: kernel {t['ms']:.4f} ms  "
            f"plain {t['plain_ms']:.4f} ms  library {t['library_ms']:.4f} ms  bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']})  [{card}]")
        return t

    for kid, fn, widths in (("K1", topk.scan_topk_flat, (1, 8, 64, 512)),
                            ("K2", topk.scan_topk_slab, (256, 512, 2048))):
        ks = (16, BF16_KB, 1024, 8192) if kid == "K1" else tuple(sorted(KS + (BF16_KB,)))  # the slice's kb
        for nq in widths:
            q = queries(nq)
            for k in ks:
                check(kid, fn, m, src, ns, q, k)
    m32 = m.float()
    for nq in (1, 64):
        check("K1", topk.scan_topk_flat, m32, src, ns, queries(nq), BF16_KB, " f32")
    del m32
    for nq, k, fname in ((1, BF16_KB, "all"), (8, 8192, "2src")):  # the CUDA cores: their ring's releases
        q = queries(nq)
        first = topk.scan_topk_flat(m, src, q, allowed[fname], k, ns)
        check_case(f"K1 Q={nq:<4d} k={k:<5d} filter={fname:<4s} (replayed)", first,
                   topk.scan_topk_plain(m, src, q, allowed[fname], k, ns), SCAN_TOL)
        replay("K1", f"Q={nq} k={k} filter={fname}", lambda: topk.scan_topk_flat(m, src, q, allowed[fname], k, ns),
               first)
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

    times = {(kid, nq, k): timed(kid, fn, m, src, ns, queries(nq), k)
             for kid, fn, nq, k in (("K1", topk.scan_topk_flat, 1, BF16_KB), ("K1", topk.scan_topk_flat, 16, BF16_KB),
                                    ("K1", topk.scan_topk_flat, 64, BF16_KB),
                                    ("K2", topk.scan_topk_slab, 512, BF16_KB),
                                    ("K2", topk.scan_topk_slab, 2048, BF16_KB))}
    del m
    torch.cuda.empty_cache()

    # K1 over 768-d rows: the tokenizer.json families' text query (one query,
    # the bf16 slice's depth) over the same sweep of 958,464 rows
    wide = FAMILIES["AllDistilrobertaV1"]["config"]["hidden_size"]
    chunks, src, ns = corpus_rows(g, dev, n, hwm, dim=wide)
    m = torch.empty((n, wide), dtype=torch.bfloat16, device=dev)
    for lo, blk in chunks:
        m[lo : lo + blk.shape[0]] = blk.to(torch.bfloat16)
    q = torch.randn((1, wide), generator=g, device=dev)
    q /= q.norm(dim=1, keepdim=True)
    check("K1", topk.scan_topk_flat, m, src, ns, q, BF16_KB, f" D={wide}")
    timed("K1", topk.scan_topk_flat, m, src, ns, q, BF16_KB)
    del m
    torch.cuda.empty_cache()
    return {"K1": {"max_abs_err": worst["K1"], **times[("K1", 1, BF16_KB)]},
            "K2": {"max_abs_err": worst["K2"], **times[("K2", 512, BF16_KB)]}}


def int8_rows(g, dev, n: int, hwm: int, dim: int = DIM):
    """Seeded unit rows as the int8 tier stores them, quantized on the card
    (per-row symmetric, as the matrix's ``_quantize``): the (n, dim) int8
    matrix, its row scales, source ids and the sweep prefix as corpus_rows
    gives them."""
    import torch

    chunks, src, ns = corpus_rows(g, dev, n, hwm, dim)
    m = torch.empty((n, dim), dtype=torch.int8, device=dev)
    scales = torch.empty((n,), dtype=torch.float32, device=dev)
    for lo, blk in chunks:
        s = torch.clamp(blk.abs().amax(dim=1), min=1e-12) / 127.0
        m[lo : lo + blk.shape[0]] = torch.clamp(torch.round(blk / s[:, None]), -127, 127).to(torch.int8)
        scales[lo : lo + blk.shape[0]] = s
    return m, scales, src, ns


def check_int8_scans(card: str) -> dict:
    """K3 (flat) and K4 (slab) at 2,097,152 x 384 int8, bit for bit."""
    import torch

    from perceive_tpu_torch.ops import topk

    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(3)
    m, scales, src, ns = int8_rows(g, dev, 2_097_152, 1_900_000)
    allowed = filters(dev)

    def queries(nq):
        return topk.quantize_queries(torch.randn((nq, DIM), generator=g, device=dev))

    k3_widths = crossover_widths((1, 8, 16, 17, 255), "FLAT_ROWS_CORE_QUERIES", "int8")
    for kid, fn, widths in (("K3", topk.scan_topk_int8_flat, k3_widths),
                            ("K4", topk.scan_topk_int8_slab, (256, 512, 2048))):
        for nq in widths:
            qi8, qs = queries(nq)
            for k in (KS if kid == "K4" or nq > 17 else KS + (2048,)):
                for fname, al in allowed.items():
                    got = fn(m, scales, src, qi8, qs, al, k, ns)
                    want = topk.scan_topk_int8_plain(m, scales, src, qi8, qs, al, k, ns)
                    check_case(f"{kid} Q={nq:<4d} k={k:<5d} filter={fname:<4s}", got, want, 0.0)
    before = topk.LAUNCHES_INT8_SLAB
    topk.scan_topk_int8(m, scales, src, torch.randn((300, DIM), generator=g, device=dev), allowed["all"], 16, ns)
    if topk.LAUNCHES_INT8_SLAB != before + 1:
        raise SystemExit("scan_topk_int8 did not route a 300-query sweep to K4")
    # the escalation ladder's top rung at an executor drain's widest flat
    # sweep: one K3 launch (its first kernel's workspace split it in eight)
    qi8, qs = queries(255)
    before = topk.LAUNCHES_INT8
    topk.scan_topk_int8_flat(m, scales, src, qi8, qs, allowed["all"], 8192, ns)
    if topk.LAUNCHES_INT8 != before + 1:
        raise SystemExit(f"K3 took {topk.LAUNCHES_INT8 - before} launches for 255 queries at k=8192")
    log(f"K3: 255 queries over {ns:,} rows at k=8192 took one launch  ok")

    # ties: every row 8 times over, so equal scores are everywhere (K3 at
    # k = 8,192 through its multi-block pass 2)
    tn = 262_144
    tm, tsc, tsrc = m[: tn // 8].repeat(8, 1).contiguous(), scales[: tn // 8].repeat(8), src[: tn // 8].repeat(8)
    for kid, fn, nq, k in (("K3", topk.scan_topk_int8_flat, 8, 64), ("K3", topk.scan_topk_int8_flat, 1, 8192),
                           ("K3", topk.scan_topk_int8_flat, 64, 512), ("K4", topk.scan_topk_int8_slab, 256, 64)):
        qi8, qs = queries(nq)
        got = fn(tm, tsc, tsrc, qi8, qs, allowed["all"], k)
        want = topk.scan_topk_int8_plain(tm, tsc, tsrc, qi8, qs, allowed["all"], k)
        v, r = got
        same = (v[:, 1:] == v[:, :-1]) & torch.isfinite(v[:, 1:])
        if not (torch_equal(got, want) and bool(same.any()) and bool((r[:, 1:][same] > r[:, :-1][same]).all())):
            raise SystemExit(f"{kid} tie order differs from the plain version (Q={nq}, k={k})")
    log("K3 (k 64, 512 and 8,192), K4 duplicated rows: bit-exact, equal scores order by the lower row  ok")
    del tm, tsc, tsrc

    # replays on one input: the CUDA cores at the main path's shape and deep
    # under a filter, the tensor cores
    for nq, k, fname in ((1, INT8_KB, "all"), (8, 8192, "2src"), (64, 512, "all")):
        qi8, qs = queries(nq)
        first = topk.scan_topk_int8_flat(m, scales, src, qi8, qs, allowed[fname], k, ns)
        check_case(f"K3 Q={nq:<4d} k={k:<5d} filter={fname:<4s} (replayed)", first,
                   topk.scan_topk_int8_plain(m, scales, src, qi8, qs, allowed[fname], k, ns), 0.0)
        replay("K3", f"Q={nq} k={k} filter={fname}",
               lambda: topk.scan_topk_int8_flat(m, scales, src, qi8, qs, allowed[fname], k, ns), first)

    live = int((src[:ns] >= 0).sum())
    keep = src[:ns] >= 0
    library = int8_yardstick(m[:ns], scales[:ns], keep)
    times = {}
    for kid, fn, nq in (("K3", topk.scan_topk_int8_flat, 1), ("K3", topk.scan_topk_int8_flat, 16),
                        ("K3", topk.scan_topk_int8_flat, 64), ("K3", topk.scan_topk_int8_flat, 255),
                        ("K4", topk.scan_topk_int8_slab, 512), ("K4", topk.scan_topk_int8_slab, 2048)):
        qi8, qs = queries(nq)
        k = INT8_KB
        t = {"ms": cuda_ms(lambda: fn(m, scales, src, qi8, qs, allowed["all"], k, ns)),
             "plain_ms": cuda_ms(lambda: topk.scan_topk_int8_plain(m, scales, src, qi8, qs, allowed["all"], k, ns))}
        t["library_ms"] = cuda_ms(lambda: library(qi8, qs, k)) if nq <= 512 else None
        t["bound_ms"], t["bound_by"] = scan_bound(live, ns, nq, k, 1, "int8")
        times[(kid, nq)] = t
        lib = "timed alone below" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
        log(f"{kid} time Q={nq} k={k} n_sweep={ns}: kernel {t['ms']:.4f} ms  plain {t['plain_ms']:.4f} ms  "
            f"library {lib}  bound {t['bound_ms']:.4f} ms ({t['bound_by']})  [{card}]")
    one_launch("K4", "LAUNCHES_INT8_SLAB", lambda: topk.scan_topk_int8_slab(
        m, scales, src, *queries(N_BATCH), allowed["all"], INT8_KB, ns), ns)
    k3_ladder(card, m, scales, src, ns, queries)
    qi8, qs = queries(512)
    depth_times(card, "K4", lambda k: topk.scan_topk_int8_slab(m, scales, src, qi8, qs, allowed["all"], k, ns), 512, ns)
    del library
    wide_library_ms(card, "K4", int8_yardstick(m[:ns], scales[:ns], keep), N_BATCH, ns, queries)
    del m, scales
    torch.cuda.empty_cache()
    return {"K3": {"max_abs_err": 0.0, **times[("K3", 1)]}, "K4": {"max_abs_err": 0.0, **times[("K4", 512)]}}


def k3_ladder(card: str, m, scales, src, ns: int, queries) -> None:
    """K3 at one query by depth on the escalation ladder, each rung beside
    its bound and its library call, and by width on either pass 1
    (``crossover_times``)."""
    from perceive_tpu_torch.ops import topk

    allowed = filters(m.device)["all"]
    live = int((src[:ns] >= 0).sum())
    library = int8_yardstick(m[:ns], scales[:ns], src[:ns] >= 0)
    qi8, qs = queries(1)
    depth_times(card, "K3", lambda k: topk.scan_topk_int8_flat(m, scales, src, qi8, qs, allowed, k, ns), 1, ns,
                INT8_LADDER, lambda k: scan_bound(live, ns, 1, k, 1, "int8"), lambda k: library(qi8, qs, k))
    crossover_times(card, "K3", "FLAT_ROWS_CORE_QUERIES", "int8",
                    lambda q, qsc: topk.scan_topk_int8_flat(m, scales, src, q, qsc, allowed, INT8_KB, ns), queries)


def int2_corpus(g, dev, n: int, hwm: int, dim: int = DIM):
    """Seeded unit rows as the int2 tier stores them, built on the card: the
    (dim/4, n) packed coarse matrix with its row scales (crumbs of the
    rows on the {-3, -1, 1, 3} * rms/2 grid) and the (dim, n) int8
    companion with its scales; source ids and the sweep prefix as
    corpus_rows gives them."""
    import torch

    chunks, src, ns = corpus_rows(g, dev, n, hwm, dim)
    d4 = dim // 4
    packed = torch.empty((d4, n), dtype=torch.uint8, device=dev)
    fine = torch.empty((dim, n), dtype=torch.int8, device=dev)
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
            replay("K5", f"Q={nq} filter={fname}", lambda: int2.int2_scores(packed, s2, src, qi8, qs, al, ns), got)
            for kc in INT2_KCS:
                vk, rk, fk = int2.select_topk(got, kc)
                vp, rp, fp = int2.select_topk_plain(got, kc)
                ok = torch.equal(vk, vp) and torch.equal(rk, rp) and torch.equal(fk, fp)
                log(f"K6 Q={nq:<4d} kc={kc:<5d} filter={fname:<4s} set, order and floor "
                    f"{'bit-exact ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit(f"K6 disagrees with its plain version (Q={nq}, kc={kc}, {fname})")
    # K6 on dense ties: every score of a row 8 times over, and on a row that
    # matches nothing; then the region's overflows: a filter that leaves
    # 1,000 finite scores (the kc-th key's bin holds every -inf row), and 64
    # values that all fall in one bin
    tied = scores[(8, "all")][:, : n // 8].repeat(1, 8).contiguous()
    tied[7] = float("-inf")
    few = torch.full((2, ns), float("-inf"), device=dev)
    few[0, torch.randperm(ns, generator=g, device=dev)[:1000]] = scores[(1, "all")][0, :1000]
    few[1] = 1.0 + (torch.arange(ns, device=dev) % 64).float() * 2.0**-20
    for name, rows_in in (("dense ties and an all -inf row", tied), ("1,000 finite and one-bin rows", few)):
        for kc in INT2_KCS + (16384,):
            got, want = int2.select_topk(rows_in, kc), int2.select_topk_plain(rows_in, kc)
            if not torch_equal(got, want):
                raise SystemExit(f"K6 disagrees with its plain version on {name} (kc={kc})")
        log(f"K6 {name}: bit-exact, lower row first  ok")
    del few
    first = int2.select_topk(scores[(1, "all")], 4096)
    replay("K6", "Q=1 kc=4096", lambda: int2.select_topk(scores[(1, "all")], 4096), first)

    k7_widths = crossover_widths((1, 8, 32), "FLAT_COLS_CORE_QUERIES", "int8")
    for kid, fn, widths, ks in (("K7", topk.scan_topk_int8t_flat, k7_widths, KS),
                                ("K8", topk.scan_topk_int8t_slab, (512, 2048), KS)):
        for nq in widths:
            qi8, qs = queries(nq)
            for k in ks:
                for fname, al in allowed.items():
                    got = fn(fine, s8, src, qi8, qs, al, k, ns)
                    want = topk.scan_topk_int8t_plain(fine, s8, src, qi8, qs, al, k, ns)
                    check_case(f"{kid} Q={nq:<4d} k={k:<5d} filter={fname:<4s}", got, want, 0.0)
    # ties: every column 8 times over, so equal scores are everywhere (K7
    # at k = 8,192 through its multi-block pass 2)
    tn = 262_144
    tf, tsc, tsrc = fine[:, : tn // 8].repeat(1, 8).contiguous(), s8[: tn // 8].repeat(8), src[: tn // 8].repeat(8)
    for kid, fn, nq, k in (("K7", topk.scan_topk_int8t_flat, 8, 64), ("K7", topk.scan_topk_int8t_flat, 1, 8192),
                           ("K8", topk.scan_topk_int8t_slab, 256, 64)):
        qi8, qs = queries(nq)
        got = fn(tf, tsc, tsrc, qi8, qs, allowed["all"], k)
        v, r = got
        same = (v[:, 1:] == v[:, :-1]) & torch.isfinite(v[:, 1:])
        if not (torch_equal(got, topk.scan_topk_int8t_plain(tf, tsc, tsrc, qi8, qs, allowed["all"], k))
                and bool(same.any()) and bool((r[:, 1:][same] > r[:, :-1][same]).all())):
            raise SystemExit(f"{kid} tie order differs from the plain version (Q={nq}, k={k})")
    log("K7 (k 64 and 8,192), K8 duplicated columns: bit-exact, equal scores order by the lower row  ok")
    del tf, tsc, tsrc

    live = int((src[:ns] >= 0).sum())
    keep = src[:ns] >= 0
    times = {}
    for nq in (1, 8):  # K5
        qi8, qs = queries(nq)
        t = {"ms": cuda_ms(lambda: int2.int2_scores(packed, s2, src, qi8, qs, allowed["all"], ns)),
             "plain_ms": cuda_ms(lambda: int2.int2_scores_plain(packed, s2, src, qi8, qs, allowed["all"], ns)),
             "library_ms": None}  # no single PyTorch call unpacks 2-bit crumbs
        t["bound_ms"], t["bound_by"] = int2_bound(ns, nq)
        times[("K5", nq)] = t
        log(f"K5 time Q={nq} n_sweep={ns}: kernel {t['ms']:.4f} ms  plain {t['plain_ms']:.4f} ms  "
            f"library n/a  bound {t['bound_ms']:.4f} ms ({t['bound_by']})  [{card}]")
    for nq, kc in ((1, 4096), (1, 1024), (1, 16384), (8, 4096)):  # K6
        times[("K6", nq, kc)] = k6_times(card, scores[(nq, "all")], kc)
    library = int8_yardstick(fine[:, :ns], s8[:ns], keep, cols=True)

    for kid, fn, nq in (("K7", topk.scan_topk_int8t_flat, 1), ("K7", topk.scan_topk_int8t_flat, 32),
                        ("K8", topk.scan_topk_int8t_slab, 512), ("K8", topk.scan_topk_int8t_slab, 2048)):
        qi8, qs = queries(nq)
        k = INT8_KB
        t = {"ms": cuda_ms(lambda: fn(fine, s8, src, qi8, qs, allowed["all"], k, ns)),
             "plain_ms": cuda_ms(lambda: topk.scan_topk_int8t_plain(fine, s8, src, qi8, qs, allowed["all"], k, ns))}
        t["library_ms"] = cuda_ms(lambda: library(qi8, qs, k)) if nq <= 512 else None
        t["bound_ms"], t["bound_by"] = scan_bound(live, ns, nq, k, 1, "int8")
        times[(kid, nq)] = t
        lib = "timed alone below" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
        log(f"{kid} time Q={nq} k={k} n_sweep={ns}: kernel {t['ms']:.4f} ms  plain {t['plain_ms']:.4f} ms  "
            f"library {lib}  bound {t['bound_ms']:.4f} ms ({t['bound_by']})  [{card}]")
    one_launch("K8", "LAUNCHES_INT8T_SLAB", lambda: topk.scan_topk_int8t_slab(
        fine, s8, src, *queries(N_BATCH), allowed["all"], INT8_KB, ns), ns)
    qi8, qs = queries(1)
    depth_times(card, "K7", lambda k: topk.scan_topk_int8t_flat(fine, s8, src, qi8, qs, allowed["all"], k, ns), 1, ns,
                INT8_LADDER, lambda k: scan_bound(live, ns, 1, k, 1, "int8"), lambda k: library(qi8, qs, k))
    qi8, qs = queries(512)
    depth_times(card, "K8", lambda k: topk.scan_topk_int8t_slab(fine, s8, src, qi8, qs, allowed["all"], k, ns), 512, ns)
    times["K10"] = check_tiletop(card, packed, s2, src, ns, allowed, queries, replays=True)
    k56 = times[("K5", 1)]["ms"] + times[("K6", 1, 4096)]["ms"]
    log(f"K10 at Q=1 kc=4096 n_sweep={ns}: {times['K10']['ms']:.4f} ms against K5 + K6 (scores written, "
        f"then the exact select) {k56:.4f} ms at the same shape  [{card}]")
    del packed, library, scores, tied
    wide_library_ms(card, "K8", int8_yardstick(fine[:, :ns], s8[:ns], keep, cols=True), N_BATCH, ns, queries)
    del fine
    torch.cuda.empty_cache()
    return {"K5": {"max_abs_err": 0.0, **times[("K5", 1)]}, "K6": {"max_abs_err": 0.0, **times[("K6", 1, 4096)]},
            "K7": {"max_abs_err": 0.0, **times[("K7", 1)]}, "K8": {"max_abs_err": 0.0, **times[("K8", 512)]},
            "K10": {"max_abs_err": 0.0, **times["K10"]}}


def k6_times(card: str, sc, kc: int, what: str = "") -> dict:
    """K6 over the (Q, n) scores ``sc`` at depth kc, timed beside its plain
    version, torch.topk and its bound: the scores read once, the (score,
    row) pairs and the floor written once."""
    import torch

    from perceive_tpu_torch.ops import int2

    nq, n = sc.shape
    t = {"ms": cuda_ms(lambda: int2.select_topk(sc, kc)),
         "plain_ms": cuda_ms(lambda: int2.select_topk_plain(sc, kc)),
         "library_ms": cuda_ms(lambda: torch.topk(sc, kc))}
    t["bound_ms"], t["bound_by"] = bound(nq * n * 4 + nq * kc * 8 + nq * 4, 0.0, "int8")
    log(f"K6 time Q={nq} kc={kc} n={n}{what}: kernel {t['ms']:.4f} ms  plain {t['plain_ms']:.4f} ms  "
        f"library {t['library_ms']:.4f} ms (torch.topk)  bound {t['bound_ms']:.4f} ms ({t['bound_by']})  [{card}]")
    return t


def tiletop_bound(ns: int, nq: int, width: int, dim: int = DIM):
    """Bound of K10: the sweep's packed bytes, scales and ids read once, the
    queries once, the (Q, T * M) (score, row) pairs written once; 2 * D
    int8 operations a row and query."""
    return bound(ns * (dim // 4 + 8) + nq * dim + nq * width * 8, 2.0 * nq * ns * dim, "int8")


def check_tiletop(card: str, packed, s2, src, ns: int, allowed: dict, queries, kc: int = 4096,
                  time_plain: bool = True, replays: bool = False) -> dict:
    """K10 against its plain version, vals and rows bit for bit, at Q = 1
    and Q = 8 under both filters over the sweep prefix ``ns`` (the rows
    carry 5% tombstones); then timed at Q = 1 and Q = 8 beside its plain
    version and its bound.  No single PyTorch call unpacks 2-bit crumbs:
    library_ms is null, and K5 + K6 at the same shape stand beside it.
    With ``replays``, K10 at Q = 1 is replayed 40 times on one input, and
    K6 over its buffer is held to its plain version, replayed and timed."""
    import torch

    from perceive_tpu_torch.ops import int2

    for nq in (1, 8):
        qi8, qs = queries(nq)
        tile = int2._pick_tile_int2(ns, nq, packed.shape[0])
        for fname, al in allowed.items():
            got = int2.int2_tiletop(packed, s2, src, qi8, qs, al, ns, kc=kc)
            want = int2.int2_tiletop_plain(packed, s2, src, qi8, qs, al, ns, kc=kc)
            same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            fills = int(torch.isneginf(got[0]).sum())
            log(f"K10 Q={nq:<4d} n={packed.shape[1]} n_sweep={ns} tile={tile} width={got[0].shape[1]} "
                f"filter={fname:<4s} -inf places {fills}: vals and rows {'bit-exact ok' if same else 'FAIL'}")
            if not same:
                raise SystemExit(f"K10 disagrees with its plain version (n={packed.shape[1]}, Q={nq}, {fname})")
    al = allowed["all"]
    times = {}
    for nq in (8, 1):
        qi8, qs = queries(nq)
        first = int2.int2_tiletop(packed, s2, src, qi8, qs, al, ns, kc=kc)
        width = first[0].shape[1]
        t = {"ms": cuda_ms(lambda: int2.int2_tiletop(packed, s2, src, qi8, qs, al, ns, kc=kc)),
             "plain_ms": (cuda_ms(lambda: int2.int2_tiletop_plain(packed, s2, src, qi8, qs, al, ns, kc=kc), reps=3)
                          if time_plain else math.nan),
             "library_ms": None}
        t["bound_ms"], t["bound_by"] = tiletop_bound(ns, nq, width, 4 * packed.shape[0])
        times[nq] = t
        log(f"K10 time Q={nq} kc={kc} n_sweep={ns} width={width}: kernel {t['ms']:.4f} ms  "
            f"plain {t['plain_ms']:.4f} ms  library n/a  bound {t['bound_ms']:.4f} ms ({t['bound_by']})  [{card}]")
    if replays:  # the Q = 1 input: the main path's shape
        replay("K10", f"Q=1 kc={kc}", lambda: int2.int2_tiletop(packed, s2, src, qi8, qs, al, ns, kc=kc), first)
        tvals = first[0]
        got, want = int2.select_topk(tvals, kc), int2.select_topk_plain(tvals, kc)
        if not torch_equal(got, want):
            raise SystemExit(f"K6 over K10's buffer disagrees with its plain version (width {width}, kc={kc})")
        log(f"K6 over K10's buffer Q=1 width={width} kc={kc}: set, order and floor bit-exact ok")
        replay("K6", f"K10's buffer kc={kc}", lambda: int2.select_topk(tvals, kc), got)
        k6_times(card, tvals, kc, " (K10's buffer)")
    return times[1]


def check_tiletop_top(card: str, dev) -> None:
    """K10 at the int2 tier's upper end: random crumbs and scales for
    INT2_TOP_ROWS rows generated on the card, source ids as corpus_rows
    gives them (the sweep prefix of INT2_TOP_HWM live rows)."""
    import torch

    from perceive_tpu_torch.index.matrix import sweep_rows_for
    from perceive_tpu_torch.ops import topk

    n = INT2_TOP_ROWS
    g = torch.Generator(device=dev).manual_seed(10)
    packed = torch.empty((DIM // 4, n), dtype=torch.uint8, device=dev)
    for lo in range(0, n, 1 << 22):
        hi = min(n, lo + (1 << 22))
        packed[:, lo:hi] = torch.randint(0, 256, (DIM // 4, hi - lo), generator=g, device=dev,
                                         dtype=torch.int32).to(torch.uint8)
    s2 = torch.rand((n,), generator=g, device=dev) * 0.015 + 0.005
    src = torch.randint(0, 3, (n,), generator=g, device=dev, dtype=torch.int32)
    src[torch.rand((n,), generator=g, device=dev) < 0.05] = -1
    src[INT2_TOP_HWM:] = -1
    ns = sweep_rows_for(INT2_TOP_HWM, n)

    def queries(nq):
        return topk.quantize_queries(torch.randn((nq, DIM), generator=g, device=dev))

    check_tiletop(card, packed, s2, src, ns, filters(dev), queries, time_plain=False)
    del packed, s2, src
    torch.cuda.empty_cache()


def int4_matrix(g, dev, n: int, dim: int = DIM):
    """Seeded unit rows as the int4 tier stores them, quantized on the card
    in chunks of 131,072 rows (f32 never holds the matrix: 38.7 GB at 25M
    rows): the (dim/2, n) packed matrix with its row scales (max|v| / 7),
    1% of its bytes with a low nibble of 0 (-8, which the tier's
    quantization never writes), and source ids with 5% tombstones."""
    import torch

    d2 = dim // 2
    packed = torch.empty((d2, n), dtype=torch.uint8, device=dev)
    scales = torch.empty((n,), dtype=torch.float32, device=dev)
    for lo in range(0, n, 131072):
        hi = min(n, lo + 131072)
        blk = torch.randn((hi - lo, dim), generator=g, device=dev)
        blk = blk / blk.norm(dim=1, keepdim=True)
        s = torch.clamp(blk.abs().amax(dim=1), min=1e-12) / 7.0
        v = torch.clamp(torch.round(blk / s[:, None]), -7, 7).to(torch.int32)
        b = (v[:, :d2] + 8) | ((v[:, d2:] & 15) << 4)
        b = torch.where(torch.rand(b.shape, generator=g, device=dev) < 0.01, b & 0xF0, b)
        packed[:, lo:hi] = b.to(torch.uint8).T
        scales[lo:hi] = s
    src = torch.randint(0, 3, (n,), generator=g, device=dev, dtype=torch.int32)
    src[torch.rand((n,), generator=g, device=dev) < 0.05] = -1
    return packed, scales, src


def check_int4_kernels(card: str) -> dict:
    """K9, flat and slab, at 25,165,824 x 384 packed int4, bit for bit; K7
    and K8 over the same rows unpacked to int8 return the same answers and
    are timed beside it; a sweep of 2,048 queries is one slab launch.  Then
    K9's slab kernel bit for bit and timed at 34,603,008 rows."""
    import torch

    from perceive_tpu_torch.index.matrix import sweep_rows_for
    from perceive_tpu_torch.ops import topk

    dev = torch.device("cuda:0")
    n = INT4_KERNEL_ROWS
    g = torch.Generator(device=dev).manual_seed(7)
    packed, scales, src = int4_matrix(g, dev, n)
    prefix = sweep_rows_for(22_000_000, n)  # a prefix sweep, as a matrix with 22M live rows gives
    allowed = filters(dev)
    flat, slab, plain = topk.scan_topk_int4_flat, topk.scan_topk_int4_slab, topk.scan_topk_int4_plain

    def queries(nq):
        return topk.quantize_queries(torch.randn((nq, DIM), generator=g, device=dev))

    cross = tuple(("K9-flat", flat, nq, (INT4_KB, 8192), ("all",))
                  for nq in crossover_widths((), "FLAT_COLS_CORE_QUERIES", "int4"))
    for kid, fn, nq, ks, fnames in (("K9-flat", flat, 1, KS, ("all", "2src")),
                                    ("K9-flat", flat, 32, (16, INT4_KB, 8192), ("all",)), *cross,
                                    ("K9-slab", slab, 512, (16, INT4_KB, 1024), ("all", "2src")),
                                    ("K9-slab", slab, 2048, (INT4_KB,), ("all",))):
        qi8, qs = queries(nq)
        for k in ks:
            for fname in fnames:
                got = fn(packed, scales, src, qi8, qs, allowed[fname], k)
                want = plain(packed, scales, src, qi8, qs, allowed[fname], k)
                check_case(f"{kid} Q={nq:<4d} k={k:<5d} filter={fname:<4s} n_sweep={n}", got, want, 0.0)
        if nq in (1, 512):
            got = fn(packed, scales, src, qi8, qs, allowed["all"], INT4_KB, prefix)
            want = plain(packed, scales, src, qi8, qs, allowed["all"], INT4_KB, prefix)
            check_case(f"{kid} Q={nq:<4d} k={INT4_KB:<5d} filter=all  n_sweep={prefix}", got, want, 0.0)
    before = topk.LAUNCHES_INT4_SLAB
    topk.scan_topk_int4(packed, scales, src, torch.randn((300, DIM), generator=g, device=dev), allowed["all"], 16)
    if topk.LAUNCHES_INT4_SLAB != before + 1:
        raise SystemExit("scan_topk_int4 did not route a 300-query sweep to K9's slab kernel")

    # ties: every column 8 times over, so equal scores are everywhere
    tn = 262_144
    tp, tsc, tsrc = packed[:, : tn // 8].repeat(1, 8).contiguous(), scales[: tn // 8].repeat(8), src[: tn // 8].repeat(8)
    for kid, fn, nq, k in (("K9-flat", flat, 8, 64), ("K9-flat", flat, 1, 8192), ("K9-slab", slab, 256, 64)):
        qi8, qs = queries(nq)
        got = fn(tp, tsc, tsrc, qi8, qs, allowed["all"], k)
        v, r = got
        same = (v[:, 1:] == v[:, :-1]) & torch.isfinite(v[:, 1:])
        if not (torch_equal(got, plain(tp, tsc, tsrc, qi8, qs, allowed["all"], k)) and bool(same.any())
                and bool((r[:, 1:][same] > r[:, :-1][same]).all())):
            raise SystemExit(f"{kid} tie order differs from the plain version (Q={nq}, k={k})")
    log("K9 flat (k 64 and 8,192) and slab, duplicated rows: bit-exact, equal scores order by the lower row  ok")
    del tp, tsc, tsrc

    # the same rows unpacked to the int8 (D, N) layout of the int2 tier's
    # companion: K7 and K8 must give K9's answers, and are timed beside it
    m8 = torch.empty((DIM, n), dtype=torch.int8, device=dev)
    for lo in range(0, n, 1 << 20):
        m8[:, lo : lo + (1 << 20)] = topk.unpack_int4(packed[:, lo : lo + (1 << 20)])
    live = int((src >= 0).sum())
    times = {}
    for kid, fn, yard, nq in (("K9-flat", flat, topk.scan_topk_int8t_flat, 1),
                              ("K9-flat", flat, topk.scan_topk_int8t_flat, 32),
                              ("K9-slab", slab, topk.scan_topk_int8t_slab, 512),
                              ("K9-slab", slab, topk.scan_topk_int8t_slab, 2048)):
        qi8, qs = queries(nq)
        k, al = INT4_KB, allowed["all"]
        before = topk.LAUNCHES_INT4_SLAB
        got = fn(packed, scales, src, qi8, qs, al, k)
        if kid == "K9-slab" and topk.LAUNCHES_INT4_SLAB != before + 1:
            raise SystemExit(f"K9's slab kernel took {topk.LAUNCHES_INT4_SLAB - before} launches for {nq} queries")
        if not torch_equal(got, yard(m8, scales, src, qi8, qs, al, k)):
            raise SystemExit(f"{kid} Q={nq}: the int8 kernel over the unpacked rows answers differently")
        # a sweep of 2,048 queries takes seconds: one cold run each, and
        # the plain version (several seconds more) is timed at the record's
        # widths only
        wide = nq == 2048
        t = {"ms": cuda_ms(lambda: fn(packed, scales, src, qi8, qs, al, k), reps=1 if wide else 20, warmup=0 if wide else 1),
             "plain_ms": None if wide else cuda_ms(lambda: plain(packed, scales, src, qi8, qs, al, k), reps=3, warmup=0),
             "library_ms": None,  # no single PyTorch call unpacks nibbles
             "int8_ms": cuda_ms(lambda: yard(m8, scales, src, qi8, qs, al, k), reps=1 if wide else 20,
                                warmup=0 if wide else 1)}
        t["bound_ms"], t["bound_by"] = int4_bound(live, n, nq, k)
        times[(kid, nq)] = t
        plain_txt = "not timed" if t["plain_ms"] is None else f"{t['plain_ms']:.4f} ms"
        log(f"{kid} time Q={nq} k={k} n_sweep={n}: kernel {t['ms']:.4f} ms{' (one cold run)' if wide else ''}  "
            f"plain {plain_txt}  library n/a  bound {t['bound_ms']:.4f} ms ({t['bound_by']})  "
            f"{'K7' if kid == 'K9-flat' else 'K8'} on the rows unpacked to int8 {t['int8_ms']:.4f} ms  [{card}]")
    log(f"K9-slab: {N_BATCH} queries over {n:,} rows at k={INT4_KB} took one launch  ok")
    # the escalation ladder's top rung for a 32-query sweep: one launch (the
    # first kernel's workspace split it in two, each re-reading the matrix)
    qi8, qs = queries(32)
    before = topk.LAUNCHES_INT4
    flat(packed, scales, src, qi8, qs, allowed["all"], 8192)
    if topk.LAUNCHES_INT4 != before + 1:
        raise SystemExit(f"K9 flat took {topk.LAUNCHES_INT4 - before} launches for 32 queries at k=8192")
    ms = cuda_ms(lambda: flat(packed, scales, src, qi8, qs, allowed["all"], 8192), reps=3, warmup=0)
    log(f"K9-flat: 32 queries over {n:,} rows at k=8192 took one launch ({ms:.4f} ms)  ok  [{card}]")
    qi8, qs = queries(1)
    for ns in (INT4_SLICE_ROWS, n):  # the int4 slice's sweep, and the tier's own size
        live_ns = int((src[:ns] >= 0).sum())
        depth_times(card, "K9-flat", lambda k: flat(packed, scales, src, qi8, qs, allowed["all"], k, ns), 1, ns,
                    K9_LADDER, lambda k: int4_bound(live_ns, ns, 1, k))
    del packed, scales, src, m8
    torch.cuda.empty_cache()

    # past 33,553,920 rows, where the first slab kernel's grid ran out
    n = INT4_WIDE_ROWS
    packed, scales, src = int4_matrix(g, dev, n)
    qi8, qs = queries(512)
    for fname in ("all", "2src"):
        got = slab(packed, scales, src, qi8, qs, allowed[fname], INT4_KB)
        want = plain(packed, scales, src, qi8, qs, allowed[fname], INT4_KB)
        check_case(f"K9-slab Q=512  k={INT4_KB:<5d} filter={fname:<4s} n_sweep={n}", got, want, 0.0)
    ms = cuda_ms(lambda: slab(packed, scales, src, qi8, qs, allowed["all"], INT4_KB), reps=1, warmup=0)
    live = int((src >= 0).sum())
    b, by = int4_bound(live, n, 512, INT4_KB)
    log(f"K9-slab time Q=512 k={INT4_KB} n_sweep={n}: kernel {ms:.4f} ms (one cold run)  "
        f"bound {b:.4f} ms ({by})  [{card}]")
    check_wide_int8(card, packed, scales, src, queries, allowed)
    del packed, scales, src
    torch.cuda.empty_cache()
    return {"flat": {"max_abs_err": 0.0, **times[("K9-flat", 1)]},
            "slab": {"max_abs_err": 0.0, **times[("K9-slab", 512)]}}


def check_wide_int8(card: str, packed, scales, src, queries, allowed: dict) -> None:
    """K4 and K8 past 33,553,920 rows, where their first kernels' grid ran
    out: the packed rows of K9's wide check unpacked to the int2 tier's
    (D, N) int8 companion layout (K8) and transposed to (N, D) int8 rows
    (K4), with the same scales.  At Q = 256 and INT8_KB, under both
    filters, K4, K8 and K9's slab kernel give the same answers bit for bit,
    and the plain version's on the 2-source filter (K9's plain version:
    the int8 ones would hold the matrix in f32, 53 GB); one cold run of
    each is timed beside its bound."""
    import torch

    from perceive_tpu_torch.ops import topk

    n, dev, step = packed.shape[1], packed.device, 1 << 20
    m8 = torch.empty((DIM, n), dtype=torch.int8, device=dev)
    for lo in range(0, n, step):
        m8[:, lo : lo + step] = topk.unpack_int4(packed[:, lo : lo + step])
    rows = torch.empty((n, DIM), dtype=torch.int8, device=dev)
    for lo in range(0, n, step):
        rows[lo : lo + step] = m8[:, lo : lo + step].T
    kernels = (("K9-slab", topk.scan_topk_int4_slab, packed), ("K8", topk.scan_topk_int8t_slab, m8),
               ("K4", topk.scan_topk_int8_slab, rows))
    qi8, qs = queries(256)
    k = INT8_KB
    for fname, al in allowed.items():
        got = {kid: fn(mat, scales, src, qi8, qs, al, k) for kid, fn, mat in kernels}
        if not (torch_equal(got["K8"], got["K9-slab"]) and torch_equal(got["K4"], got["K9-slab"])):
            raise SystemExit(f"K4, K8 and K9's slab kernel disagree at {n:,} rows (filter {fname})")
        log(f"K4, K8, K9-slab Q=256  k={k:<5d} filter={fname:<4s} n_sweep={n}: the same answers, bit-exact ok")
        if fname == "2src":
            want = topk.scan_topk_int4_plain(packed, scales, src, qi8, qs, al, k)
            check_case(f"K4 (= K8 = K9-slab) Q=256  k={k:<5d} filter={fname:<4s} n_sweep={n}", got["K4"], want, 0.0)
    live = int((src >= 0).sum())
    for kid, fn, mat in kernels:
        ms = cuda_ms(lambda: fn(mat, scales, src, qi8, qs, allowed["all"], k), reps=1, warmup=0)
        if kid == "K9-slab":
            b, by = int4_bound(live, n, 256, k)
        else:
            b, by = scan_bound(live, n, 256, k, 1, "int8")
        log(f"{kid} time Q=256 k={k} n_sweep={n}: kernel {ms:.4f} ms (one cold run)  "
            f"bound {b:.4f} ms ({by})  [{card}]")
    del m8, rows
    torch.cuda.empty_cache()


# the registry's other widths: where auto puts a 768-d corpus (rows x 768 /
# 384 effective rows: int8 past 1.5M, int2 past 4M, int4 past 24M) and the
# 512-d rows of distiluse-base-multilingual-cased's Dense head (bf16)
WIDE_DIM, DENSE_DIM = 768, 512
WIDE_INT8_ROWS, WIDE_INT8_HWM = 1_572_864, 1_400_000  # a sweep of 1,400,832 rows
WIDE_INT2_ROWS, WIDE_INT2_HWM = 4_194_304, 3_800_000  # a sweep of 3,809,280
WIDE_INT4_ROWS = 12_582_912
DENSE_ROWS, DENSE_HWM = 1_048_576, 950_000  # a sweep of 958,464


def timed_kernel(card: str, label: str, run, plain, library, bound_of) -> dict:
    """``run``'s time by CUDA events (the wrapper's host prologue inside)
    and by device time alone (``device_ms``), beside its plain version's
    (a median of 3: it repeats the kernel's arithmetic, no yardstick of
    speed), the library call's (``library`` None: no single PyTorch call
    computes it) and ``bound_of`` = (ms, what bounds it); logged on one
    line."""
    t = {"ms": cuda_ms(run), "device_ms": device_ms(run), "plain_ms": cuda_ms(plain, reps=3),
         "library_ms": None if library is None else cuda_ms(library)}
    t["bound_ms"], t["bound_by"] = bound_of
    lib = "n/a" if library is None else f"{t['library_ms']:.4f} ms"
    log(f"{label}: kernel {t['ms']:.4f} ms  device {t['device_ms']:.4f} ms  plain {t['plain_ms']:.4f} ms  "
        f"library {lib}  bound {t['bound_ms']:.4f} ms ({t['bound_by']})  [{card}]")
    return t


def check_wide_kernels(card: str) -> dict:
    """K1-K10 at the registry's other widths, at the row counts where the
    auto rule puts a corpus of that width: K3 (Q = 1, k = 128) and K4 (Q =
    512) over 1,572,864 x 768 int8; K5 + K6 (kc = 4,096), K7 (Q = 1, k =
    128), K10 (kc = 4,096) and K8 (Q = 512) over 4,194,304 x 768 int2 and
    its (768, N) int8 companion; K9 flat (Q = 1, k = 256) and slab (Q = 512)
    over 12,582,912 x 768 packed int4; K1 (Q = 1, k = 32) and K2 (Q = 512)
    over 1,048,576 x 512 bf16.  Each against its plain version under both
    filters (K3-K10 bit for bit, K1 and K2 within SCAN_TOL), then timed
    once (``timed_kernel``).  The rows are generated on the card, each
    matrix freed before the next."""
    import torch

    from perceive_tpu_torch.ops import int2, topk

    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(13)
    allowed = filters(dev)
    al = allowed["all"]
    out = {}

    def queries(nq, dim=WIDE_DIM):
        return topk.quantize_queries(torch.randn((nq, dim), generator=g, device=dev))

    def held(label, nq, k, ns, run, plain, tol=0.0):
        for fname, a in allowed.items():
            check_case(f"{label} Q={nq:<4d} k={k:<5d} filter={fname:<4s} n_sweep={ns}", run(a), plain(a), tol)

    # int8 rows: K3, K4
    m, scales, src, ns = int8_rows(g, dev, WIDE_INT8_ROWS, WIDE_INT8_HWM, WIDE_DIM)
    keep = src[:ns] >= 0
    live = int(keep.sum())
    library = int8_yardstick(m[:ns], scales[:ns], keep)
    for kid, fn, nq in (("K3", topk.scan_topk_int8_flat, 1), ("K4", topk.scan_topk_int8_slab, 512)):
        qi8, qs = queries(nq)
        held(f"{kid} D={WIDE_DIM}", nq, INT8_KB, ns, lambda a: fn(m, scales, src, qi8, qs, a, INT8_KB, ns),
             lambda a: topk.scan_topk_int8_plain(m, scales, src, qi8, qs, a, INT8_KB, ns))
        out[kid] = timed_kernel(
            card, f"{kid} time D={WIDE_DIM} Q={nq} k={INT8_KB} n_sweep={ns}",
            lambda: fn(m, scales, src, qi8, qs, al, INT8_KB, ns),
            lambda: topk.scan_topk_int8_plain(m, scales, src, qi8, qs, al, INT8_KB, ns),
            lambda: library(qi8, qs, INT8_KB), scan_bound(live, ns, nq, INT8_KB, 1, "int8", dim=WIDE_DIM))
    del m, scales, src, keep, library
    torch.cuda.empty_cache()

    # int2 rows and their int8 companion: K5, K6, K7, K10, K8
    packed, s2, fine, s8, src, ns = int2_corpus(g, dev, WIDE_INT2_ROWS, WIDE_INT2_HWM, WIDE_DIM)
    keep = src[:ns] >= 0
    live = int(keep.sum())
    qi8, qs = queries(1)
    for fname, a in allowed.items():
        got = int2.int2_scores(packed, s2, src, qi8, qs, a, ns)
        if not torch.equal(got, int2.int2_scores_plain(packed, s2, src, qi8, qs, a, ns)):
            raise SystemExit(f"K5 disagrees with its plain version at D={WIDE_DIM} (filter {fname})")
        if not torch_equal(int2.select_topk(got, 4096), int2.select_topk_plain(got, 4096)):
            raise SystemExit(f"K6 disagrees with its plain version over K5's D={WIDE_DIM} scores (filter {fname})")
        log(f"K5 D={WIDE_DIM} Q=1    n_sweep={ns} filter={fname:<4s} bit-exact ok; K6 kc=4096 over it: set, "
            f"order and floor bit-exact ok")
    out["K5"] = timed_kernel(card, f"K5 time D={WIDE_DIM} Q=1 n_sweep={ns}",
                             lambda: int2.int2_scores(packed, s2, src, qi8, qs, al, ns),
                             lambda: int2.int2_scores_plain(packed, s2, src, qi8, qs, al, ns), None,
                             int2_bound(ns, 1, WIDE_DIM))
    sc = int2.int2_scores(packed, s2, src, qi8, qs, al, ns)
    out["K6"] = timed_kernel(card, f"K6 time Q=1 kc=4096 n={ns} (K5's D={WIDE_DIM} scores)",
                             lambda: int2.select_topk(sc, 4096), lambda: int2.select_topk_plain(sc, 4096),
                             lambda: torch.topk(sc, 4096), bound(ns * 4 + 4096 * 8 + 4, 0.0, "int8"))
    del sc
    out["K10"] = check_tiletop(card, packed, s2, src, ns, allowed, queries)
    qi8, qs = queries(1)
    out["K10"]["device_ms"] = device_ms(lambda: int2.int2_tiletop(packed, s2, src, qi8, qs, al, ns, kc=4096))
    log(f"K10 time D={WIDE_DIM} Q=1 kc=4096 n_sweep={ns}: device {out['K10']['device_ms']:.4f} ms  [{card}]")
    library = int8_yardstick(fine[:, :ns], s8[:ns], keep, cols=True)
    for kid, fn, nq in (("K7", topk.scan_topk_int8t_flat, 1), ("K8", topk.scan_topk_int8t_slab, 512)):
        qi8, qs = queries(nq)
        held(f"{kid} D={WIDE_DIM}", nq, INT8_KB, ns, lambda a: fn(fine, s8, src, qi8, qs, a, INT8_KB, ns),
             lambda a: topk.scan_topk_int8t_plain(fine, s8, src, qi8, qs, a, INT8_KB, ns))
        out[kid] = timed_kernel(
            card, f"{kid} time D={WIDE_DIM} Q={nq} k={INT8_KB} n_sweep={ns}",
            lambda: fn(fine, s8, src, qi8, qs, al, INT8_KB, ns),
            lambda: topk.scan_topk_int8t_plain(fine, s8, src, qi8, qs, al, INT8_KB, ns),
            lambda: library(qi8, qs, INT8_KB), scan_bound(live, ns, nq, INT8_KB, 1, "int8", dim=WIDE_DIM))
    del packed, s2, fine, s8, src, keep, library
    torch.cuda.empty_cache()

    # packed int4 rows: K9 flat and slab over the whole matrix
    packed, scales, src = int4_matrix(g, dev, WIDE_INT4_ROWS, WIDE_DIM)
    n = WIDE_INT4_ROWS
    live = int((src >= 0).sum())
    for kid, fn, nq in (("K9-flat", topk.scan_topk_int4_flat, 1), ("K9-slab", topk.scan_topk_int4_slab, 512)):
        qi8, qs = queries(nq)
        held(f"{kid} D={WIDE_DIM}", nq, INT4_KB, n, lambda a: fn(packed, scales, src, qi8, qs, a, INT4_KB),
             lambda a: topk.scan_topk_int4_plain(packed, scales, src, qi8, qs, a, INT4_KB))
        out[kid] = timed_kernel(
            card, f"{kid} time D={WIDE_DIM} Q={nq} k={INT4_KB} n_sweep={n}",
            lambda: fn(packed, scales, src, qi8, qs, al, INT4_KB),
            lambda: topk.scan_topk_int4_plain(packed, scales, src, qi8, qs, al, INT4_KB), None,
            int4_bound(live, n, nq, INT4_KB, WIDE_DIM))
    del packed, scales, src
    torch.cuda.empty_cache()

    # bf16 rows at the Dense head's width: K1, K2 within SCAN_TOL
    chunks, src, ns = corpus_rows(g, dev, DENSE_ROWS, DENSE_HWM, DENSE_DIM)
    m = torch.empty((DENSE_ROWS, DENSE_DIM), dtype=torch.bfloat16, device=dev)
    for lo, blk in chunks:
        m[lo : lo + blk.shape[0]] = blk.to(torch.bfloat16)
    keep = src[:ns] >= 0
    live = int(keep.sum())
    for kid, fn, nq in (("K1", topk.scan_topk_flat, 1), ("K2", topk.scan_topk_slab, 512)):
        q = torch.randn((nq, DENSE_DIM), generator=g, device=dev)
        q /= q.norm(dim=1, keepdim=True)
        held(f"{kid} D={DENSE_DIM}", nq, BF16_KB, ns, lambda a: fn(m, src, q, a, BF16_KB, ns),
             lambda a: topk.scan_topk_plain(m, src, q, a, BF16_KB, ns), SCAN_TOL)
        out[kid] = timed_kernel(
            card, f"{kid} time D={DENSE_DIM} Q={nq} k={BF16_KB} n_sweep={ns}",
            lambda: fn(m, src, q, al, BF16_KB, ns), lambda: topk.scan_topk_plain(m, src, q, al, BF16_KB, ns),
            lambda: torch.topk(torch.matmul(q.to(torch.bfloat16), m[:ns].T).masked_fill(~keep, float("-inf")),
                               BF16_KB),
            scan_bound(live, ns, nq, BF16_KB, 2, "bf16", dim=DENSE_DIM))
    del m, src, keep
    torch.cuda.empty_cache()
    return out


def crossover_times(card: str, kid: str, table: str, key: str, run, queries) -> None:
    """Logs ``run(qi8, qscale)``'s time at Q = 1 to 128 on each of a flat
    scan's two pass 1s: the CUDA cores (tiles of up to 16 queries) and the
    batch kernel's wgmma pass 1 (tiles of 64), chosen by setting
    ``topk.<table>[key]`` (FLAT_ROWS_CORE_QUERIES for K1 and K3,
    FLAT_COLS_CORE_QUERIES for K7 and K9 flat) for the call: the measure
    behind its value.  A tree without that table routes by no crossover:
    its one route is timed."""
    from perceive_tpu_torch.ops import topk

    routes = getattr(topk, table, None)
    saved = routes[key] if routes else None
    try:
        for nq in (1, 2, 4, 8, 16, 32, 64, 96, 128):
            qi8, qs = queries(nq)
            t = {}
            for route, cross in ((("CUDA cores", 255), ("tensor cores", 0)) if routes else (("one route", None),)):
                if routes:
                    routes[key] = cross
                t[route] = cuda_ms(lambda: run(qi8, qs))
            log(f"{kid} crossover Q={nq}: " + "  ".join(f"{r} {ms:.4f} ms" for r, ms in t.items()) + f"  [{card}]")
    finally:
        if routes:
            routes[key] = saved


def ladders(card: str) -> None:
    """``--ladder``: K1 at 1, 16 and 64 queries over the bf16 slice's
    958,464-row sweep, by CUDA events and by device time (``device_ms``);
    the flat scans by depth on the escalation ladder at the main path's
    shapes (K3 over the int8 slice's 2,064,384-row sweep, K7 over the int2
    slice's 3,809,280-row companion sweep, K9 flat over the int4 slice's
    4,194,304 rows and the tier's own 25,165,824) and each width on either
    pass 1 (``crossover_times``); K3 at one query and K5, K10 and K6 (over
    K5's scores at kc = 4,096, and at 1,024 and 16,384 at one query, and
    over K10's buffer) at 1 and 8 queries over the int2 slice's sweep by
    device time too.  Uses only the
    wrappers' public names, so a copy of this script times an older tree's
    package the same way: run it in each of two trees in turns to compare
    them on one card."""
    import torch

    from perceive_tpu_torch.ops import int2, topk

    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(5)
    allowed = filters(dev)["all"]

    def queries(nq):
        return topk.quantize_queries(torch.randn((nq, DIM), generator=g, device=dev))

    chunks, src, ns = corpus_rows(g, dev, 1_048_576, 950_000)
    m = torch.empty((1_048_576, DIM), dtype=torch.bfloat16, device=dev)
    for lo, blk in chunks:
        m[lo : lo + blk.shape[0]] = blk.to(torch.bfloat16)
    for nq in (1, 16, 64):
        q = torch.randn((nq, DIM), generator=g, device=dev)
        run = lambda: topk.scan_topk_flat(m, src, q, allowed, BF16_KB, ns)  # noqa: E731
        log(f"K1 time Q={nq} k={BF16_KB} n_sweep={ns}: events {cuda_ms(run):.4f} ms  device {device_ms(run):.4f} ms  "
            f"[{card}]")
    del m, src
    torch.cuda.empty_cache()
    m, scales, src, ns = int8_rows(g, dev, 2_097_152, 1_900_000)
    k3_ladder(card, m, scales, src, ns, queries)
    qi8, qs = queries(1)
    run = lambda: topk.scan_topk_int8_flat(m, scales, src, qi8, qs, allowed, INT8_KB, ns)  # noqa: E731
    log(f"K3 time Q=1 k={INT8_KB} n_sweep={ns}: events {cuda_ms(run):.4f} ms  device {device_ms(run):.4f} ms  [{card}]")
    del m, scales, src
    torch.cuda.empty_cache()
    packed, s2, fine, s8, src, ns = int2_corpus(g, dev, 4_194_304, 3_800_000)
    live = int((src[:ns] >= 0).sum())
    for nq in (1, 8):
        qi8, qs = queries(nq)
        run = lambda: int2.int2_scores(packed, s2, src, qi8, qs, allowed, ns)  # noqa: E731
        log(f"K5 time Q={nq} n_sweep={ns}: kernel {cuda_ms(run):.4f} ms  device {device_ms(run):.4f} ms  "
            f"bound {int2_bound(ns, nq)[0]:.4f} ms  [{card}]")
        # K6 over those scores, K10 over the same rows, and K6 over K10's buffer
        sc = run()
        for kc in ((4096, 1024, 16384) if nq == 1 else (4096,)):
            run6 = lambda: int2.select_topk(sc, kc)  # noqa: E731
            log(f"K6 time Q={nq} kc={kc} n={ns}: events {cuda_ms(run6):.4f} ms  device {device_ms(run6):.4f} ms  "
                f"torch.topk {cuda_ms(lambda: torch.topk(sc, kc)):.4f} ms  "
                f"bound {bound(nq * ns * 4 + nq * kc * 8 + nq * 4, 0.0, 'int8')[0]:.4f} ms  [{card}]")
            log(f"K6 device time by kernel Q={nq} kc={kc} n={ns} (ms): {device_split(run6)}")
        run10 = lambda: int2.int2_tiletop(packed, s2, src, qi8, qs, allowed, ns, kc=4096)  # noqa: E731
        tvals = run10()[0]
        log(f"K10 time Q={nq} kc=4096 n_sweep={ns}: events {cuda_ms(run10):.4f} ms  device {device_ms(run10):.4f} ms  "
            f"bound {tiletop_bound(ns, nq, tvals.shape[1])[0]:.4f} ms  [{card}]")
        run6 = lambda: int2.select_topk(tvals, 4096)  # noqa: E731
        log(f"K6 time Q={nq} kc=4096 n={tvals.shape[1]} (K10's buffer): events {cuda_ms(run6):.4f} ms  "
            f"device {device_ms(run6):.4f} ms  [{card}]")
        log(f"K6 device time by kernel Q={nq} kc=4096 n={tvals.shape[1]} (ms): {device_split(run6)}")
        del sc, tvals
    del packed, s2
    qi8, qs = queries(1)
    library = int8_yardstick(fine[:, :ns], s8[:ns], src[:ns] >= 0, cols=True)
    depth_times(card, "K7", lambda k: topk.scan_topk_int8t_flat(fine, s8, src, qi8, qs, allowed, k, ns), 1, ns,
                INT8_LADDER, lambda k: scan_bound(live, ns, 1, k, 1, "int8"), lambda k: library(qi8, qs, k))
    crossover_times(card, "K7", "FLAT_COLS_CORE_QUERIES", "int8",
                    lambda q, qsc: topk.scan_topk_int8t_flat(fine, s8, src, q, qsc, allowed, INT8_KB, ns), queries)
    del fine, s8, src, library
    torch.cuda.empty_cache()
    packed, scales, src = int4_matrix(g, dev, INT4_KERNEL_ROWS)
    flat = topk.scan_topk_int4_flat
    for ns in (INT4_SLICE_ROWS, INT4_KERNEL_ROWS):
        live = int((src[:ns] >= 0).sum())
        depth_times(card, "K9-flat", lambda k: flat(packed, scales, src, qi8, qs, allowed, k, ns), 1, ns, K9_LADDER,
                    lambda k: int4_bound(live, ns, 1, k))
    crossover_times(card, "K9-flat", "FLAT_COLS_CORE_QUERIES", "int4",
                    lambda q, qsc: flat(packed, scales, src, q, qsc, allowed, INT4_KB, INT4_SLICE_ROWS), queries)
    del packed, scales, src
    torch.cuda.empty_cache()


# -- phase 5: K11 ------------------------------------------------------------


K11_BUCKETS = (128, 256, 384, 512)  # the encoder's sequence buckets, timed at (64, S, 12, 32)


def check_k11(card: str) -> dict:
    """K11 (bf16 tensor-core path) against its plain version at 1e-2 on
    every timed shape and on masks with whole padded key tiles and one kept
    key; timed beside its plain version, SDPA and, at every encoder bucket,
    the short-bucket route (``xla_attention_plain``).  The ingest path's
    shape is a batch of EMBED_BATCH_SIZE windows at the 512 bucket (the
    plain versions run it 64 rows of the batch at a time, which computes the
    same function in a sixteenth of the memory), at head width 32 (MiniLM)
    and 64 (the 768-wide tokenizer.json families, also at a batch of 64),
    each logged on its own line; the kernels record keeps (64, 512, 12,
    32), as every earlier run recorded it."""
    import torch

    from perceive_tpu_torch.ops import attention as attn
    from perceive_tpu_torch.sources.pipeline import EMBED_BATCH_SIZE

    def by_64(fn):
        def run(q, k, v, mask):
            if len(q) <= 64:
                return fn(q, k, v, mask)
            return torch.cat([fn(q[i : i + 64], k[i : i + 64], v[i : i + 64], mask[i : i + 64])
                              for i in range(0, len(q), 64)])
        return run

    plain, short_route = by_64(attn.attention_plain), by_64(attn.xla_attention_plain)

    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(2)
    worst, times = 0.0, {}

    def inputs(b, s, nh, dh):
        # unit-variance q and k (scores ~ N(0, 1)); v at half scale keeps
        # |out| near 1, where one bf16 rounding of the output is ~4e-3
        q, k, v = ((torch.randn((b, s, nh, dh), generator=g, device=dev) * sd).to(torch.bfloat16)
                   for sd in (1.0, 1.0, 0.5))
        lens = torch.randint(1, s + 1, (b,), generator=g, device=dev)
        mask = (torch.arange(s, device=dev)[None, :] < lens[:, None]).to(torch.int32)
        return q, k, v, mask

    def held(name, q, k, v, mask):
        got = attn.attention(q, k, v, mask)
        want = plain(q.float(), k.float(), v.float(), mask)
        torch.cuda.synchronize()
        err = float((got.float() - want).abs().max())
        status = "ok" if err <= 1e-2 else "FAIL"
        log(f"K11 {name} max_abs_err={err:.3g} (vs f32 plain; max |out| {float(want.abs().max()):.3g}) {status}")
        if status != "ok":
            raise SystemExit(f"K11 disagrees with its plain version at {name}")
        return err

    ingest = (EMBED_BATCH_SIZE, 512, 12, 32)
    # then head width 64, the tokenizer.json families' (768 wide, 12 heads):
    # a batch of 64 and the ingest path's batch at the 512 bucket
    shapes = [(64, s, 12, 32) for s in K11_BUCKETS] + [(8, 512, 12, 64), ingest, (64, 512, 12, 64),
                                                       (EMBED_BATCH_SIZE, 512, 12, 64)]
    for b, s, nh, dh in shapes:
        q, k, v, mask = inputs(b, s, nh, dh)
        worst = max(worst, held(f"B={b} S={s} NH={nh} DH={dh}", q, k, v, mask))
        if (b, s, dh) == (64, 512, 32):
            # whole padded key tiles (rows of 1 to 64 tokens), one kept key, none kept
            pos = torch.arange(s, device=dev)[None, :]
            short = (pos < torch.randint(1, 65, (b, 1), generator=g, device=dev)).to(torch.int32)
            one = (pos == torch.randint(0, s, (b, 1), generator=g, device=dev)).to(torch.int32)
            one[0] = 0
            worst = max(worst, held(f"B={b} S={s} short rows", q, k, v, short))
            worst = max(worst, held(f"B={b} S={s} one kept key (row 0: none)", q, k, v, one))
        # the yardsticks: PyTorch's fused attention with the additive mask,
        # and the encoder's short-bucket route
        add = ((1.0 - mask.to(torch.bfloat16)) * -1e9).to(torch.bfloat16)[:, None, None, :]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        t = {"ms": cuda_ms(lambda: attn.attention(q, k, v, mask)),
             "plain_ms": cuda_ms(lambda: plain(q, k, v, mask)),
             "library_ms": cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=add)),
             "short_route_ms": cuda_ms(lambda: short_route(q, k, v, mask))}
        # q and the mask read and the output written once, the K and V rows
        # of kept keys read once; q.k and p.v at 2 ops a product and one
        # exponential for each (query, kept key) pair: masked keys add
        # exactly nothing, so the function needs none of their work
        live = int(mask.sum())
        t["bound_ms"], t["bound_by"] = bound(2 * (b * s + live) * nh * dh * 2 + b * s * 4,
                                             4.0 * nh * s * live * dh, "bf16", transcendentals=float(nh * s * live))
        times[(b, s, nh, dh)] = t
        log(f"K11 time B={b} S={s} NH={nh} DH={dh}: kernel {t['ms']:.4f} ms  plain {t['plain_ms']:.4f} ms  "
            f"library {t['library_ms']:.4f} ms  short-bucket route {t['short_route_ms']:.4f} ms  "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']})  [{card}]")
    out = dict(times[(64, 512, 12, 32)])
    del out["short_route_ms"]
    return {"max_abs_err": worst, **out}


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


SYLLABLES = [c + v for c in "bcdfghjklmnprstvz" for v in "aeiou"]  # the generated words' syllables


def minilm_vocab(size: int = 30522) -> list[str]:
    """A deterministic 30522-entry WordPiece vocabulary: specials, the
    single-character pieces of tiny_test_vocab, then generated words and
    their continuation syllables."""
    from perceive_tpu_torch.models.tokenize import tiny_test_vocab

    base = tiny_test_vocab([])
    words = list(base)
    syll = SYLLABLES
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


def text_queries(rng, docs: list[str], vocab: list[str]) -> tuple:
    """The 16 text queries of the bf16 slice: 8 documents' own texts (their
    indices first), 8 random word lists."""
    self_docs = [N_LONG + i * ((N_DOCS - N_LONG) // N_SELF_QUERIES) for i in range(N_SELF_QUERIES)]
    queries = [docs[d] for d in self_docs]
    words = vocab[200:]
    for _ in range(16 - N_SELF_QUERIES):
        queries.append(" ".join(words[j] for j in rng.integers(0, len(words), int(rng.integers(3, 9)))))
    return self_docs, queries


FILLER_CHUNK = 500_000  # filler rows a transaction


def filler_vectors(gen, n: int, dim: int = DIM, norms=None):
    """``n`` seeded ``dim``-wide unit vectors drawn on the card from ``gen``
    (a torch.Generator there), in host chunks of FILLER_CHUNK rows; with
    ``norms`` (a 1-d array: a model's stored vectors' norms, where it
    writes unnormalized rows) each is scaled to one of them, drawn at
    random."""
    import torch

    for lo in range(0, n, FILLER_CHUNK):
        c = min(FILLER_CHUNK, n - lo)
        v = torch.randn((c, dim), generator=gen, device=gen.device)
        v = v / v.norm(dim=1, keepdim=True)
        if norms is not None:
            pick = torch.randint(0, len(norms), (c,), generator=gen, device=gen.device)
            v *= torch.as_tensor(norms, dtype=torch.float32, device=gen.device)[pick, None]
        yield v.cpu().numpy()


def write_filler(db, src_id: int, first_id: int, first_seq: int, n: int, gen, text: str, mid: int, ver: int,
                 dim: int = DIM, norms=None, vectors=None):
    """``n`` seeded ``dim``-wide unit-vector rows under ids first_id.. with one embedding
    each, through the columns the ingest pipeline writes; the vectors are
    ``filler_vectors(gen, n, dim, norms)`` (SQLite takes the time), or the
    host chunks ``vectors`` drawn so before.
    ``db`` is an open Database, or the path of one that no connection holds
    open: then the rows go in through a connection of their own with no
    journal, no sync and no foreign-key lookups (every row it writes is
    valid), and the database is back in WAL mode after it."""
    import sqlite3

    own = isinstance(db, str)
    if own:
        conn = sqlite3.connect(db, isolation_level=None)
        for pragma in ("journal_mode = OFF", "synchronous = OFF", "foreign_keys = OFF"):
            conn.execute(f"PRAGMA {pragma}")
    if vectors is None:
        vectors = filler_vectors(gen, n, dim, norms)
    try:
        for lo, v in zip(range(0, n, FILLER_CHUNK), vectors):
            c = len(v)
            ids = range(first_id + lo, first_id + lo + c)
            with (contextlib.nullcontext(conn) if own else db.write()) as txn:
                if own:
                    txn.execute("BEGIN")
                txn.executemany(
                    """INSERT INTO items (id, source_id, external_id, version, hash, content,
                         process_version) VALUES (?,?,?,?,?,?,?)""",
                    ((i, src_id, f"fill{i}", 1, "", text, 0) for i in ids),
                )
                txn.executemany(
                    """INSERT INTO item_embeddings (item_id, chunk_idx, item_index_version, embedding,
                         model_id, model_version, seq) VALUES (?,?,?,?,?,?,?)""",
                    ((i, 0, 1, v[j].tobytes(), mid, ver, first_seq + lo + j) for j, i in enumerate(ids)),
                )
                if own:
                    txn.execute("COMMIT")
    finally:
        if own:
            conn.execute("PRAGMA journal_mode = WAL")
            conn.close()


SLICE_FILLER = (INT8_ROWS - TOTAL_ROWS, INT2_ROWS - INT8_ROWS)  # the int8 and int2 slices' filler rows


def slice_filler(ctx: dict, vectors: list) -> dict:
    """The int8 and int2 slices' filler rows (``vectors``: their host
    chunks, drawn by ``filler_vectors`` from the slices' generator on the
    main thread), written by worker processes (``filler_job``) while the
    kernel checks run (nothing holds the slices' database open then):
    INT8_ROWS - TOTAL_ROWS rows into the database, then a copy of it
    (``int2_db``, the int2 slice's, with the bf16 base in its manifest as
    before) takes the INT2_ROWS - INT8_ROWS more.  The ids and seqs follow
    on from the bf16 slice's rows, as before; returns the seconds of each
    step."""
    ctx["int2_db"] = os.path.join(os.path.dirname(ctx["db_path"]), "int2.sqlite3")
    int8 = filler_job(ctx, ctx["db_path"], SLICE_FILLER[0], vectors[0])
    int2 = filler_job(ctx, ctx["int2_db"], SLICE_FILLER[1], vectors[1], copy_from=ctx["db_path"])
    return {"int8_s": int8["seconds"], "copy_s": int2["copy_s"], "int2_s": int2["seconds"]}


def host_job(kind: str, job: dict, chunks=()) -> dict:
    """Runs ``kind`` ("filler" or "checkpoints") in a process of its own
    (``python3 chip_smoke.py --worker``): the job as one JSON line on its
    stdin, then the filler's f32 rows, chunk by chunk; returns the JSON line
    it answers.  The smoke's own threads only wait on the pipe, so the
    SQLite writes and the checkpoints' pickling hold no interpreter lock
    that the kernel checks beside them need (a writer thread in this
    process doubled a kernel wrapper's host time)."""
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker"], stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE)
    try:
        proc.stdin.write((json.dumps({"kind": kind, **job}) + "\n").encode())
        for chunk in chunks:
            proc.stdin.write(np.ascontiguousarray(chunk, dtype="<f4").data)
        proc.stdin.close()
        out = proc.stdout.read()
        rc = proc.wait()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc != 0:
        raise SystemExit(f"the {kind} worker exited {rc} (its errors above)")
    return json.loads(out)


def worker() -> int:
    """``--worker``: one ``host_job`` read from stdin.  "filler": optionally
    a copy of the database ``copy_from`` first (SQLite's backup), then
    ``write_filler`` of the ``n`` rows that follow on stdin; "checkpoints":
    ``install_checkpoints``.  Answers one JSON line of seconds."""
    import sqlite3

    stdin = sys.stdin.buffer
    job = json.loads(stdin.readline())
    out = {}
    if job["kind"] == "checkpoints":
        import torch

        torch.set_num_threads(2)  # beside the smoke's own host work
        out = install_checkpoints(job["models_dir"])
    else:
        if job.get("copy_from"):
            t0 = time.perf_counter()
            with contextlib.closing(sqlite3.connect(job["copy_from"])) as src, \
                    contextlib.closing(sqlite3.connect(job["db"])) as dst:
                src.backup(dst)
            out["copy_s"] = time.perf_counter() - t0
        n, dim = job["n"], job["dim"]

        def chunks():
            for lo in range(0, n, FILLER_CHUNK):
                c = min(FILLER_CHUNK, n - lo)
                yield np.frombuffer(stdin.read(c * dim * 4), dtype="<f4").reshape(c, dim)

        t0 = time.perf_counter()
        write_filler(job["db"], job["src"], job["first_id"], job["first_seq"], n, None, job["text"], job["mid"],
                     job["ver"], dim=dim, vectors=chunks())
        out["seconds"] = time.perf_counter() - t0
    sys.stdout.write(json.dumps(out))
    return 0


def filler_job(ctx: dict, db: str, n: int, chunks, dim: int = DIM, mid=None, copy_from: str = "") -> dict:
    """``host_job("filler")`` of ``n`` rows following on from ``ctx``'s ids
    and seqs (advanced past them) under the filler source and text of
    ``ctx``, the model's keys unless ``mid`` is given."""
    job = {"db": db, "src": ctx["fill_source"], "first_id": ctx["next_id"], "first_seq": ctx["next_seq"], "n": n,
           "dim": dim, "text": ctx["filler_text"], "mid": ctx["model"].model_id if mid is None else mid,
           "ver": 0 if mid is not None else ctx["model"].model_version, "copy_from": copy_from}
    ctx["next_id"] += n
    ctx["next_seq"] += n
    return host_job("filler", job, chunks)


def write_docs(docs_dir: str, docs: list[str]) -> None:
    """The documents as files doc{d}.txt, beside three that the walker must
    not ingest: a hidden file, a file under a directory named in a
    .gitignore, and an empty file."""
    os.makedirs(os.path.join(docs_dir, "skipped"))
    for d, text in enumerate(docs):
        with open(os.path.join(docs_dir, f"doc{d}.txt"), "w") as f:
            f.write(text)
    for name, text in ((".hidden.txt", docs[0]), (".gitignore", "skipped/\n"),
                       ("skipped/doc.txt", docs[1]), ("empty.txt", "")):
        with open(os.path.join(docs_dir, name), "w") as f:
            f.write(text)


# stored vs direct encode (bf16 encoder; a window rides other buckets in the
# two), as a share of the window's norm (bf16 rounding scales with it; the
# unit rows of a model with Normalize read the same as before).  On the H100
# the sound runs read 4.98e-4 and the planted fault below 9.54e-3 at its
# worst window: the tolerance sits between them, about 4x from each, and
# the run fails if the fault does not exceed it
INGEST_TOL = 2e-3
FAULT_SHIFT = 2  # the planted fault: each window after the first starts this many tokens late


def ingest(card: str, workdir: str, dev, model, docs: list[str]) -> dict:
    """Phase 6's ingest through the port's CLI: ``source add fs`` and
    ``source scan`` on a fresh database, with an AppState whose searcher
    takes the pipeline's hooks (``scan_and_check``)."""
    from perceive_tpu_torch.cli import AppState

    docs_dir = os.path.join(workdir, "docs")
    write_docs(docs_dir, docs)
    db_path = os.path.join(workdir, "smoke.sqlite3")
    state = AppState(db_path, model=model, highlights_model=model, device=dev)
    out = scan_and_check(card, state, db_path, docs_dir, docs)
    state.close()
    return out


def encode_windows(model, windows: list, width: int) -> np.ndarray:
    """Token windows through ``model`` in batches of ENCODE_BATCH, each
    batch packed with the special wrap and padded to ``width`` tokens; f32
    rows on the host."""
    import torch

    tok, out = model.tokenizer, []
    for s in range(0, len(windows), ENCODE_BATCH):
        ids = tok.pack_token_windows(windows[s : s + ENCODE_BATCH])
        ids = np.pad(ids, ((0, 0), (0, width - ids.shape[1])), constant_values=tok.pad_id)
        out.append(model.encode_ids(torch.from_numpy(ids).to(model.device)).float().cpu().numpy())
    return np.concatenate(out)


def scan_and_check(card: str, state, db_path: str, docs_dir: str, docs: list[str], tag: str = "ingest",
                   attention: bool = True) -> dict:
    """``source add fs`` and ``source scan`` of ``docs_dir`` through the CLI
    over the open ``state``, gated on exact counts (one item per document,
    one embedding row and one new matrix row per window of the port's
    chunker: a failed embed batch writes its items without their rows), K11
    launched during the scan (none where not ``attention``: windows below
    KERNEL_MIN_SEQ), and the stored vectors against a direct encode of the
    same windows, matched by (document, window)."""
    import importlib.util

    import torch

    from perceive_tpu_torch.cli import main as cli_main
    from perceive_tpu_torch.native import fastwalk_available
    from perceive_tpu_torch.ops import attention as attn
    from perceive_tpu_torch.sources import chunk_config, chunk_token_windows_batch

    model = state.model

    def cli(*argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli_main(["--db", db_path, *argv], state=state)
        for line in out.getvalue().splitlines():
            log(f"  cli: {line}")
        if rc != 0:
            raise SystemExit(f"{' '.join(argv[:2])} exited {rc}")
        return out.getvalue()

    cli("source", "add", "fs", docs_dir, "--name", "docs")
    src = state.source_by_name("docs")
    matrix_before = len(state.searcher.matrix)
    attn.LAUNCHES = 0  # the ingest path's count: this scan alone
    # the tokenizer's seconds inside the scan: its one caller there, the
    # embed stage's chunker, tokenizes between the stage's dispatches
    tok, tok_s = model.tokenizer, [0.0]
    untimed = tok.encode_untruncated

    def timed_encode(*args, **kwargs):
        t = time.perf_counter()
        try:
            return untimed(*args, **kwargs)
        finally:
            tok_s[0] += time.perf_counter() - t

    tok.encode_untruncated = timed_encode
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        out = cli("source", "scan", "docs")
    finally:
        del tok.encode_untruncated
    torch.cuda.synchronize()
    t_scan = time.perf_counter() - t0
    launches = attn.LAUNCHES

    conn = state.db.read()
    items = dict(conn.execute("SELECT external_id, id FROM items WHERE source_id = ?", (src.id,)).fetchall())
    index = {os.path.join(docs_dir, f"doc{d}.txt"): d for d in range(len(docs))}
    doc_ids = [items.get(ext) for ext in index]
    wins = chunk_token_windows_batch(model.tokenizer, docs, *chunk_config(src, model.tokenizer))
    n_win = sum(len(w) for w in wins)
    rows = conn.execute(
        """SELECT i.external_id, e.chunk_idx, e.embedding FROM item_embeddings e
           JOIN items i ON i.id = e.item_id WHERE i.source_id = ?""", (src.id,)).fetchall()
    n_matrix = len(state.searcher.matrix) - matrix_before
    log(f"{tag}: {len(items)} items, {len(rows)} embedding rows, {n_matrix} new matrix rows; "
        f"{n_win} windows from the port's chunker; K11 launches during the scan: {launches}")
    if len(items) != len(docs) or None in doc_ids:
        raise SystemExit(f"the scan wrote {len(items)} items; want exactly the {len(docs)} documents")
    if len(rows) != n_win:
        raise SystemExit(f"the scan wrote {len(rows)} embedding rows; want {n_win} (a failed embed batch?)")
    if n_matrix != n_win:
        raise SystemExit(f"the searcher's hooks put {n_matrix} rows in the matrix; want {n_win}")
    if attention and launches == 0:
        raise SystemExit("the ingest scan launched no attention kernel")
    if not attention and launches:
        raise SystemExit(f"the ingest scan's windows under {attn.KERNEL_MIN_SEQ} tokens launched K11 {launches} times")

    # the stored vectors against a direct encode of the same windows, each
    # padded to the sequence bucket of the longest window: every embed batch
    # of the scan held one (a document over 400 tokens fills a window), so
    # the two sides take the same attention route (K11 from 384 tokens on)
    stored = {(index[ext], c): np.frombuffer(b, dtype="<f4") for ext, c, b in rows}
    flat = [(d, c, w) for d, ws in enumerate(wins) for c, w in enumerate(ws)]
    width = model.tokenizer.pack_token_windows([max((w for _, _, w in flat), key=len)]).shape[1]
    embs = encode_windows(model, [w for _, _, w in flat], width)
    stored_embs = np.stack([stored[(d, c)] for d, c, _ in flat])
    norms = np.linalg.norm(embs, axis=1)
    err = float((np.abs(stored_embs - embs).max(axis=1) / norms).max())
    cos = float(((stored_embs * embs).sum(axis=1) / (np.linalg.norm(stored_embs, axis=1) * norms)).min())
    log(f"{tag}: stored vectors vs a direct encode of the same windows at {width} tokens: max_abs_err {err:.3g} "
        f"of the row's norm (tol {INGEST_TOL}; norms {norms.min():.4g} to {norms.max():.4g}), min cosine {cos:.6f}")
    if not err <= INGEST_TOL:
        raise SystemExit("the stored vectors disagree with a direct encode of their windows")
    # the gate's power: a chunker whose overlap is FAULT_SHIFT tokens short
    # starts every window after a document's first that many tokens late
    ct, co = chunk_config(src, model.tokenizer)
    late = chunk_token_windows_batch(model.tokenizer, docs, ct, co - FAULT_SHIFT)
    moved = [(d, c, w) for d, ws in enumerate(late) for c, w in enumerate(ws) if 0 < c < len(wins[d])]
    fault = encode_windows(model, [w for _, _, w in moved], width)
    at = {(d, c): i for i, (d, c, _) in enumerate(flat)}
    sound = [at[(d, c)] for d, c, _ in moved]
    fault_err = np.abs(fault - embs[sound]).max(axis=1) / norms[sound]
    log(f"{tag}: planted fault (windows after a document's first start {FAULT_SHIFT} tokens late): "
        f"{len(moved)} windows, max_abs_err against the direct encode max {fault_err.max():.3g}, "
        f"median {np.median(fault_err):.3g}, min {fault_err.min():.3g} (tol {INGEST_TOL})")
    if not fault_err.max() > INGEST_TOL:
        raise SystemExit("the stored-vector tolerance would pass the planted chunker fault")
    hold_tokenizer(card, model.tokenizer, docs, tag)

    n_tokens = sum(len(w) + 2 for _, _, w in flat)
    summary = [line for line in out.splitlines() if line.startswith("Finished in")]
    log(f"{tag} (source scan through the CLI: walk, read, tokenize, encode, SQLite, matrix hooks): "
        f"{len(docs)} docs ({n_win} windows, {n_tokens} tokens) in {t_scan:.3f} s = "
        f"{len(docs) / t_scan:.1f} docs/s end to end, not comparable with the encode-only loop of "
        f"earlier runs; {summary[0] if summary else 'no summary line'}; the tokenizer took {tok_s[0]:.3f} s "
        f"of the embed stage's thread ({100 * tok_s[0] / t_scan:.1f}% of the scan's wall time)  [{card}]")
    log(f"{tag} host: native walker {'used' if fastwalk_available() else 'unavailable (Python walk)'}; "
        "importable: " + ", ".join(f"{m} {'yes' if importlib.util.find_spec(m) else 'no'}"
                                   for m in ("yaml", "zstandard", "lxml", "requests")))
    next_id, next_seq = conn.execute(
        "SELECT (SELECT MAX(id) FROM items), (SELECT MAX(seq) FROM item_embeddings)").fetchone()
    return {"db_path": db_path, "doc_ids": doc_ids, "doc_windows": [len(w) for w in wins],
            "embs": stored_embs, "launches": launches, "next_id": next_id + 1, "next_seq": next_seq + 1,
            "windows": n_win, "flat_windows": [w for _, _, w in flat], "scan_s": t_scan, "summary": summary,
            "tok_s": tok_s[0]}


def smoke_texts(dev) -> dict:
    """The smoke's all-MiniLM-L6-v2-width model (seeded random weights, its
    tokenizer over ``minilm_vocab``), its N_DOCS documents, the 16 text
    queries and the filler rows' text, and the seeded numpy generator
    they were drawn from (its next draws: the batch queries)."""
    import torch

    from perceive_tpu_torch.models import EncoderArch, HeadConfig, Model, ModelType, TextTokenizer

    rng = np.random.default_rng(11)
    vocab_list = minilm_vocab()
    tok = TextTokenizer.from_vocab({w: i for i, w in enumerate(vocab_list)}, max_seq_length=512)
    arch = EncoderArch(vocab_size=30522, hidden_size=384, num_layers=6, num_heads=12,
                       intermediate_size=1536, max_position_embeddings=512)
    model = Model.random(arch, HeadConfig(pooling="mean", normalize=True), tok, seed=0,
                         device=dev, compute_dtype=torch.bfloat16)
    model.model_id = ModelType.ALL_MINILM_L6_V2.model_id
    docs = make_docs(rng, vocab_list)
    self_docs, queries = text_queries(rng, docs, vocab_list)
    return {"rng": rng, "vocab": vocab_list, "tok": tok, "model": model, "docs": docs, "self_docs": self_docs,
            "queries": queries, "filler_text": " ".join(vocab_list[300:316])}


def build_corpus(card: str, workdir: str, dev) -> dict:
    """Phase 6's corpus: the model, the documents ingested through the CLI
    (``ingest``), and the filler rows that fill SQLite to TOTAL_ROWS rows,
    drawn here (``ctx["fill"]``) for ``fill_corpus`` to write."""
    import torch

    from perceive_tpu_torch.db import Database, add_source
    from perceive_tpu_torch.types import Source

    texts = smoke_texts(dev)
    rng, vocab_list, tok, model, docs = (texts[k] for k in ("rng", "vocab", "tok", "model", "docs"))
    ing = ingest(card, workdir, dev, model, docs)
    embs = ing["embs"]
    db = Database(ing["db_path"])
    src_fill = add_source(db, Source(name="filler", config={"type": "fs"}, location="generated:filler"))
    db.close()
    n_fill = TOTAL_ROWS - ing["windows"]
    filler_text = texts["filler_text"]
    gen = torch.Generator(device=dev).manual_seed(12)
    fill = list(filler_vectors(gen, n_fill))

    self_docs, queries = texts["self_docs"], texts["queries"]
    # N_BATCH vector queries, half near a stored window and half random, and
    # N_BATCH random ones
    half = N_BATCH // 2
    near = embs[rng.integers(0, len(embs), half)] + 0.02 * rng.standard_normal((half, DIM)).astype(np.float32)
    vecs = np.concatenate([near, rng.standard_normal((N_BATCH - half, DIM)).astype(np.float32)])
    vecs = (vecs / np.linalg.norm(vecs, axis=1, keepdims=True))[rng.permutation(N_BATCH)]
    vecs_random = rng.standard_normal((N_BATCH, DIM)).astype(np.float32)
    vecs_random /= np.linalg.norm(vecs_random, axis=1, keepdims=True)
    return {"model": model, "tok": tok, "docs": docs, "doc_ids": ing["doc_ids"],
            "doc_windows": ing["doc_windows"], "db_path": ing["db_path"],
            "gen": gen, "fill_source": src_fill.id, "first_fill_id": ing["next_id"],
            "next_id": ing["next_id"], "next_seq": ing["next_seq"], "fill": fill,
            "attention_launches": ing["launches"], "filler_text": filler_text, "self_docs": self_docs,
            "windows": ing["flat_windows"], "stored": embs,
            "queries": queries, "vecs": vecs, "vecs_random": vecs_random}


def fill_corpus(ctx: dict) -> float:
    """Writes ``build_corpus``'s filler rows (TOTAL_ROWS in all, with the
    document windows) through a worker process (``filler_job``) beside
    the first kernel checks; returns its seconds."""
    chunks = ctx.pop("fill")
    return filler_job(ctx, ctx["db_path"], sum(map(len, chunks)), chunks)["seconds"]


def cli_queries(card: str, state, ctx: dict, tier: str, kernel: str, gate_self: bool = True):
    """16 queries through the CLI after 2 warm-ups; checks that every query
    is answered and launched ``kernel``, the self-queries rank their
    document first (only reported where not ``gate_self``), and snippets
    come from their documents."""
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

    doc_ids = ctx["doc_ids"]
    contents = {doc_ids[d]: t for d, t in enumerate(docs)}
    for qi, res in enumerate(results):
        if not res:
            raise SystemExit(f"query {qi} returned no results")
        for r in res:
            text = contents.get(r["id"], ctx["filler_text"] if r["id"] >= ctx["first_fill_id"] else None)
            if text is None or not r["snippet"] or r["snippet"] not in text:
                raise SystemExit(f"query {qi}: snippet of item {r['id']} is not from its document")
    firsts = sum(results[i][0]["id"] == doc_ids[self_docs[i]] for i in range(N_SELF_QUERIES))
    log(f"{tier} queries answered: {sum(bool(r) for r in results)}/16; self-queries ranked first: "
        f"{firsts}/{N_SELF_QUERIES}")
    if firsts != N_SELF_QUERIES and gate_self:
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


@contextlib.contextmanager
def build_route():
    """What the Searcher builds inside the block read: the rows
    ``Searcher._load`` streamed from SQLite, the answers of
    ``_load_snapshot`` (a snapshot was used) and of ``_adopt_snapshot_fh``
    (it was adopted as stored; else its f32 rows were streamed).  The
    builds' own phase lines (PERCEIVE_TPU_DEBUG_STARTUP) are logged."""
    from perceive_tpu_torch.index.matrix import EmbeddingMatrix
    from perceive_tpu_torch.index.searcher import Searcher

    route = {"sqlite_rows": 0, "snapshot": [], "adopted": []}
    load, load_snapshot, adopt = Searcher._load, Searcher._load_snapshot, EmbeddingMatrix._adopt_snapshot_fh

    def counted(self, db, extra_sql, params, **kw):
        n = load(self, db, extra_sql, params, **kw)
        route["sqlite_rows"] += n
        return n

    def snapshot(self, db):
        route["snapshot"].append(load_snapshot(self, db))
        return route["snapshot"][-1]

    def adopted(self, path, fh):
        route["adopted"].append(adopt(self, path, fh))
        return route["adopted"][-1]

    err = io.StringIO()
    prev = os.environ.get("PERCEIVE_TPU_DEBUG_STARTUP")
    os.environ["PERCEIVE_TPU_DEBUG_STARTUP"] = "1"
    Searcher._load, Searcher._load_snapshot, EmbeddingMatrix._adopt_snapshot_fh = counted, snapshot, adopted
    try:
        with contextlib.redirect_stderr(err):
            yield route
    finally:
        Searcher._load, Searcher._load_snapshot, EmbeddingMatrix._adopt_snapshot_fh = load, load_snapshot, adopt
        if prev is None:
            os.environ.pop("PERCEIVE_TPU_DEBUG_STARTUP")
        else:
            os.environ["PERCEIVE_TPU_DEBUG_STARTUP"] = prev
        for line in err.getvalue().splitlines():
            log(f"  {line}")
    log(f"build route: snapshot used {route['snapshot']}, adopted {route['adopted']}, "
        f"{route['sqlite_rows']} rows streamed from SQLite")


def check_route(route: dict, tier: str, adopted: bool, sqlite_rows: int) -> None:
    """Fails unless the build took a snapshot, adopted it (or streamed its
    f32 rows) as ``adopted`` says, and streamed exactly ``sqlite_rows``
    rows from SQLite."""
    if route["snapshot"] != [True] or route["adopted"] != [adopted] or route["sqlite_rows"] != sqlite_rows:
        raise SystemExit(f"the {tier} build took the route {route}; want a snapshot "
                         f"{'adopted' if adopted else 'streamed'} and {sqlite_rows} rows from SQLite")


def check_manifest(state, ctx: dict) -> None:
    """The manifest names phase 7's base, not the serve phase's autosave
    (which is removed: nothing reads it)."""
    from perceive_tpu_torch.cli.commands import _snapshot_path

    path = state.db.read().execute("SELECT path FROM vector_shards").fetchall()
    if path != [(ctx["snap"],)]:
        raise SystemExit(f"vector_shards names {path}, not the snapshot {ctx['snap']}")
    autosave = _snapshot_path(state)
    if os.path.exists(autosave):
        log(f"vector_shards names {ctx['snap']}; the refresh's autosave {autosave} "
            f"({os.path.getsize(autosave) / 2**30:.3f} GiB) removed")
        os.unlink(autosave)
    else:
        log(f"vector_shards names {ctx['snap']}; no autosave at {autosave}")


def cli_snapshot(card: str, state, ctx: dict, path: str, want: str) -> dict:
    """``snapshot PATH`` through the CLI; the matrix must answer ``want``
    ("full" or "delta").  Logs the free disk of the workdir before it, the
    save's seconds and the files' sizes; a save that fails (for want of
    space too) fails the run."""
    from perceive_tpu_torch.cli import main as cli_main
    from perceive_tpu_torch.index.matrix import EmbeddingMatrix

    du = shutil.disk_usage(os.path.dirname(path))
    log(f"workdir disk before the save: {du.free / 2**30:.1f} GiB free of {du.total / 2**30:.1f} GiB")
    forms = []
    save = EmbeddingMatrix.save_snapshot

    def spy(self, p, **kw):
        forms.append(save(self, p, **kw))
        return forms[-1]

    out, err = io.StringIO(), io.StringIO()
    EmbeddingMatrix.save_snapshot = spy
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli_main(["--db", ctx["db_path"], "snapshot", path], state=state)
    finally:
        EmbeddingMatrix.save_snapshot = save
    secs = time.perf_counter() - t0
    if rc != 0 or forms != [want]:
        raise SystemExit(f"snapshot exited {rc} answering {forms}, want {want!r}: {out.getvalue()} {err.getvalue()}")
    m = state.searcher.matrix
    size = os.path.getsize(path)
    delta = os.path.getsize(path + ".delta") if os.path.exists(path + ".delta") else 0
    log(f"snapshot ({want}) of {len(m)} {m.tier_name} rows in {secs:.1f} s: base {size / 2**30:.3f} GiB, "
        f"delta {delta / 2**20:.3f} MiB; {out.getvalue().strip()}  [{card}]")
    return {"seconds": secs, "base_bytes": size, "delta_bytes": delta}


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
               reps: int = 3, executor: bool = True, verify_every: int = 1) -> dict:
    """N_EXECUTOR_QUERIES vector queries from N_CLIENTS threads through a
    BatchingSearchExecutor (unless not ``executor``), then
    search_vectors_batch on N_BATCH queries of each mix, ``reps`` times
    after a warm-up (once, and no warm-up, when ``reps`` is 1).  The launch
    counts are read right after (``kernel`` must have run, and
    ``drain_kernel`` too where given); then every executor answer is held
    against the batch and every ``verify_every``-th against the same query
    through search_vector (without the executor: every 16th batch answer
    against search_vector)."""
    import torch

    from perceive_tpu_torch.index import BatchingSearchExecutor

    searcher, vecs = state.searcher, ctx["vecs"]
    results = [None] * N_EXECUTOR_QUERIES
    esc0 = searcher.escalations
    note_peak()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    if executor:
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
    peak = torch.cuda.max_memory_allocated()
    note_peak()
    # the path ends here; the checks below launch per-query sweeps
    if executor and (served != N_EXECUTOR_QUERIES or any(r is None for r in results)):
        raise SystemExit(f"the executor served {served} of {N_EXECUTOR_QUERIES} queries")
    for name in (kernel, drain_kernel):
        if name and launches[name] == 0:
            raise SystemExit(f"the {tier} batch path launched no {name} kernel")
    if executor:
        log(f"{tier} executor: {N_EXECUTOR_QUERIES} queries from {N_CLIENTS} threads in {t_ex:.3f} s = "
            f"{N_EXECUTOR_QUERIES / t_ex:.1f} QPS; sweeps_total {sweeps}, queries_total {served}  [{card}]")
    for name, (parts, esc) in timed.items():
        wall = parts["all"]
        log(f"{tier} search_vectors_batch, {N_BATCH} {name} queries: {wall * 1e3:.2f} ms "
            f"({'median of ' + str(reps) if reps > 1 else 'one cold run'}) = {N_BATCH / wall:.1f} QPS; "
            f"{esc:g} escalations a batch; host seconds: "
            + ", ".join(f"{k} {parts[k]:.4f}" for k in ("sweep", "rerank", "rest")) + f"  [{card}]")
    log(f"{tier} batch path: escalations {searcher.escalations - esc0}; launches {launches}")
    log(f"{tier} batch path: device memory {resident / 2**30:.3f} GiB resident before it, peak "
        f"{peak / 2**30:.3f} GiB during it (kernel workspace, batch queries and results on top)  [{card}]")
    if executor:
        sample = range(0, N_EXECUTOR_QUERIES, verify_every)
        bad = sum(not hits_match(results[i], searcher.search_vector(vecs[i], 10), 1e-5) for i in sample)
        bad += sum(not hits_match(batch[i], results[i], 1e-5) for i in range(N_EXECUTOR_QUERIES))
        total = len(sample) + N_EXECUTOR_QUERIES
        log(f"{tier} executor answers equal the batch's ({N_EXECUTOR_QUERIES}) and search_vector's "
            f"({'every one' if verify_every == 1 else f'every {verify_every}th'}): {total - bad}/{total}")
    else:
        sample = range(0, N_BATCH, 16)
        bad = sum(not hits_match(batch[i], searcher.search_vector(vecs[i], 10), 1e-5) for i in sample)
        log(f"{tier} batch answers equal search_vector's: {len(sample) - bad}/{len(sample)} (every 16th)")
    if bad:
        raise SystemExit(f"{bad} {tier} executor or batch answers differ from search_vector's")
    return {"launches": launches}


def bf16_slice(card: str, ctx: dict, dev) -> dict:
    """Phase 6 after the ingest: AppState on the card, 16 CLI queries, hits
    held against the plain scan."""
    import torch

    from perceive_tpu_torch.cli import AppState
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
    hold_to_plain(searcher, torch.cat([query_vector(ctx, q, dev) for q in ctx["queries"]]), results, "bf16 slice")
    return state, {"launches": launches, "p50": p50, "p95": p95, "results": results}


def hold_to_plain(searcher, qvs, results, tag: str, scale=None) -> None:
    """Each query's CLI hits against the plain scan over the same device
    matrix at the searcher's first fetch depth: the same ids in the same
    order, scores within 1e-4 (f32 sums of bf16 products in another order),
    times ``scale[q]`` where given (``score_scale``: the operands' norms).
    Two hits may trade places only where their plain scores lie within
    twice that, the tie band of the kernel checks (``compare_topk``); the
    plain scan's 11th hit stands beside its 10th."""
    import torch

    from perceive_tpu_torch.index.searcher import _k_bucket
    from perceive_tpu_torch.ops import topk

    m = searcher.matrix
    vectors, src, _ = m.device_view()
    kb = _k_bucket(searcher._first_fetch(10), m.sweep_rows)
    allowed = torch.from_numpy(searcher._allowed_arrays(None)[0]).to(m.device)
    qvs = torch.nn.functional.pad(qvs[:, : m.dim], (0, m.padded_dim - m.dim))
    for qi in range(len(qvs)):
        vals, rows = topk.scan_topk_plain(vectors, src, qvs[qi : qi + 1], allowed, kb, m.sweep_rows)
        want = searcher._decode_hits(vals[0].cpu().numpy(), rows[0].cpu().numpy(), 11)
        got = [(r["id"], r["score"]) for r in results[qi]]
        if not hits_match(got + want[10:], want, 1e-4 * (1.0 if scale is None else scale[qi])):
            raise SystemExit(f"{tag} query {qi}: hits differ from the plain scan:\n{got}\n{want}")
    log(f"{tag} hits equal the plain scan's for {len(qvs)}/{len(qvs)} queries")


# -- the serve phase (after the bf16 batch path) -------------------------------------

N_SERVE_CONCURRENT = 256  # distinct queries of the concurrent load
N_SERVE_DOCS = 64  # the subprocess server's corpus
SERVE_PHASE_S = 120  # the phase's budget
REFRESH_DOC = 1  # the long document the background refresh re-embeds
TAG_DOCS = (2, 3, 4)
HIDE_FROM = 5  # hidden and unhidden: the longest of the next 8 long documents


def http_request(port: int, method: str, path: str, body=None, headers=None, timeout: float = 60) -> tuple:
    """(status, parsed JSON or text) of one request to 127.0.0.1:port."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        if headers is not None:  # raw: these headers only, no body
            conn.putrequest(method, path)
            for k, v in headers.items():
                conn.putheader(k, v)
            conn.endheaders()
        else:
            data = None if body is None else json.dumps(body)
            conn.request(method, path, body=data, headers={"Content-Type": "application/json"} if data else {})
        r = conn.getresponse()
        raw = r.read().decode()
        kind = r.getheader("Content-Type") or ""
        return r.status, json.loads(raw) if kind.startswith("application/json") else raw
    finally:
        conn.close()


def search_path(q: str, k: int = 10, **params) -> str:
    from urllib.parse import urlencode

    return "/search?" + urlencode({"q": q, "k": k, **params})


def metrics(port: int) -> dict:
    text = http_request(port, "GET", "/metrics")[1]
    return {line.split()[0]: line.split()[1] for line in text.splitlines() if line and not line.startswith("#")}


def wait_for(pred, seconds: float, what: str) -> float:
    """Polls ``pred`` until it holds; fails after ``seconds``.  Returns the
    seconds waited."""
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > seconds:
            raise SystemExit(f"serve phase: waited {seconds} s for {what}")
        time.sleep(0.05)
    return time.perf_counter() - t0


def served_hits(res) -> list:
    return [(r["id"], r["score"]) for r in res]


def same_answer(got, want, tol: float = 1e-4) -> bool:
    """Served hits against an answer of the CLI: ids, scores within
    ``tol``, snippets equal."""
    return (hits_match(served_hits(got), served_hits(want), tol)
            and [r["snippet"] for r in got] == [r["snippet"] for r in want])


def cli_json(state, ctx: dict, *argv) -> list:
    from perceive_tpu_torch.cli import main as cli_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(["--db", ctx["db_path"], *argv, "--json"], state=state)
    if rc != 0:
        raise SystemExit(f"{' '.join(argv[:2])} exited {rc}")
    return json.loads(out.getvalue())


def cli_ok(state, ctx: dict, *argv) -> str:
    from perceive_tpu_torch.cli import main as cli_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(["--db", ctx["db_path"], *argv], state=state)
    if rc != 0:
        raise SystemExit(f"{' '.join(argv[:2])} exited {rc}: {out.getvalue()[-400:]}")
    return out.getvalue()


def stop_server(server) -> None:
    server.perceive_state.stop()
    server.shutdown()
    server.server_close()


def serve_phase(card: str, state, ctx: dict, cli_results: list, workdir: str) -> dict:
    """The bf16 state (1M rows) behind the port's HTTP server: readiness,
    the 16 CLI queries served uncontended (GET and POST) against phase 6's
    CLI answers, 256 distinct queries from 16 client threads against their
    uncontended answers, the filters and guards over HTTP, tags, hide and
    unhide through the CLI, a background refresh that re-embeds a rewritten
    long document (K11) and serves its new text, the CLI's stats, print,
    model and doctor, and the real entry point in a subprocess stopped by
    SIGTERM.  Every server and thread it starts stops before it ends."""
    from perceive_tpu_torch.ops import attention as attn
    from perceive_tpu_torch.serve import start_server

    t_phase = time.perf_counter()
    os.environ["PERCEIVE_TPU_DATA_DIR"] = os.path.join(workdir, "data")
    out = {}
    docs, doc_ids, queries = ctx["docs"], ctx["doc_ids"], ctx["queries"]

    # 1. readiness
    t0 = time.perf_counter()
    server = start_server(lambda: state, port=0)
    holder, port = server.perceive_state, server.server_address[1]
    try:
        if not holder.ready.wait(120):
            raise SystemExit("serve phase: the server was not ready within 120 s")
        out["ready_s"] = time.perf_counter() - t0
        status = http_request(port, "GET", "/status")[1]
        log(f"serve: ready in {out['ready_s']:.3f} s; /status {json.dumps(status)}  [{card}]")
        if not (status["model_loaded"] and status["tier"] == "bfloat16" and status["rows"] == len(state.searcher.matrix)
                and status["error"] is None):
            raise SystemExit(f"serve phase: /status {status}")
        t0 = time.perf_counter()
        for t in holder.warmers:
            t.join(60)
        if any(t.is_alive() for t in holder.warmers):
            raise SystemExit("serve phase: a background warmer ran past 60 s")
        log(f"serve: background warmers done {time.perf_counter() - t0:.3f} s later; "
            f"highlight chunks warmed {holder.highlight_warmed_total}")

        # 2. the 16 CLI queries, uncontended, GET then POST
        walls = {"GET": [], "POST": []}
        k1 = {"GET": 0, "POST": 0}
        m0 = metrics(port)
        for method in ("GET", "POST"):
            for qi, q in enumerate(queries):
                before = launch_counts()["scan_topk"]
                t0 = time.perf_counter()
                code, res = (http_request(port, "GET", search_path(q)) if method == "GET"
                             else http_request(port, "POST", "/search", {"q": q, "k": 10}))
                walls[method].append((time.perf_counter() - t0) * 1e3)
                n = launch_counts()["scan_topk"] - before
                k1[method] += n
                if code != 200 or not same_answer(res, cli_results[qi]):
                    raise SystemExit(f"serve phase: {method} query {qi} answered {code}, not phase 6's CLI hits:\n"
                                     f"{res}\n{cli_results[qi]}")
                if method == "GET" and n == 0:
                    raise SystemExit(f"serve phase: GET query {qi} launched no scan_topk kernel")
        mm = metrics(port)
        out["dispatches_per_request"] = float(mm["perceive_dispatches_per_request"])
        for method, w in walls.items():
            p50, p95 = (float(np.percentile(w, p)) for p in (50, 95))
            out[method] = (p50, p95)
            log(f"serve: 16 {method} /search k=10 uncontended (HTTP, executor, fused query, highlight): p50 "
                f"{p50:.2f} ms  p95 {p95:.2f} ms; scan_topk launches {k1[method]} = "
                f"{k1[method] / len(w):.2f} a request  [{card}]")
        log(f"serve: the 32 answers equal phase 6's CLI hits (ids, scores within 1e-4, snippets); executor "
            f"queries {int(mm['perceive_search_queries_total']) - int(m0['perceive_search_queries_total'])}, "
            f"result-cache hits {int(mm['perceive_result_cache_hits_total'])}; "
            f"perceive_dispatches_per_request {mm['perceive_dispatches_per_request']}; dispatch counters "
            + ", ".join(f"{k} {v}" for k, v in mm.items() if k.startswith("perceive_device_dispatches")))

        # 3. concurrent load: 256 distinct queries from 16 threads against
        # their uncontended answers (the CLI's, in this process)
        rng = np.random.default_rng(21)
        words = [w for w in minilm_vocab()[200:] if not w.startswith("##")]
        load = [" ".join(words[j] for j in rng.integers(0, len(words), int(rng.integers(3, 12))))
                for _ in range(N_SERVE_CONCURRENT)]
        t0 = time.perf_counter()
        alone = [cli_json(state, ctx, "search", q, "-n", "10") for q in load]
        log(f"serve: the {N_SERVE_CONCURRENT} load queries' uncontended answers through the CLI in "
            f"{time.perf_counter() - t0:.1f} s")
        answers = [None] * N_SERVE_CONCURRENT
        errors = []

        def client(c):
            try:
                for i in range(c, N_SERVE_CONCURRENT, N_CLIENTS):
                    answers[i] = http_request(port, "GET", search_path(load[i]))
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(repr(e))

        m0 = metrics(port)
        before = launch_counts()
        threads = [threading.Thread(target=client, args=(c,)) for c in range(N_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        wall = time.perf_counter() - t0
        after, m1 = launch_counts(), metrics(port)
        if errors or any(t.is_alive() for t in threads) or any(a is None for a in answers):
            raise SystemExit(f"serve phase: the concurrent load failed: {errors[:3]}")
        worst, moved, bad = 0.0, 0, []
        for i, (code, res) in enumerate(answers):
            if code != 200:
                bad.append(i)
                continue
            got, want = served_hits(res), served_hits(alone[i])
            if [a for a, _ in got] != [a for a, _ in want]:
                moved += 1
            worst = max([worst] + [abs(a[1] - b[1]) for a, b in zip(got, want)])
            if not same_answer(res, alone[i]):
                bad.append(i)
        sweeps = int(m1["perceive_search_sweeps_total"]) - int(m0["perceive_search_sweeps_total"])
        served = int(m1["perceive_search_queries_total"]) - int(m0["perceive_search_queries_total"])
        out["qps"] = N_SERVE_CONCURRENT / wall
        log(f"serve: {N_SERVE_CONCURRENT} distinct queries from {N_CLIENTS} threads in {wall:.3f} s = "
            f"{out['qps']:.1f} QPS; executor sweeps_total {sweeps} for queries_total {served}; launches "
            f"scan_topk {after['scan_topk'] - before['scan_topk']}, scan_slab "
            f"{after['scan_slab'] - before['scan_slab']}  [{card}]")
        log(f"serve: concurrent answers against the uncontended ones: {N_SERVE_CONCURRENT - len(bad)}/"
            f"{N_SERVE_CONCURRENT} equal within 1e-4 (near ties may trade places); {moved} with an "
            f"id order that differs; max score difference {worst:.3g} (a coalesced drain encodes its queries in "
            f"one batch, an uncontended query alone)")
        if bad:
            raise SystemExit(f"serve phase: concurrent answers {bad[:8]} differ from the uncontended ones")

        # the real entry point's `source add` and `source scan` subprocesses
        # (step 7) run beside steps 4-6, which time nothing but the refresh
        prep_pool = concurrent.futures.ThreadPoolExecutor(1)
        prep = prep_pool.submit(real_entry_prep, workdir, docs)
        prep_pool.shutdown(wait=False)

        # 4. filters and guards over HTTP, then tags, hide and unhide
        q = queries[0]
        plain = http_request(port, "GET", search_path(q))[1]
        checks = {
            "type=local": (http_request(port, "GET", search_path(q, type="local")), lambda r: same_answer(r, plain)),
            "type=web": (http_request(port, "GET", search_path(q, type="web")), lambda r: r == []),
            "source=docs": (http_request(port, "GET", search_path(q, source="docs")),
                            lambda r: r and {h["source"] for h in r} == {"docs"}),
            "after=0 (POST)": (http_request(port, "POST", "/search", {"q": q, "after": 0}),
                               lambda r: r and all(h["time"] is not None and h["time"] >= 0 for h in r)),
            "before=2001-09-09": (http_request(port, "GET", search_path(q, before="1000000000")), lambda r: r == []),
            "after=1d": (http_request(port, "GET", search_path(q, after="1d")),
                         lambda r: r and all(h["source"] == "docs" for h in r)),
        }
        for name, ((code, res), ok) in checks.items():
            if code != 200 or not ok(res):
                raise SystemExit(f"serve phase: filter {name} answered {code} {str(res)[:300]}")
        guards = {
            "k=abc": (http_request(port, "GET", search_path(q, k="abc")), 400),
            "k=0": (http_request(port, "GET", search_path(q, k=0)), 400),
            "missing q": (http_request(port, "GET", "/search?k=3"), 400),
            "body too large": (http_request(port, "POST", "/search", headers={"Content-Length": str(100 << 20)}), 413),
            "unknown source": (http_request(port, "GET", search_path(q, source="nosuch")), 404),
            "bad type": (http_request(port, "POST", "/search", {"q": q, "type": "nope"}), 400),
        }
        for name, ((code, res), want) in guards.items():
            if code != want:
                raise SystemExit(f"serve phase: guard {name} answered {code}, want {want}: {res}")
        log(f"serve: filters {', '.join(checks)} and guards "
            + ", ".join(f"{n} -> {w}" for n, (_, w) in guards.items()) + " ok")

        tagged = {doc_ids[d] for d in TAG_DOCS}
        for item in sorted(tagged):
            cli_ok(state, ctx, "tag", "add", str(item), "smoke")
        hits = cli_json(state, ctx, "search", docs[TAG_DOCS[0]], "-n", "10", "--tag", "smoke")
        if not hits or not {h["id"] for h in hits} <= tagged or hits[0]["id"] != doc_ids[TAG_DOCS[0]]:
            raise SystemExit(f"serve phase: search --tag smoke answered {[h['id'] for h in hits]}, tagged {tagged}")
        log(f"serve: tag add on {len(tagged)} documents; search --tag smoke answered {len(hits)} of them, "
            f"the queried document first")

        hide_doc = max(range(HIDE_FROM, HIDE_FROM + 8), key=lambda d: len(docs[d].split()))
        hid = doc_ids[hide_doc]
        m = state.searcher.matrix
        n_rows = state.db.read().execute(
            "SELECT COUNT(*) FROM item_embeddings WHERE item_id = ?", (hid,)).fetchone()[0]
        rows0 = len(m)
        first = http_request(port, "GET", search_path(docs[hide_doc]))[1]
        if not first or first[0]["id"] != hid:
            raise SystemExit(f"serve phase: document {hide_doc} is not its own text's first hit")
        cli_ok(state, ctx, "hide", str(hid))
        gone = http_request(port, "GET", search_path(docs[hide_doc]))[1]
        if hid in {h["id"] for h in gone} or len(m) != rows0 - n_rows:
            raise SystemExit(f"serve phase: hide left item {hid} served or {len(m)} rows (want {rows0 - n_rows})")
        cli_ok(state, ctx, "hide", str(hid), "--unhide")
        back = http_request(port, "GET", search_path(docs[hide_doc]))[1]
        if not back or back[0]["id"] != hid or len(m) != rows0:
            raise SystemExit(f"serve phase: unhide did not bring item {hid} back with its {n_rows} rows")
        log(f"serve: hide of item {hid} (document {hide_doc}, {n_rows} windows) took it out of /search and "
            f"{n_rows} rows out of the matrix; unhide brought it back first, with every row")
    finally:
        stop_server(server)

    # 5. background refresh: only the docs source is due
    cli_ok(state, ctx, "source", "edit", "filler", "--interval", str(1 << 40))
    db = state.db
    server = start_server(lambda: state, port=0, refresh_interval=1.0)
    holder, port = server.perceive_state, server.server_address[1]
    try:
        if not holder.ready.wait(120) or holder.error is not None:
            raise SystemExit(f"serve phase: the refresh server was not ready: {holder.error}")
        wait_for(lambda: holder.refresh_scans_total >= 1, 60, "the first refresh scan")
        for q in queries[:2]:
            http_request(port, "GET", search_path(q))
        gauge0 = metrics(port)["perceive_dispatches_per_request"]
        scans0, k11 = holder.refresh_scans_total, attn.LAUNCHES
        n_words = len(docs[REFRESH_DOC].split())
        new_text = " ".join(words[j] for j in rng.integers(0, len(words), n_words))
        path = os.path.join(workdir, "docs", f"doc{REFRESH_DOC}.txt")
        with open(path, "w") as f:
            f.write(new_text)
        item = doc_ids[REFRESH_DOC]

        def re_embedded():
            row = db.read().execute("SELECT content FROM items WHERE id = ?", (item,)).fetchone()
            return row[0] == new_text and holder.refresh_scans_total > scans0

        waited = wait_for(re_embedded, 60, "the refresh to re-embed the rewritten document")
        k11 = attn.LAUNCHES - k11
        mm = metrics(port)
        ctx["docs"][REFRESH_DOC] = new_text
        hits = http_request(port, "GET", search_path(new_text))[1]
        refresh_dispatches = mm.get('perceive_device_dispatches_total{site="refresh"}', 0)
        log(f"serve: refresh re-embedded document {REFRESH_DOC} ({n_words} tokens) {waited:.2f} s after its "
            f"rewrite; refresh scans {mm['perceive_refresh_scans_total']}, errors "
            f"{mm['perceive_refresh_errors_total']}; K11 launches during it {k11}; dispatches_per_request "
            f"{gauge0} before, {mm['perceive_dispatches_per_request']} after; refresh dispatches "
            f"{refresh_dispatches}; its new text's first hit {hits[0]['id'] if hits else None} "
            f"(item {item})  [{card}]")
        if int(mm["perceive_refresh_scans_total"]) < 1 or k11 == 0:
            raise SystemExit("serve phase: the refresh scanned nothing or launched no attention kernel")
        if not hits or hits[0]["id"] != item:
            raise SystemExit("serve phase: the rewritten document's new text does not find it first")
        if mm["perceive_dispatches_per_request"] != gauge0:
            raise SystemExit("serve phase: the refresh moved perceive_dispatches_per_request")
    finally:
        stop_server(server)
    seq = db.read().execute(
        "SELECT (SELECT MAX(id) FROM items), (SELECT MAX(seq) FROM item_embeddings)").fetchone()
    # later phases write filler rows after every id and seq the refresh used
    ctx["next_id"], ctx["next_seq"] = max(ctx["next_id"], seq[0] + 1), max(ctx["next_seq"], seq[1] + 1)

    # 6. the CLI's stats, print and model, and the doctor, on the card
    stats = cli_ok(state, ctx, "stats")
    cli_ok(state, ctx, "print", str(doc_ids[REFRESH_DOC]))
    cli_ok(state, ctx, "model", "list")
    for line in stats.splitlines():
        log(f"  stats: {line}")

    # 7. the real entry point, in subprocesses, over a database of its own;
    # the doctor on that database, in this process
    out["subprocess"] = real_entry_point(card, workdir, docs, prep.result(timeout=400))
    doctor_check(card, os.path.join(workdir, "small", "small.sqlite3"))

    # 8. nothing of the servers outlives the phase
    names = ("serve-", "search-batcher", "highlight-batcher")  # a ServeState's and its executor's
    left = [t.name for t in threading.enumerate() if t.name.startswith(names)]
    if left:
        raise SystemExit(f"serve phase: threads still alive: {left}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"serve phase: {out['seconds']:.1f} s of its {SERVE_PHASE_S} s budget  [{card}]")
    if out["seconds"] > SERVE_PHASE_S:
        raise SystemExit(f"the serve phase took {out['seconds']:.1f} s, past its {SERVE_PHASE_S} s budget")
    return out


def doctor_check(card: str, db_path: str) -> None:
    """``doctor`` must exit 0 with its device, build-and-launch,
    kernel-cache and tokenizer-library checks ok."""
    from perceive_tpu_torch.cli.doctor import doctor

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = doctor(db_path)
    lines = out.getvalue().splitlines()
    for line in lines:
        log(f"  doctor: {line}")
    log(f"serve: doctor exited {rc} in {time.perf_counter() - t0:.2f} s  [{card}]")
    if rc != 0:
        raise SystemExit(f"serve phase: doctor exited {rc}")
    for name in ("device", "kernel build+launch", "kernel cache", "tokenizer library"):
        if not any(line.startswith(f"  ✓ {name}:") for line in lines):
            raise SystemExit(f"serve phase: the doctor's {name} check is not ok")


def entry_point_cli(workdir: str) -> tuple:
    """(argv prefix, environment, working directory) of ``python3 -m
    perceive_tpu_torch.cli`` over the serve phase's small database."""
    small = os.path.join(workdir, "small")
    env = dict(os.environ, PYTHONUNBUFFERED="1", PERCEIVE_TPU_DATA_DIR=os.path.join(small, "data"))
    cli = [sys.executable, "-m", "perceive_tpu_torch.cli", "--db", os.path.join(small, "small.sqlite3")]
    return cli, env, os.path.dirname(os.path.abspath(__file__))


def real_entry_prep(workdir: str, docs: list) -> dict:
    """``python3 -m perceive_tpu_torch.cli`` ``source add fs`` over
    N_SERVE_DOCS documents and ``source scan``, each in a subprocess: their
    seconds and the last lines of their output (logged by the caller, as
    this runs beside the serve phase's other steps)."""
    small = os.path.join(workdir, "small")
    os.makedirs(os.path.join(small, "docs"))
    for d, text in enumerate(docs[N_LONG:N_LONG + N_SERVE_DOCS]):
        with open(os.path.join(small, "docs", f"doc{d}.txt"), "w") as f:
            f.write(text)
    cli, env, root = entry_point_cli(workdir)
    out = {"lines": []}
    for argv in (["source", "add", "fs", os.path.join(small, "docs"), "--name", "docs"],
                 ["source", "scan", "docs"]):
        t0 = time.perf_counter()
        res = subprocess.run(cli + argv, cwd=root, env=env, capture_output=True, text=True, timeout=180)
        out[argv[1]] = time.perf_counter() - t0
        out["lines"] += [f"  subprocess source {argv[1]}: {line}" for line in (res.stdout + res.stderr).splitlines()[-6:]]
        if res.returncode != 0:
            out["error"] = f"serve phase: `source {argv[1]}` exited {res.returncode}"
            break
    return out


def real_entry_point(card: str, workdir: str, docs: list, prep: dict) -> dict:
    """After ``real_entry_prep``: ``python3 -m perceive_tpu_torch.cli serve
    --port 0`` in a subprocess (the CLI's random fallback model, on cuda:0),
    ready, one /search with hits, and SIGTERM ending it with exit 0 within
    30 s."""
    import signal

    for line in prep["lines"]:
        log(line)
    if "error" in prep:
        raise SystemExit(prep["error"])
    cli, env, root = entry_point_cli(workdir)
    out = {"add": prep["add"], "scan": prep["scan"]}
    t0 = time.perf_counter()
    proc = subprocess.Popen(cli + ["serve", "--port", "0"], cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines: list = []
    reader = threading.Thread(target=lambda: lines.extend(iter(proc.stdout.readline, "")), daemon=True)
    reader.start()
    try:
        wait_for(lambda: any(l.startswith("Serving on") for l in lines) or proc.poll() is not None, 120,
                 "the subprocess server's address")
        url = next((l.split()[-1] for l in lines if l.startswith("Serving on")), None)
        if url is None:
            raise SystemExit(f"serve phase: the subprocess server exited {proc.returncode}: {lines[-10:]}")
        port = int(url.rsplit(":", 1)[1])
        wait_for(lambda: http_request(port, "GET", "/status")[1]["model_loaded"] or proc.poll() is not None, 120,
                 "the subprocess server's readiness")
        out["serve_ready"] = time.perf_counter() - t0
        status = http_request(port, "GET", "/status")[1]
        code, hits = http_request(port, "GET", search_path(docs[N_LONG].split()[0] + " " + docs[N_LONG].split()[1], k=5))
        if not status["model_loaded"] or code != 200 or not hits:
            raise SystemExit(f"serve phase: the subprocess server answered {code} {hits} ({status})")
        t0 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(30)
        out["sigterm_exit"] = time.perf_counter() - t0
        reader.join(10)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    for line in lines[-6:]:
        log(f"  subprocess serve: {line.rstrip()}")
    log(f"serve: `python3 -m perceive_tpu_torch.cli` subprocesses: source add {out['add']:.1f} s, source scan "
        f"{out['scan']:.1f} s; serve ready in {out['serve_ready']:.1f} s over "
        f"{status['rows']} rows, /search answered {len(hits)} hits; SIGTERM exit code {rc} in "
        f"{out['sigterm_exit']:.2f} s  [{card}]")
    if rc != 0:
        raise SystemExit(f"serve phase: the subprocess server exited {rc} on SIGTERM")
    return out


def exact_top10(searcher, qvs, dev, with_rows: bool = False, k: int = 10):
    """The exact f32 top-10 (top-``k``; chunk hits deduped) of each of the
    (Q, dim) queries over the host mirror, in one pass over it;
    ``with_rows`` also returns the (Q, 10) rows of highest exact score
    (chunks not deduped)."""
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
    hits = [searcher._decode_hits(v, r, k) for v, r in zip(vals.cpu().numpy(), rows.cpu().numpy())]
    return (hits, rows[:, :10].cpu().numpy()) if with_rows else hits


def int8_slice(card: str, ctx: dict, dev) -> tuple:
    """Phase 8: SQLite holds INT8_ROWS rows (``slice_filler``), a fresh
    AppState (auto tier -> int8) from the bf16 base plus exactly the rows
    written since, 16 CLI queries, hits held against the exact f32
    top-10."""
    import torch

    from perceive_tpu_torch.cli import AppState
    from perceive_tpu_torch.ops import topk

    model = ctx["model"]
    n_more = INT8_ROWS - TOTAL_ROWS
    log(f"sqlite corpus: {n_more} more filler rows = {INT8_ROWS} rows, written in "
        f"{ctx['slice_filler']['int8_s']:.1f} s beside the kernel checks")

    # the bf16 base (phase 7) is of another tier: its f32 rows stream, and
    # only the rows written since replay from SQLite
    t0 = time.perf_counter()
    with build_route() as route:
        state = AppState(ctx["db_path"], model=model, highlights_model=model, device=dev)
    searcher = state.searcher
    m = searcher.matrix
    log(f"AppState build from the bf16 base: {len(m)} rows, tier {m.tier_name}, sweep_rows {m.sweep_rows}, "
        f"capacity {m.capacity} in {time.perf_counter() - t0:.1f} s  [{card}]")
    check_route(route, "int8", adopted=False, sqlite_rows=n_more)
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


def audit_routes(searcher):
    """The routes a CLI phase of the int2 tier runs: the audited one and,
    where the self-audit demoted the coarse pass, the same again with the
    audit disabled by its documented switch (PERCEIVE_TPU_COARSE_AUDIT=0,
    which trusts the coarse pass), so that the coarse kernels serve too.
    Yields (route, coarse pass serving); the state keeps the last route."""
    trusted = searcher.matrix.coarse_trusted
    yield "audited", trusted
    if not trusted:
        prev = os.environ.get("PERCEIVE_TPU_COARSE_AUDIT")
        os.environ["PERCEIVE_TPU_COARSE_AUDIT"] = "0"
        try:
            searcher.audit_coarse()  # disabled: trusts the coarse pass
        finally:
            if prev is None:
                os.environ.pop("PERCEIVE_TPU_COARSE_AUDIT")
            else:
                os.environ["PERCEIVE_TPU_COARSE_AUDIT"] = prev
        yield "audit off", True


def int2_slice(card: str, ctx: dict, dev) -> tuple:
    """Phase 12: SQLite filled to INT2_ROWS rows (``slice_filler``: a copy of the int8 slice's database), a fresh AppState (auto tier
    -> int2 with its int8 companion) built cold, and its self-audit, gated on its filler
    stratum (``audit_strata``), 16 CLI queries on each of ``audit_routes``
    (coarse pass serving: K5, K6 and K7 must all run; demoted: K7), hits
    against the exact f32 top-10, then the composed device pipeline against
    the plain one for every query."""
    import torch

    from perceive_tpu_torch.cli import AppState
    from perceive_tpu_torch.index.matrix import INT2

    model = ctx["model"]
    ctx["db_path"] = ctx["int2_db"]
    filler = ctx["slice_filler"]
    log(f"sqlite corpus: the int8 slice's database copied in {filler['copy_s']:.1f} s and "
        f"{INT2_ROWS - INT8_ROWS} more filler rows = {INT2_ROWS} rows written into the copy in "
        f"{filler['int2_s']:.1f} s, beside the kernel checks; the int2 slice and those after it run on the copy")

    # the bf16 base has served the int8 build: without it this build is cold
    os.unlink(ctx["snap"])
    t0 = time.perf_counter()
    with build_route() as route:
        state = AppState(ctx["db_path"], model=model, highlights_model=model, device=dev)
    searcher = state.searcher
    m = searcher.matrix
    cold_s = time.perf_counter() - t0
    log(f"AppState build (cold): {len(m)} rows, tier {m.tier_name}, sweep_rows {m.sweep_rows}, "
        f"capacity {m.capacity} in {cold_s:.1f} s  [{card}]")
    if route["snapshot"] != [False] or route["sqlite_rows"] != INT2_ROWS:
        raise SystemExit(f"the int2 build was not cold: {route}")
    if len(m) != INT2_ROWS or m.device != dev or m.dtype != INT2:
        raise SystemExit(f"searcher holds {len(m)} {m.tier_name} rows on {m.device}; want int2 on {dev}")
    log(f"int2 coarse self-audit: {json.dumps(searcher.coarse_audit)}")
    ctx["int2_cold"] = {"seconds": cold_s, "audit": dict(searcher.coarse_audit), "results": {}}
    audit_strata(card, searcher, ctx, "int2")
    ctx["exact"], ctx["exact_rows"] = exact_top10(
        searcher, torch.cat([query_vector(ctx, q, dev) for q in ctx["queries"]]), dev, with_rows=True)

    for route, coarse in audit_routes(searcher):
        tier = f"int2 ({route}, coarse pass {'serving' if coarse else 'demoted'})"
        reset_launch_counts()
        esc0 = searcher.escalations
        results, p50, p95 = cli_queries(card, state, ctx, tier, "int2_scores" if coarse else "scan_int8t")
        counts = launch_counts()
        launches = {name: counts[name] for name in ("int2_scores", "select_topk", "scan_int8t")}
        escalations = searcher.escalations - esc0
        log(f"{tier} CLI path: escalations {escalations}; launches {launches}")
        for name in ("int2_scores", "select_topk", "scan_int8t") if coarse else ("scan_int8t",):
            if launches[name] == 0:
                raise SystemExit(f"the {tier} CLI path launched no {name} kernel (audit {searcher.coarse_audit})")
        recall = served_recall(tier, results, ctx["exact"])
        ctx["int2_cold"]["results"][route] = [[(r["id"], r["score"]) for r in res] for res in results]

    t = check_int2_pipeline(card, searcher, ctx, dev, "int2")
    return state, {"launches": launches, "p50": p50, "p95": p95, "escalations": escalations,
                   "recall": recall, "pipeline_ms": t}


def check_int2_pipeline(card: str, searcher, ctx: dict, dev, tier: str, select: str = "exact") -> dict:
    """The composed device pipeline under ``select`` (exact: K5 -> K6 ->
    fine phase over the companion the int2 tier holds; tiletop: K10 -> K6
    -> fine phase; window, threshold: K5 -> glue) equals the composed plain
    one for every query, vals, rows and floor bit for bit; then its parts
    timed at Q=1."""
    import torch

    from perceive_tpu_torch.index.searcher import _k_bucket
    from perceive_tpu_torch.ops import int2, topk

    m = searcher.matrix
    (packed2, fine), src, (scales2, fscales) = m.device_view()
    kb = _k_bucket(searcher._first_fetch(10), m.sweep_rows)
    allowed = torch.from_numpy(searcher._allowed_arrays(None)[0]).to(dev)
    qvs = torch.cat([query_vector(ctx, q, dev) for q in ctx["queries"]])
    qp = torch.nn.functional.pad(qvs, (0, m.padded_dim - m.dim))
    kw = dict(n_sweep=m.sweep_rows, fetch=m.coarse_fetch, select=select)
    for qi in range(len(ctx["queries"])):
        args = (packed2, scales2, fine, fscales, src, qp[qi : qi + 1], allowed, kb)
        got, want = int2.scan_int2_coarse_fine(*args, **kw), int2.scan_int2_coarse_fine_plain(*args, **kw)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise SystemExit(f"{tier} query {qi}: the device pipeline differs from the plain one")
    kc = int2.int2_coarse_depth(kb, m.sweep_rows, m.coarse_fetch)
    route = {"exact": "K5 -> K6 -> fine phase", "tiletop": "K10 -> K6 -> fine phase"}.get(select, f"K5 -> {select} glue")
    log(f"{tier} device pipeline ({route} over the {tuple(fine.shape)} {fine.dtype} companion, "
        f"kb={kb}, kc={kc}) equals the plain pipeline for 16/16 queries: vals, rows and floor bit for bit")

    # where the pipeline's time goes, at Q = 1
    qi8, qscale = topk.quantize_queries(qp[:1])
    t = {"pipeline": cuda_ms(lambda: int2.scan_int2_coarse_fine(*args[:5], qp[:1], allowed, kb, **kw))}
    if select == "tiletop":
        tvals, _ = int2.int2_tiletop(packed2, scales2, src, qi8, qscale, allowed, m.sweep_rows, kc=kc)
        t["K10"] = cuda_ms(lambda: int2.int2_tiletop(packed2, scales2, src, qi8, qscale, allowed, m.sweep_rows,
                                                     kc=kc))
        t[f"K6 over {tvals.shape[1]}"] = cuda_ms(lambda: int2.select_topk(tvals, kc))
    else:
        t["K5"] = cuda_ms(lambda: int2.int2_scores(packed2, scales2, src, qi8, qscale, allowed, m.sweep_rows))
    if select == "exact":
        coarse = int2.int2_scores(packed2, scales2, src, qi8, qscale, allowed, m.sweep_rows)
        cvals, idx, _ = int2.select_topk(coarse, kc)
        t["K6"] = cuda_ms(lambda: int2.select_topk(coarse, kc))
        t["gather"] = cuda_ms(lambda: fine.index_select(1, idx.reshape(-1).long()))
        t["fine phase"] = cuda_ms(lambda: int2.fine_phase(cvals, idx, fine, fscales, qi8, qscale, kb))
    log(f"{tier} pipeline at Q=1 (ms): " + ", ".join(f"{k} {v:.4f}" for k, v in t.items()) + f"  [{card}]")
    return t


def doc_rows(searcher, ctx: dict) -> None:
    """Where the document windows sit in the matrix (SQLite's scan order
    places them; the build query has no ORDER BY), and how they fall into
    the tiletop select's tiles and lane bins at Q = 1."""
    from perceive_tpu_torch.index.matrix import CHUNK_STRIDE
    from perceive_tpu_torch.ops import int2

    m = searcher.matrix
    keys = m.item_ids[: m.rows]  # chunk keys: item id * CHUNK_STRIDE + chunk
    rows = np.flatnonzero((keys >= 0) & (keys < ctx["first_fill_id"] * CHUNK_STRIDE))
    tile = int2._pick_tile_int2(m.sweep_rows, 1, m.padded_dim // 4)
    tiles = np.unique(rows // tile)
    per_bin = np.bincount((rows % tile) % 128 + 128 * (rows // tile - tiles[0]), minlength=128 * len(tiles))
    log(f"document windows: {len(rows)} rows, rows {rows.min()}-{rows.max()}; tiletop tile {tile} rows at Q=1: "
        f"in tiles {tiles.tolist()[:8]}{' ...' if len(tiles) > 8 else ''}, {per_bin.max()} rows in the fullest of "
        f"their lane bins, {np.median(per_bin[per_bin > 0]):.0f} in the median one")


def candidate_recall(searcher, ctx: dict, dev, select: str) -> float:
    """The share of each query's 10 rows of highest exact f32 score that
    ``select`` keeps among its kc coarse candidates, over the 16 queries
    (the exact select's share is the yardstick)."""
    import torch

    from perceive_tpu_torch.index.searcher import _k_bucket
    from perceive_tpu_torch.ops import int2, topk

    m = searcher.matrix
    (packed2, _), src, (scales2, _) = m.device_view()
    kb = _k_bucket(searcher._first_fetch(10), m.sweep_rows)
    kc = int2.int2_coarse_depth(kb, m.sweep_rows, m.coarse_fetch)
    allowed = torch.from_numpy(searcher._allowed_arrays(None)[0]).to(dev)
    hit = 0
    for qi, q in enumerate(ctx["queries"]):
        qp = torch.nn.functional.pad(query_vector(ctx, q, dev), (0, m.padded_dim - m.dim))
        qi8, qs = topk.quantize_queries(qp)
        if select == "tiletop":
            tvals, trows = int2.int2_tiletop(packed2, scales2, src, qi8, qs, allowed, m.sweep_rows, kc=kc)
            cand = trows[0, int2.select_topk(tvals, kc)[1][0].long()]
        else:
            cand = int2.select_topk(int2.int2_scores(packed2, scales2, src, qi8, qs, allowed, m.sweep_rows), kc)[1][0]
        hit += len(set(cand.tolist()) & set(ctx["exact_rows"][qi].tolist()))
    return hit / ctx["exact_rows"].size


def int2_selects(card: str, state, ctx: dict, dev) -> dict:
    """Phase 14: the int2 slice's state with its coarse select pinned to
    tiletop, window and threshold in turn (with a mutation_gen bump under
    the matrix lock, as the self-audit sets it), 16 CLI queries each (K10
    must launch on the tiletop route, K5 on the others), each query's device
    pipeline held against the plain one bit for bit, and hits against the
    exact f32 top-10.  Window and threshold keep the exact select's
    candidates and more, so they gate served_recall_at_10 at 0.99; tiletop
    loses rows crowded out of its lane bins, so it gates on equality with its
    plain pipeline and reports its recall.  Back to "exact" at the end."""
    searcher = state.searcher
    m = searcher.matrix
    if not m.coarse_trusted:
        raise SystemExit("the int2 coarse pass is demoted: no select would serve")
    doc_rows(searcher, ctx)
    out = {}
    try:
        for select in SELECTS:
            with m._lock:
                m.coarse_select = select
                m.mutation_gen += 1
            tier = f"int2 {select}"
            kernel = "int2_tiletop" if select == "tiletop" else "int2_scores"
            reset_launch_counts()
            esc0 = searcher.escalations
            results, p50, p95 = cli_queries(card, state, ctx, tier, kernel, gate_self=select != "tiletop")
            counts = launch_counts()
            launches = {name: counts[name] for name in ("int2_scores", "int2_tiletop", "select_topk", "scan_int8t")}
            escalations = searcher.escalations - esc0
            log(f"{tier} CLI path: escalations {escalations}; launches {launches}")
            if launches[kernel] == 0 or (select == "tiletop" and launches["int2_scores"]):
                raise SystemExit(f"the {tier} CLI path did not run on {kernel} alone")
            recall = served_recall(tier, results, ctx["exact"], gate=select != "tiletop")
            t = check_int2_pipeline(card, searcher, ctx, dev, tier, select)
            out[select] = {"launches": launches, "p50": p50, "p95": p95, "escalations": escalations,
                           "recall": recall, "pipeline_ms": t}
            if select == "tiletop":
                got, want = candidate_recall(searcher, ctx, dev, "tiletop"), candidate_recall(searcher, ctx, dev, "exact")
                log(f"int2 candidate recall of the exact top-10 rows among the kc coarse candidates: tiletop "
                    f"{got:.6f}, exact {want:.6f}")
                out[select]["candidate_recall"] = got
    finally:
        with m._lock:
            m.coarse_select = "exact"
            m.mutation_gen += 1
    return out


def int2_adopt(card: str, state, ctx: dict, dev):
    """Phase 15: the cold-built int2 state (phases 12-14) saved through the
    CLI's ``snapshot`` (a full v2 base with the int2 payload), closed, and a
    fresh AppState (auto tier -> int2) that must adopt the base with 0 rows
    from SQLite: its device tensors (coarse, companion, both scales, source
    ids) equal the cold build's bit for bit, and so do its host mirror, ids,
    scale_hw and norm_hw and its self-audit's verdict; then 16 CLI queries on
    each of ``audit_routes`` give the cold build's hits, with K5, K6 and K7
    launched on the coarse-serving route."""
    import torch

    from perceive_tpu_torch.cli import AppState
    from perceive_tpu_torch.index.matrix import INT2

    cold = state.searcher
    m0 = cold.matrix
    (coarse0, fine0), src0, (cs0, fs0) = m0.device_view()
    saved = cli_snapshot(card, state, ctx, ctx["snap"], "full")
    state.close()
    t0 = time.perf_counter()
    with build_route() as route:
        state = AppState(ctx["db_path"], model=ctx["model"], highlights_model=ctx["model"], device=dev)
    adopt_s = time.perf_counter() - t0
    searcher = state.searcher
    m = searcher.matrix
    log(f"AppState build adopting the int2 base: {len(m)} rows, tier {m.tier_name} in {adopt_s:.1f} s; the cold "
        f"build took {ctx['int2_cold']['seconds']:.1f} s and the save {saved['seconds']:.1f} s for "
        f"{saved['base_bytes'] / 2**30:.3f} GiB  [{card}]")
    check_route(route, "int2", adopted=True, sqlite_rows=0)
    if len(m) != INT2_ROWS or m.device != dev or m.dtype != INT2:
        raise SystemExit(f"the adopted searcher holds {len(m)} {m.tier_name} rows on {m.device}")
    (coarse, fine), src, (cs, fs) = m.device_view()
    for name, a, b in (("coarse", coarse, coarse0), ("companion", fine, fine0), ("coarse scales", cs, cs0),
                       ("companion scales", fs, fs0), ("source ids", src, src0)):
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            raise SystemExit(f"the adopted {name} {tuple(a.shape)} {a.dtype} differs from the cold build's "
                             f"{tuple(b.shape)} {b.dtype}")
    host = (np.array_equal(m._host_vectors, m0._host_vectors) and np.array_equal(m.item_ids, m0.item_ids)
            and np.array_equal(m.source_ids, m0.source_ids) and m.row_of == m0.row_of)
    stats = (np.float32(m.scale_hw), np.float32(m.norm_hw)) == (np.float32(m0.scale_hw), np.float32(m0.norm_hw))
    if not host or not stats:
        raise SystemExit(f"the adopted host state differs from the cold build's (mirror and ids {host}, "
                         f"scale_hw/norm_hw {stats})")
    if searcher.coarse_audit != ctx["int2_cold"]["audit"]:
        raise SystemExit(f"the adopted state's self-audit {searcher.coarse_audit} differs from the cold build's "
                         f"{ctx['int2_cold']['audit']}")
    log(f"the adopted int2 state equals the cold build's: coarse {tuple(coarse.shape)}, companion "
        f"{tuple(fine.shape)} {fine.dtype}, scales and source ids bit for bit, the host mirror, ids, "
        f"scale_hw/norm_hw and the self-audit {json.dumps(searcher.coarse_audit)}")
    del cold, m0, coarse0, fine0, src0, cs0, fs0
    gc.collect()
    for route_name, serving in audit_routes(searcher):
        tier = f"int2 adopted ({route_name}, coarse pass {'serving' if serving else 'demoted'})"
        reset_launch_counts()
        results, _, _ = cli_queries(card, state, ctx, tier, "int2_scores" if serving else "scan_int8t")
        counts = launch_counts()
        launches = {name: counts[name] for name in ("int2_scores", "select_topk", "scan_int8t")}
        log(f"{tier} CLI path: launches {launches}")
        for name in ("int2_scores", "select_topk", "scan_int8t") if serving else ("scan_int8t",):
            if launches[name] == 0:
                raise SystemExit(f"the {tier} CLI path launched no {name} kernel")
        got = [[(r["id"], r["score"]) for r in res] for res in results]
        if got != ctx["int2_cold"]["results"][route_name]:
            raise SystemExit(f"{tier}: hits differ from the cold build's")
        log(f"{tier}: hits equal the cold build's for 16/16 queries")
    return state


def delta_gate(card: str, state, ctx: dict, dev) -> None:
    """Phase 20: in the AppState that adopted the int2 base (phase 15, kept
    open since; nothing has written the database or the base after it), the
    docs source's rows are removed and 300 new filler rows upserted through
    the Searcher's ingest hooks, with the database changed to match (the docs
    items hidden: deleting them would make SQLite scan item_embeddings once
    per item, whose foreign key to items has no index of its own);
    ``snapshot`` must answer "delta"; a new AppState built from base + delta
    holds the live keys SQLite holds, and its hits on the 16 queries match
    the exact f32 top-10 over SQLite's rows: the adopted rows (the base's,
    which phase 15 held bit for bit to the cold build from SQLite) less the
    docs items, plus the 300 rows read back from SQLite."""
    import torch

    from perceive_tpu_torch.cli import AppState
    from perceive_tpu_torch.index.matrix import CHUNK_STRIDE, INT2

    model = ctx["model"]
    searcher = state.searcher
    docs = state.source_by_name("docs")
    doc_items = [r[0] for r in state.db.read().execute("SELECT id FROM items WHERE source_id = ?", (docs.id,))]
    n_new = 300
    write_filler(state.db, ctx["fill_source"], ctx["next_id"], ctx["next_seq"], n_new, ctx["gen"],
                 ctx["filler_text"], model.model_id, model.model_version)
    new_ids = list(range(ctx["next_id"], ctx["next_id"] + n_new))
    ctx["next_id"] += n_new
    ctx["next_seq"] += n_new
    blobs = state.db.read().execute(
        """SELECT embedding FROM item_embeddings WHERE model_id = ? AND model_version = ? AND item_id >= ?
           ORDER BY item_id""", (model.model_id, model.model_version, new_ids[0])).fetchall()
    vecs = np.frombuffer(b"".join(b[0] for b in blobs), dtype="<f4").reshape(n_new, DIM)
    with state.db.write() as conn:
        conn.execute("UPDATE items SET hidden_at = ? WHERE source_id = ?", (int(time.time()), docs.id))
    # the reference, before the hooks reuse rows: the exact f32 candidates
    # over the adopted rows without the docs items, scored on the card
    qvs = torch.cat([query_vector(ctx, q, dev) for q in ctx["queries"]])
    t0 = time.perf_counter()
    ref_vals, ref_keys = mirror_candidates(searcher, doc_items, qvs, dev)
    new_vals = (qvs[:, :DIM] @ torch.from_numpy(vecs.copy()).to(dev).T).cpu().numpy()
    exact = merged_hits(np.concatenate([ref_vals, new_vals], axis=1),
                        np.concatenate([ref_keys, np.broadcast_to(np.asarray(new_ids) * CHUNK_STRIDE, new_vals.shape)], axis=1))
    ref_s = time.perf_counter() - t0
    on_emb, on_rm = searcher.pipeline_hooks()
    rows_before = len(searcher.matrix)
    on_rm(doc_items)
    on_emb(new_ids, [ctx["fill_source"]] * n_new, vecs)
    on_emb.after_commit()
    m = searcher.matrix
    log(f"through the hooks: {len(doc_items)} docs items hidden and removed ({rows_before - len(m) + n_new} rows), "
        f"{n_new} filler rows upserted: {len(m)} rows")
    cli_snapshot(card, state, ctx, ctx["snap"], "delta")
    state.close()
    del state, searcher, m
    gc.collect()

    t0 = time.perf_counter()
    with build_route() as route:
        state = AppState(ctx["db_path"], model=model, highlights_model=model, device=dev)
    log(f"AppState build from base + delta in {time.perf_counter() - t0:.1f} s  [{card}]")
    check_route(route, "int2", adopted=True, sqlite_rows=0)
    t0 = time.perf_counter()
    live = sqlite_live_keys(ctx["db_path"], model)
    log(f"reference: SQLite's {len(live)} live keys read in {time.perf_counter() - t0:.1f} s; the exact f32 top-10 "
        f"of 16 queries over the adopted rows less the docs items plus the 300 rows read back from SQLite, in "
        f"{ref_s:.1f} s  [{card}]")
    m = state.searcher.matrix
    if set(m.row_of) != set(live.tolist()) or len(live) != len(np.unique(live)) or m.dtype != INT2:
        raise SystemExit(f"base + delta holds {len(m)} {m.tier_name} keys; SQLite {len(live)} live keys")
    for qi, qv in enumerate(qvs.cpu().numpy()):
        got = state.searcher.search_vector(qv, 10)
        if not hits_match(got, exact[qi], 1e-5):
            raise SystemExit(f"query {qi}: base + delta hits differ from the exact top-10:\n{got}\n{exact[qi]}")
    log(f"base + delta equals SQLite: {len(m)} live keys; the hits of 16/16 queries match the exact f32 top-10 "
        f"(ids in order, scores within 1e-5)")
    state.close()


def mirror_candidates(searcher, drop_items, qvs, dev, keep: int = 40) -> tuple:
    """The (Q, keep) best exact f32 scores of the (Q, dim) queries over the
    searcher's host mirror, rows of ``drop_items`` left out, and their chunk
    keys; ``keep`` leaves room for items of several chunks."""
    import torch

    from perceive_tpu_torch.index.matrix import CHUNK_STRIDE

    m = searcher.matrix
    keys = torch.from_numpy(m.item_ids[: m.rows].copy()).to(dev)
    live = (keys >= 0) & ~torch.isin(keys // CHUNK_STRIDE, torch.tensor(list(drop_items), dtype=torch.int64, device=dev))
    scores = torch.empty((qvs.shape[0], m.rows), dtype=torch.float32, device=dev)
    for lo in range(0, m.rows, 262_144):
        hi = min(m.rows, lo + 262_144)
        scores[:, lo:hi] = qvs[:, : m.dim] @ torch.from_numpy(m.host_vectors_for(slice(lo, hi))).to(dev).T
    vals, rows = torch.topk(scores.masked_fill(~live, float("-inf")), keep, dim=1)
    return vals.cpu().numpy(), keys[rows].cpu().numpy()


def merged_hits(vals, keys, k: int = 10) -> list:
    """Each query's top-``k`` items, [(item id, score)], from (Q, n)
    candidate scores and chunk keys: an item scores its best chunk."""
    from perceive_tpu_torch.index.matrix import CHUNK_STRIDE

    out = []
    for qi in range(vals.shape[0]):
        hits, seen = [], set()
        for j in np.argsort(-vals[qi], kind="stable"):
            item = int(keys[qi, j]) // CHUNK_STRIDE
            if item not in seen and np.isfinite(vals[qi, j]):
                seen.add(item)
                hits.append((item, float(vals[qi, j])))
            if len(hits) == k:
                break
        out.append(hits)
    return out


def sqlite_live_keys(db_path: str, model) -> np.ndarray:
    """The chunk keys a build from SQLite loads for ``model`` (items neither
    hidden nor skipped), read straight from SQLite."""
    import itertools
    import sqlite3

    from perceive_tpu_torch.index.matrix import CHUNK_STRIDE

    with contextlib.closing(sqlite3.connect(f"file:{db_path}?mode=ro", uri=True)) as conn:
        cur = conn.execute(
            f"""SELECT items.id * {CHUNK_STRIDE} + ie.chunk_idx FROM items
                JOIN item_embeddings ie ON ie.item_id = items.id AND ie.model_id = ? AND ie.model_version = ?
                  AND ie.chunk_idx < {CHUNK_STRIDE}
                WHERE items.skipped IS NULL AND items.hidden_at IS NULL""",
            (model.model_id, model.model_version))
        return np.fromiter(itertools.chain.from_iterable(cur), dtype=np.int64)


def served_recall(tier: str, results, exact, gate: bool = True, scale=None) -> float:
    """The share of the exact f32 top-10 ids the CLI served, over the 16
    queries; fails (where ``gate``) under 0.99 or where a served score of
    one of them is off by more than 1e-5 (of ``scale[q]`` where given:
    ``score_scale``, the operands' norms)."""
    hit = total = 0
    worst = 0.0
    for qi, want in enumerate(exact):
        got = dict((r["id"], r["score"]) for r in results[qi])
        hit += sum(i in got for i, _ in want)
        total += len(want)
        unit = 1.0 if scale is None else scale[qi]
        worst = max([worst] + [abs(got[i] - s) / unit for i, s in want if i in got])
    recall = hit / max(total, 1)
    log(f"{tier} served_recall_at_10 {recall:.6f} ({hit}/{total}) against the exact f32 top-10; "
        f"max score error {worst:.3g}")
    if gate and (recall < 0.99 or worst > 1e-5):
        raise SystemExit(f"{tier} hits miss the exact f32 top-10 (recall {recall}, score error {worst})")
    return recall


def int4_slice(card: str, ctx: dict, dev) -> tuple:
    """Phase 17: a fresh AppState pinned to the int4 tier on the int2
    slice's corpus, streamed from the int2 base with 0 rows from SQLite, 16 CLI queries (flat K9 must run), hits against the
    exact f32 top-10."""
    from perceive_tpu_torch.cli import AppState

    t0 = time.perf_counter()
    model = ctx["model"]
    os.environ["PERCEIVE_TPU_MATRIX_DTYPE"] = "int4"
    try:
        with build_route() as route:
            state = AppState(ctx["db_path"], model=model, highlights_model=model, device=dev)
    finally:
        os.environ.pop("PERCEIVE_TPU_MATRIX_DTYPE")
    searcher = state.searcher
    m = searcher.matrix
    log(f"AppState build from the int2 base: {len(m)} rows, tier {m.tier_name}, sweep_rows {m.sweep_rows}, "
        f"capacity {m.capacity} in {time.perf_counter() - t0:.1f} s  [{card}]")
    # the base is int2: its f32 rows stream, and nothing was written since
    check_route(route, "int4", adopted=False, sqlite_rows=0)
    if len(m) != INT2_ROWS or m.device != dev or not m.packed4:
        raise SystemExit(f"searcher holds {len(m)} {m.tier_name} rows on {m.device}; want int4 on {dev}")

    reset_launch_counts()
    esc0 = searcher.escalations
    results, p50, p95 = cli_queries(card, state, ctx, "int4", "scan_int4")
    launches = launch_counts()["scan_int4"]
    escalations = searcher.escalations - esc0
    log(f"int4 CLI path: escalations {escalations}; scan_int4 launches {launches}")
    recall = served_recall("int4", results, ctx["exact"])
    return state, {"launches": launches, "p50": p50, "p95": p95, "escalations": escalations, "recall": recall}


def audit_overlaps(searcher, k: int = 10) -> tuple:
    """The last int2 self-audit, sample by sample: its seeded draw redrawn,
    and each sample's top-k overlap measured as its phase 3 does (the
    production coarse pipeline, reranked, against the companion sweep at 4x
    the first fetch, reranked; 8 queries a zero-padded sweep).  Returns
    (sample rows, overlaps, reference rows, served rows); fails unless the
    mean and the worst are the audit's own."""
    from perceive_tpu_torch.index.searcher import INT2_COARSE_FETCH, _coarse_audit_queries

    m = searcher.matrix
    live_src = m.source_ids[: m.rows]
    live = np.flatnonzero(live_src >= 0)
    src_ids, src_counts = np.unique(live_src[live], return_counts=True)
    rng = np.random.default_rng(0xC0A005E + searcher._audit_seq)
    sample = np.sort(searcher._stratified_sample(rng, live, live_src, src_ids, src_counts,
                                                 _coarse_audit_queries(len(live), k),
                                                 min(INT2_COARSE_FETCH, max(m.sweep_rows, 1))))
    overlaps, refs, served = row_overlaps(searcher, sample, k)
    mean = sum(o for o, ref in zip(overlaps, refs) if ref) / max(len(sample), 1)
    audit = searcher.coarse_audit
    if round(mean, 6) != audit["overlap"] or round(min(overlaps), 6) != audit["min_overlap"]:
        raise SystemExit(f"the audit redrawn sample by sample gives overlap {mean} / min {min(overlaps)}, "
                         f"the audit {audit}")
    return sample, overlaps, refs, served


def row_overlaps(searcher, rows, k: int = 10) -> tuple:
    """Stored rows as audit queries, each one's top-k overlap measured as the
    self-audit's phase 3 measures a sample's, at the matrix's current coarse
    depth and select.  Returns (overlaps, reference rows, served rows)."""
    from perceive_tpu_torch.index.searcher import _k_bucket

    m = searcher.matrix
    vecs = m.host_vectors_for(np.asarray(rows))
    vecs = (vecs / np.maximum(np.linalg.norm(vecs, axis=1, keepdims=True), 1e-12)).astype(np.float32)
    qp = searcher._pad_queries(vecs)
    allowed = searcher._allowed_arrays(None)[0]
    kb = _k_bucket(searcher._first_fetch(k), m.sweep_rows)
    kb_ref = _k_bucket(4 * kb, m.sweep_rows)
    refs, served, overlaps = [], [], []
    for lo in range(0, len(qp), 8):
        hi = min(lo + 8, len(qp))
        cq = np.zeros((8, qp.shape[1]), qp.dtype)
        cq[: hi - lo] = qp[lo:hi]
        rv, rr, _ = searcher._device_scan(cq, kb_ref, allowed, use_coarse=False)
        _, rr = searcher._rerank(vecs[lo:hi], rv[: hi - lo], rr[: hi - lo])
        cv, cr, _ = searcher._device_scan(cq, kb, allowed, use_coarse=True, force_coarse=True)
        _, cr = searcher._rerank(vecs[lo:hi], cv[: hi - lo], cr[: hi - lo])
        for j in range(hi - lo):
            ref = [r for r in rr[j][:k].tolist() if r >= 0]
            refs.append(ref)
            served.append(cr[j][: len(ref)].tolist())
            overlaps.append(len(set(ref) & set(served[-1])) / len(ref) if ref else 1.0)
    return overlaps, refs, served


def audit_strata(card: str, searcher, ctx: dict, tier: str) -> None:
    """The last self-audit by stratum, and its gate.  The audit draws by
    position within each source's rows, and the docs source (2,593 of
    4,194,304 rows) gets one sample; the matrix orders the docs' rows by
    item id, which the ingest assigns in the order the readers finish the
    walk's paths, so which window that sample takes depends on the file
    names and the readers, not on the program under test.  Gated: the
    filler samples (seeded rows after the docs, the same in every run) must
    pass the audit's own gates.  Logged: the docs sample's window and
    overlap, the window the same draw takes in document order (item ids
    d + 1) and its overlap over this run's vectors, and the overlap of
    every document window as an audit query."""
    from perceive_tpu_torch.index.matrix import CHUNK_STRIDE
    from perceive_tpu_torch.index.searcher import _coarse_audit_min

    m = searcher.matrix
    sample, overlaps, _, _ = audit_overlaps(searcher)
    keys = m.item_ids[: m.rows]
    fill_key = ctx["first_fill_id"] * CHUNK_STRIDE
    drows = np.flatnonzero((keys >= 0) & (keys < fill_key))
    doc_of = {item: d for d, item in enumerate(ctx["doc_ids"])}

    def window(row):  # (document, window) of a matrix row
        return doc_of[int(keys[row]) // CHUNK_STRIDE], int(keys[row]) % CHUNK_STRIDE

    t0 = time.perf_counter()
    every = np.asarray(row_overlaps(searcher, drows)[0])
    t_every = time.perf_counter() - t0
    at = {window(r): i for i, r in enumerate(drows)}
    in_doc_order = [(d, c) for d, n in enumerate(ctx["doc_windows"]) for c in range(n)]
    filler = np.asarray([o for r, o in zip(sample, overlaps) if keys[r] >= fill_key])
    for row, o in zip(sample, overlaps):
        if keys[row] >= fill_key:
            continue
        p = int(np.searchsorted(drows, row))
        (d, c), (d0, c0) = window(row), in_doc_order[p]
        log(f"{tier} self-audit, docs stratum: sample {p} of the docs' {len(drows)} rows is row {row} = document "
            f"{d} window {c}, overlap {o:.1f}; in document order the same draw takes document {d0} window {c0}, "
            f"overlap {every[at[(d0, c0)]]:.1f} over this run's vectors")
    floor, worst = _coarse_audit_min(), searcher._COARSE_AUDIT_MIN_SINGLE
    log(f"{tier} self-audit: {len(sample) - len(filler)} docs and {len(filler)} filler samples; filler overlap "
        f"mean {filler.mean():.4f} / min {filler.min():.1f} (gates {floor} / {worst}); every document window as "
        f"an audit query ({t_every:.1f} s): mean overlap {every.mean():.4f}, {int((every < 1).sum())} of "
        f"{len(every)} under 1, {int((every < worst).sum())} under {worst} (min {every.min():.1f})  [{card}]")
    if not (filler.mean() >= floor and filler.min() >= worst):
        raise SystemExit(f"the {tier} coarse pass fails the self-audit's gates on the filler samples")


def write_audit_case(searcher, path: str, row: int, overlap: float, ref, served, k: int = 10) -> dict:
    """One audit sample and the rows around it, for a reproduction off the
    card: the coarse pass's top 2 * kc rows, the companion's top kb_ref rows
    (the reference's candidates) and the sample's own row, in the corpus's
    row order, with their keys, f32 vectors, sources and device bytes.
    Quantization is per row, so over these rows the coarse top kc and the
    companion's top kb_ref are the same rows as over the whole corpus.
    Also the coarse and the companion rank (score, then lower row) of each
    reference row over the whole corpus."""
    import torch

    from perceive_tpu_torch.index.searcher import _k_bucket
    from perceive_tpu_torch.ops import int2, topk

    m = searcher.matrix
    (packed2, fine), src, (scales2, fscales) = m.device_view()
    n = m.sweep_rows
    kb = _k_bucket(searcher._first_fetch(k), n)
    kb_ref = _k_bucket(4 * kb, n)
    kc = int2.int2_coarse_depth(kb, n, m.coarse_fetch)
    v = m.host_vectors_for(np.array([row]))
    v = (v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)).astype(np.float32)
    q = torch.from_numpy(searcher._pad_queries(v)).to(m.device)
    allowed = torch.from_numpy(searcher._allowed_arrays(None)[0]).to(m.device)
    qi8, qs = topk.quantize_queries(q)
    coarse = int2.int2_scores(packed2, scales2, src, qi8, qs, allowed, n)
    _, ctop, _ = int2.select_topk_plain(coarse, min(2 * kc, n))
    _, ftop = topk.scan_topk_int4(fine, fscales, src, q, allowed, kb_ref, n)
    fscore = topk.mask_scores(topk.scores_int4(fine[:, :n], fscales[:n], qi8, qs), src[:n], allowed)

    def ranks(scores):  # by the kernels' key: score, then the lower row
        s = scores[0]
        return [int((s > s[r]).sum()) + int((s[:r] == s[r]).sum()) for r in ref]

    rows = np.unique(np.concatenate([ctop.cpu().numpy().ravel(), ftop.cpu().numpy().ravel(), [row], ref]))
    rows = rows[rows >= 0]
    rt = torch.from_numpy(rows).to(m.device)
    case = {"rows": rows, "keys": m.item_ids[rows], "vecs": m.host_vectors_for(rows), "src": m.source_ids[rows],
            "pos": int(np.searchsorted(rows, row)), "row": row, "dim": m.dim, "overlap": overlap,
            "ref": np.asarray(ref), "served": np.asarray(served), "kb": kb, "kb_ref": kb_ref, "kc": kc,
            "fetch": m.coarse_fetch, "first_fetch": searcher._first_fetch(k),
            "ref_coarse_rank": ranks(coarse), "ref_fine_rank": ranks(fscore),
            "packed2": packed2[:, rt].cpu().numpy(), "scales2": scales2[rt].cpu().numpy(),
            "packed4": fine[:, rt].cpu().numpy(), "scales4": fscales[rt].cpu().numpy()}
    np.savez(path, **case)
    return case


def int2_int4_slice(card: str, state, ctx: dict, dev, audit_case: str = "") -> None:
    """Phase 19: the int4 state retiered to int2 under
    PERCEIVE_TPU_INT2_FINE=int4 (the companion takes the int4 tier's bytes;
    only the host mirror is re-read) and its self-audit; 16 CLI queries on
    the route the verdict gives (trusted: K5, K6 and flat K9 must run;
    demoted: the companion sweep, flat K9) of ``audit_routes``, so that
    where the audit demotes, K5, K6 and flat K9 serve the 16 queries again
    with the audit off; every served set held against the exact f32 top-10;
    the composed device pipeline against the plain one; one batch of each
    mix."""
    from perceive_tpu_torch.index.matrix import INT2

    searcher = state.searcher
    m = searcher.matrix
    os.environ["PERCEIVE_TPU_INT2_FINE"] = "int4"
    try:
        t0 = time.perf_counter()
        m.retier(INT2)
        searcher.audit_coarse()
        log(f"retier to {m.tier_name} and self-audit in {time.perf_counter() - t0:.1f} s  [{card}]")
        if m.tier_name != "int2+int4fine":
            raise SystemExit(f"the retiered matrix is {m.tier_name}, not int2+int4fine")
        log(f"int2+int4 coarse self-audit: {json.dumps(searcher.coarse_audit)}")
        sample, overlaps, refs, served = audit_overlaps(searcher)
        low = [(int(sample[i]), overlaps[i]) for i in np.argsort(overlaps, kind="stable")
               if overlaps[i] < 1.0]
        log(f"int2+int4 self-audit sample by sample: {len(low)} of {len(sample)} under overlap 1 "
            f"(row, overlap): {low[:16]}")
        audit_strata(card, searcher, ctx, "int2+int4")
        if audit_case and low:
            i = int(np.flatnonzero(sample == low[0][0])[0])
            case = write_audit_case(searcher, audit_case, low[0][0], low[0][1], refs[i], served[i])
            log(f"int2+int4 worst audit sample, row {low[0][0]}: reference rows {case['ref'].tolist()}, served "
                f"{case['served'].tolist()}; the reference rows' coarse ranks {case['ref_coarse_rank']} (kc "
                f"{case['kc']}) and companion ranks {case['ref_fine_rank']} (kb {case['kb']}); "
                f"{len(case['rows'])} rows around it written to {audit_case}")
        searcher.audit_coarse()  # a second witness: the audit's next seeded sample
        log(f"int2+int4 coarse self-audit on its next sample: {json.dumps(searcher.coarse_audit)}")
        for route, coarse in audit_routes(searcher):
            tier = f"int2+int4 ({route}, coarse pass {'serving' if coarse else 'demoted'})"
            reset_launch_counts()
            esc0 = searcher.escalations
            results, _, _ = cli_queries(card, state, ctx, tier, "int2_scores" if coarse else "scan_int4")
            counts = launch_counts()
            want = ("int2_scores", "select_topk", "scan_int4") if coarse else ("scan_int4",)
            launches = {name: counts[name] for name in ("int2_scores", "select_topk", "scan_int4")}
            escalations = searcher.escalations - esc0
            log(f"{tier} CLI path: escalations {escalations}; launches {launches}")
            for name in want:
                if launches[name] == 0:
                    raise SystemExit(f"the {tier} CLI path launched no {name} kernel")
            served_recall(tier, results, ctx["exact"])
        check_int2_pipeline(card, searcher, ctx, dev, "int2+int4")
        batch_path(card, state, ctx, "int2+int4", "scan_int4_slab", reps=1, executor=False)
    finally:
        os.environ.pop("PERCEIVE_TPU_INT2_FINE")


# -- the mesh steps (one card, repeated slots) ----------------------------------------

MESH_SLOTS = 4  # the sharded searcher's slots, all on the one card
MESH_BUDGET_S = 60  # the mesh steps' budget, in all


def counted_sweeps(searcher) -> list:
    """Count the searcher's merged sweeps (``_sweep`` calls) in a list cell;
    ``del searcher._sweep`` restores the class's method."""
    calls = [0]
    sweep = searcher._sweep

    def counted(*args, **kw):
        calls[0] += 1
        return sweep(*args, **kw)

    searcher._sweep = counted
    return calls


def shard_launches(tier: str, before: dict, sweeps: int, kernels: tuple) -> dict:
    """The launches of ``kernels`` since ``before``: each must have run, and
    all of them together MESH_SLOTS times a merged sweep's worth (one
    launch a shard a sweep for every kernel of the route)."""
    now = launch_counts()
    got = {k: now[k] - before[k] for k in kernels}
    if any(v == 0 or v % MESH_SLOTS for v in got.values()):
        raise SystemExit(f"{tier}: launches {got} over {sweeps} sweeps; want every kernel on all {MESH_SLOTS} shards")
    return got


def mesh_bf16(card: str, state, ctx: dict, dev) -> float:
    """After phase 7's snapshot: the 1M-row bf16 base adopted into a
    ShardedSearcher over [cuda:0] * MESH_SLOTS; the 16 CLI query texts
    through its fused path (the slice's model) hold the CLI's hits on the
    one-device state (ids, scores within SCAN_TOL), with MESH_SLOTS K1
    launches a sweep; one 2,048-query search_vectors_batch (K2 on every
    shard) equals the one-device answers."""
    import torch

    from perceive_tpu_torch.parallel import ShardedSearcher, make_mesh

    t_all = time.perf_counter()
    model = ctx["model"]
    want, _, _ = cli_queries(card, state, ctx, "bf16 (one device, the CLI's hits for the mesh)", "scan_topk")
    t0 = time.perf_counter()
    ss = ShardedSearcher(model.model_id, model.model_version, DIM, make_mesh(devices=[dev] * MESH_SLOTS))
    if not ss.matrix.adopt_snapshot(ctx["snap"]):
        raise SystemExit("the sharded matrix refused the bf16 base")
    ss.matrix.sync()
    torch.cuda.synchronize()
    m = ss.matrix
    log(f"mesh bf16: the 1M-row base adopted over {MESH_SLOTS} slots in {time.perf_counter() - t0:.2f} s: "
        f"{len(m)} rows, capacity {m.capacity}, {m.n_local} rows a shard  [{card}]")
    if len(m) != len(state.searcher.matrix):
        raise SystemExit(f"the sharded matrix holds {len(m)} rows, the one-device one {len(state.searcher.matrix)}")
    reset_launch_counts()
    sweeps = counted_sweeps(ss)
    before = launch_counts()
    t0 = time.perf_counter()
    got = [ss.search_fused(model, q, 10) for q in ctx["queries"]]
    t_q = time.perf_counter() - t0
    launches = shard_launches("mesh bf16 fused queries", before, sweeps[0], ("scan_topk",))
    if launches["scan_topk"] != MESH_SLOTS * sweeps[0] or sweeps[0] < len(got):
        raise SystemExit(f"mesh bf16: {launches} over {sweeps[0]} sweeps")
    for qi, (g, w) in enumerate(zip(got, want)):
        if not hits_match(g, [(r["id"], r["score"]) for r in w], SCAN_TOL):
            raise SystemExit(f"mesh bf16 query {qi}: hits differ from the CLI's:\n{g}\n{w}")
    log(f"mesh bf16: 16 fused queries equal the CLI's hits (tol {SCAN_TOL}); {sweeps[0]} sweeps, launches {launches}; "
        f"{t_q * 1e3 / len(got):.2f} ms a query  [{card}]")
    before = launch_counts()
    t0 = time.perf_counter()
    batch = ss.search_vectors_batch(ctx["vecs"], 10)
    t_b = time.perf_counter() - t0
    launches = shard_launches("mesh bf16 batch", before, 0, ("scan_slab",))
    del ss._sweep
    one = state.searcher.search_vectors_batch(ctx["vecs"], 10)
    bad = sum(not hits_match(g, w, SCAN_TOL) for g, w in zip(batch, one))
    log(f"mesh bf16: search_vectors_batch of {N_BATCH} queries in {t_b * 1e3:.1f} ms over {MESH_SLOTS} slots, "
        f"launches {launches}; equal to the one-device answers: {N_BATCH - bad}/{N_BATCH}  [{card}]")
    if bad:
        raise SystemExit(f"{bad} sharded batch answers differ from the one-device ones")
    del ss, m
    gc.collect()
    torch.cuda.empty_cache()
    return time.perf_counter() - t_all


def mesh_encode(card: str, ctx: dict, dev) -> float:
    """``dryrun_multichip`` over [cuda:0] * 4, then the documents' windows
    re-encoded through ``Model.shard_over`` at model-parallel 1 (2 slots)
    and 2 (2 x 2) against the stored vectors (INGEST_TOL), with K11
    launched exactly once a slot (a model slot under TP) a layer for every
    batch whose bucket reaches KERNEL_MIN_SEQ."""
    import torch

    from perceive_tpu_torch.models import Model, batch_bucket
    from perceive_tpu_torch.ops import attention as attn
    from perceive_tpu_torch.parallel import make_mesh
    from perceive_tpu_torch.parallel.dryrun import dryrun_multichip

    t_all = time.perf_counter()
    t0 = time.perf_counter()
    out = dryrun_multichip(4, devices=[dev] * 4)
    log(f"mesh dryrun_multichip(4) over [cuda:0] * 4 in {time.perf_counter() - t0:.2f} s: {out}  [{card}]")
    base = ctx["model"]
    windows, stored = ctx["windows"], ctx["stored"]
    for mp in (1, 2):
        mesh = make_mesh(devices=[dev] * 2 * mp, model_parallel=mp)
        model = Model(base.encoder.params(), base.arch, base.head, base.tokenizer, device=dev,
                      compute_dtype=base.compute_dtype, model_id=base.model_id).shard_over(mesh)
        data = mesh.shape["data"]
        expect = 0
        for s in range(0, len(windows), ENCODE_BATCH):
            part = windows[s : s + ENCODE_BATCH]
            bucket = batch_bucket(len(part))
            seq = model.tokenizer.pack_token_windows(part, pad_batch_to=bucket).shape[1]
            if seq >= attn.KERNEL_MIN_SEQ:
                expect += (data if bucket % data == 0 else 1) * mp * base.arch.num_layers
        attn.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        embs = np.concatenate([
            model.materialize(model.encode_dispatch_token_windows(windows[s : s + ENCODE_BATCH]))
            for s in range(0, len(windows), ENCODE_BATCH)
        ])
        secs = time.perf_counter() - t0
        err = float(np.abs(embs - stored).max())
        log(f"mesh encode ({mesh.shape['data']} data x {mp} model slots): {len(windows)} windows in {secs:.2f} s, "
            f"max_abs_err against the stored vectors {err:.3g} (tol {INGEST_TOL}); K11 launches {attn.LAUNCHES}, "
            f"want {expect}  [{card}]")
        if not err <= INGEST_TOL or attn.LAUNCHES != expect or expect == 0:
            raise SystemExit(f"the sharded encode at model-parallel {mp} failed its gates")
        del model
    torch.cuda.empty_cache()
    return time.perf_counter() - t_all


def mesh_int2(card: str, state, ctx: dict, dev) -> float:
    """After phase 15: the int2 base (int8 companion) adopted into a
    ShardedSearcher over [cuda:0] * MESH_SLOTS and audited (its verdict
    logged beside the one-device one); the 16 query texts through its fused
    path on each of ``audit_routes`` (the coarse route: K5, K6 and K7 on
    every shard), served_recall_at_10 against the exact f32 top-10 gated at
    0.99; every shard's device pipeline equal to its plain one bit for bit,
    and the merged floor the max of the shards'; one 2,048-query batch (K8
    on every shard) against the one-device answers."""
    import torch

    from perceive_tpu_torch.index.matrix import INT2
    from perceive_tpu_torch.index.searcher import _k_bucket
    from perceive_tpu_torch.ops import int2
    from perceive_tpu_torch.parallel import ShardedSearcher, make_mesh

    t_all = time.perf_counter()
    model = ctx["model"]
    t0 = time.perf_counter()
    ss = ShardedSearcher(model.model_id, model.model_version, DIM, make_mesh(devices=[dev] * MESH_SLOTS), dtype=INT2)
    if not ss.matrix.adopt_snapshot(ctx["snap"]):
        raise SystemExit("the sharded matrix refused the int2 base")
    t_adopt = time.perf_counter() - t0
    ss._audit_coarse_if_stale()
    m = ss.matrix
    log(f"mesh int2: the {len(m)}-row base adopted over {MESH_SLOTS} slots in {t_adopt:.2f} s ({m.tier_name}, "
        f"{m.n_local} rows a shard), audited in {time.perf_counter() - t0 - t_adopt:.2f} s  [{card}]")
    log(f"mesh int2 self-audit: {json.dumps(ss.coarse_audit)}; one device: {json.dumps(state.searcher.coarse_audit)}")
    if m.fine_bits != state.searcher.matrix.fine_bits:
        raise SystemExit(f"the sharded companion is int{m.fine_bits}, the one-device one int"
                         f"{state.searcher.matrix.fine_bits}")
    for route, coarse in audit_routes(ss):
        tier = f"mesh int2 ({route}, coarse pass {'serving' if coarse else 'demoted'})"
        reset_launch_counts()
        sweeps = counted_sweeps(ss)
        before = launch_counts()
        hits = [ss.search_fused(model, q, 10) for q in ctx["queries"]]
        kernels = ("int2_scores", "select_topk", "scan_int8t") if coarse else ("scan_int8t",)
        launches = shard_launches(tier, before, sweeps[0], kernels)
        del ss._sweep
        log(f"{tier}: {sweeps[0]} sweeps, launches {launches}")
        served_recall(tier, [[{"id": i, "score": sc} for i, sc in h] for h in hits], ctx["exact"])

    # every shard's pipeline against its plain one, and the floors' merge
    (p2, fine), src, (s2, fs) = m.device_view()
    kb = _k_bucket(ss._first_fetch(10), m.sweep_rows)
    kl = min(kb, m.n_local)
    allowed = torch.from_numpy(ss._allowed_arrays(None)[0]).to(dev)
    kw = dict(fetch=m.coarse_fetch, select=m.coarse_select)
    for qi, q in enumerate(ctx["queries"]):
        qp = torch.nn.functional.pad(query_vector(ctx, q, dev), (0, m.padded_dim - m.dim))
        floors = []
        for s in range(MESH_SLOTS):
            args = (p2[s], s2[s], fine[s], fs[s], src[s], qp, allowed, kl)
            a, b = int2.scan_int2_coarse_fine(*args, **kw), int2.scan_int2_coarse_fine_plain(*args, **kw)
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                raise SystemExit(f"mesh int2 query {qi}, shard {s}: the device pipeline differs from the plain one")
            floors.append(b[2])
        merged = ss._sweep((p2, fine), (s2, fs), src, qp, allowed, kb, m.sweep_rows, True)[2]
        if not torch.equal(merged, torch.stack(floors).amax(dim=0)):
            raise SystemExit(f"mesh int2 query {qi}: the merged floor is not the max of the shards'")
    log(f"mesh int2: every shard's device pipeline equals its plain one for 16/16 queries (kl={kl}, vals, rows "
        f"and floor bit for bit); the merged floors are the shards' max")

    reset_launch_counts()
    t0 = time.perf_counter()
    batch = ss.search_vectors_batch(ctx["vecs_random"], 10)
    t_b = time.perf_counter() - t0
    launches = launch_counts()
    if launches["scan_int8t_slab"] == 0 or launches["scan_int8t_slab"] % MESH_SLOTS:
        raise SystemExit(f"the mesh int2 batch launched K8 {launches['scan_int8t_slab']} times")
    one = state.searcher.search_vectors_batch(ctx["vecs_random"], 10)
    bad = sum(not hits_match(g, w, 1e-5) for g, w in zip(batch, one))
    log(f"mesh int2: search_vectors_batch of {N_BATCH} random queries in {t_b * 1e3:.1f} ms over {MESH_SLOTS} "
        f"slots, K8 launches {launches['scan_int8t_slab']}, K7 {launches['scan_int8t']}; equal to the one-device "
        f"answers: {N_BATCH - bad}/{N_BATCH}  [{card}]")
    if bad:
        raise SystemExit(f"{bad} sharded int2 batch answers differ from the one-device ones")
    del ss, m, p2, fine, src, s2, fs
    gc.collect()
    torch.cuda.empty_cache()
    return time.perf_counter() - t_all


# -- the tokenizer.json families: byte-level BPE and Unigram checkpoints at full width --

# the published config.json of each sentence-transformers checkpoint (the
# widths; weights are seeded) and its sentence_bert_config's max_seq_length
FAMILIES = {
    "AllDistilrobertaV1": {
        "config": {"model_type": "roberta", "architectures": ["RobertaModel"], "vocab_size": 50265,
                   "hidden_size": 768, "num_hidden_layers": 6, "num_attention_heads": 12,
                   "intermediate_size": 3072, "hidden_act": "gelu", "max_position_embeddings": 514,
                   "type_vocab_size": 1, "pad_token_id": 1, "bos_token_id": 0, "eos_token_id": 2,
                   "layer_norm_eps": 1e-05},
        "max_seq_length": 512, "tokenizer": "bpe"},
    "ParaphraseAlbertSmallV2": {
        "config": {"model_type": "albert", "architectures": ["AlbertModel"], "vocab_size": 30000,
                   "embedding_size": 128, "hidden_size": 768, "num_hidden_layers": 6, "num_hidden_groups": 1,
                   "inner_group_num": 1, "num_attention_heads": 12, "intermediate_size": 3072,
                   "hidden_act": "gelu_new", "max_position_embeddings": 512, "type_vocab_size": 2,
                   "pad_token_id": 0, "bos_token_id": 2, "eos_token_id": 3, "layer_norm_eps": 1e-12},
        "max_seq_length": 512, "tokenizer": "unigram"},
    # the DistilBERT checkpoints: WordPiece vocab.txt files, DistilBERT key
    # names; tas-b pools the CLS token, distiluse has the registry's one
    # Dense head (768 -> 512, tanh); neither normalizes
    "MsMarcoDistilbertBaseTasB": {
        "config": {"model_type": "distilbert", "architectures": ["DistilBertModel"], "vocab_size": 30522,
                   "dim": 768, "n_layers": 6, "n_heads": 12, "hidden_dim": 3072, "activation": "gelu",
                   "max_position_embeddings": 512, "sinusoidal_pos_embds": False, "pad_token_id": 0},
        "max_seq_length": 512, "tokenizer": "wordpiece", "pooling": "cls", "normalize": False},
    "DistiluseBaseMultilingualCased": {
        "config": {"model_type": "distilbert", "architectures": ["DistilBertModel"], "vocab_size": 119547,
                   "dim": 768, "n_layers": 6, "n_heads": 12, "hidden_dim": 3072, "activation": "gelu",
                   "max_position_embeddings": 512, "sinusoidal_pos_embds": False, "pad_token_id": 0},
        "max_seq_length": 128, "tokenizer": "wordpiece-cased", "dense": 512, "normalize": False},
}
# the default configuration (cli/state.py DEFAULT_MODEL, DEFAULT_HIGHLIGHT_MODEL)
DEFAULT_CHECKPOINTS = {
    "MsMarcoBertBaseDotV5": {  # mean pooling, no Normalize: unnormalized dot-product rows
        "config": {"model_type": "bert", "architectures": ["BertModel"], "vocab_size": 30522, "hidden_size": 768,
                   "num_hidden_layers": 12, "num_attention_heads": 12, "intermediate_size": 3072,
                   "hidden_act": "gelu", "max_position_embeddings": 512, "type_vocab_size": 2, "pad_token_id": 0,
                   "layer_norm_eps": 1e-12},
        "max_seq_length": 512, "tokenizer": "wordpiece", "normalize": False},
    "AllMiniLmL6V2": {
        "config": {"model_type": "bert", "architectures": ["BertModel"], "vocab_size": 30522, "hidden_size": 384,
                   "num_hidden_layers": 6, "num_attention_heads": 12, "intermediate_size": 1536,
                   "hidden_act": "gelu", "max_position_embeddings": 512, "type_vocab_size": 2, "pad_token_id": 0,
                   "layer_norm_eps": 1e-12},
        "max_seq_length": 256, "tokenizer": "wordpiece"},
}
FAMILY_DOCS = 256
FAMILY_LONG = 64  # documents over 400 tokens: their 510-token windows ride the 512 bucket, K11's
FAMILY_FILLER = 65_536
FAMILY_PHASE_S = 90  # the phase's budget, all four families
ACCENTED = {"a": "á", "e": "é", "i": "í", "o": "ó", "u": "ú"}
CJK_CHARS = 4096  # CJK ideographs from U+4E00, each a token of the cased vocabulary


def cased_vocab(size: int = 119547) -> list[str]:
    """A deterministic ``size``-entry cased WordPiece vocabulary: the
    specials and single characters of tiny_test_vocab, capital and
    accented letters, CJK_CHARS ideographs, continuation syllables (plain
    and accented), then two-syllable words in lower case, capitalized and
    with an accented second syllable, and three-syllable words lower and
    capitalized."""
    from perceive_tpu_torch.models.tokenize import tiny_test_vocab

    accented = [c + ACCENTED[v] for c in "bcdfghjklmnprstvz" for v in "aeiou"]
    letters = [chr(c) for c in range(ord("A"), ord("Z") + 1)] + list("áéíóúÁÉÍÓÚñÑçÇüÜöÖ")
    two = [w for a in SYLLABLES for b in SYLLABLES for w in (a + b, (a + b).capitalize())]
    words = dict.fromkeys([*tiny_test_vocab([]), *letters, *("##" + c for c in letters),
                           *(chr(0x4E00 + i) for i in range(CJK_CHARS)), *("##" + x for x in SYLLABLES + accented),
                           *two, *(a + b for a in SYLLABLES for b in accented)])
    need = size - len(words)
    three = (w for a in SYLLABLES for b in SYLLABLES for c in SYLLABLES for w in (a + b + c, (a + b + c).capitalize()))
    words.update(dict.fromkeys(itertools.islice(three, need)))
    return list(words)[:size]


def checkpoint_tokenizer(spec: dict):
    """The tokenizer a checkpoint spec names: a tokenizer.json dict (bpe,
    unigram) or a WordPiece vocabulary list (uncased, cased)."""
    kind, size = spec["tokenizer"], spec["config"]["vocab_size"]
    return {"bpe": bpe_tokenizer_json, "unigram": unigram_tokenizer_json, "wordpiece": minilm_vocab,
            "wordpiece-cased": cased_vocab}[kind](size)


def install_checkpoints(models_dir: str) -> dict:
    """Every checkpoint the families and the default configuration load,
    under ``models_dir``: name -> the seconds it took.
    The smoke writes them in a worker process (``host_job``) while the
    kernel checks run."""
    specs = [(name, spec, seed) for seed, (name, spec) in enumerate(FAMILIES.items(), start=20)]
    specs += [(name, spec, seed) for seed, (name, spec) in enumerate(DEFAULT_CHECKPOINTS.items(), start=30)]
    return {name: install_checkpoint(models_dir, name, spec, seed) for name, spec, seed in specs}


def install_checkpoint(models_dir: str, name: str, spec: dict, seed: int):
    """Writes the checkpoint ``spec`` describes for the registry's ``name``
    under ``models_dir`` (its hub name as the folder): seeded weights at
    the published widths.  Returns the seconds taken."""
    from perceive_tpu_torch.models import ModelType

    t0 = time.perf_counter()
    tok = checkpoint_tokenizer(spec)
    write_checkpoint(os.path.join(models_dir, ModelType.parse(name).checkpoint_dir_name), spec["config"], tok,
                     spec["max_seq_length"], seed, pooling=spec.get("pooling", "mean"),
                     normalize=spec.get("normalize", True), dense=spec.get("dense", 0),
                     lower=spec["tokenizer"] != "wordpiece-cased")
    return time.perf_counter() - t0


def _added(i: int, content: str, lstrip: bool = False) -> dict:
    return {"id": i, "content": content, "single_word": False, "lstrip": lstrip, "rstrip": False,
            "normalized": False, "special": True}


def bpe_tokenizer_json(vocab_size: int = 50265) -> dict:
    """A RoBERTa-style byte-level BPE tokenizer.json: the five specials
    (<mask> last, as RoBERTa has it), the 256 byte symbols, and merges that
    build syllables, space-led syllables, then space-led two- and
    three-syllable words (ranked before the bare two-syllable ones, so a
    space-led word merges whole), up to ``vocab_size`` entries."""
    from perceive_tpu_torch.models.tokenizer_json import BYTES_CHAR

    vocab = {t: i for i, t in enumerate(("<s>", "<pad>", "</s>", "<unk>"))}
    for b in range(256):
        vocab[BYTES_CHAR[b]] = len(vocab)
    merges: list = []
    sp = BYTES_CHAR[ord(" ")]

    def merge(a: str, b: str) -> None:
        if len(vocab) < vocab_size - 1 and a + b not in vocab:
            merges.append([a, b])
            vocab[a + b] = len(vocab)

    for syl in SYLLABLES:
        merge(syl[0], syl[1])
    for syl in SYLLABLES:
        merge(sp, syl)
    for a in SYLLABLES:
        for b in SYLLABLES:
            merge(sp + a, b)
    for a in SYLLABLES:
        for b in SYLLABLES:
            merge(a, b)
    for a in SYLLABLES:
        for b in SYLLABLES:
            for c in SYLLABLES:
                merge(sp + a + b, c)
    vocab["<mask>"] = vocab_size - 1
    byte_level = {"add_prefix_space": False, "trim_offsets": True, "use_regex": True}
    return {"version": "1.0", "truncation": None, "padding": None,
            "added_tokens": [_added(i, t) for i, t in enumerate(("<s>", "<pad>", "</s>", "<unk>"))]
            + [_added(vocab_size - 1, "<mask>", lstrip=True)],
            "normalizer": None, "pre_tokenizer": {"type": "ByteLevel", **byte_level},
            "post_processor": {"type": "RobertaProcessing", "sep": ["</s>", 2], "cls": ["<s>", 0],
                               "trim_offsets": True, "add_prefix_space": False},
            "decoder": {"type": "ByteLevel", **byte_level},
            "model": {"type": "BPE", "dropout": None, "unk_token": None, "continuing_subword_prefix": None,
                      "end_of_word_suffix": None, "fuse_unk": False, "byte_fallback": False,
                      "ignore_merges": False, "vocab": vocab, "merges": merges}}


def unigram_tokenizer_json(vocab_size: int = 30000, seed: int = 5) -> dict:
    """An ALBERT-style Unigram tokenizer.json: <pad>, <unk>, [CLS], [SEP],
    [MASK], then the letters, syllables and "▁"-led syllables and words
    with seeded scores (a whole word outscores its pieces), up to
    ``vocab_size`` entries; ALBERT's normalizer sequence without its
    character map, WhitespaceSplit + Metaspace, and [CLS] $A [SEP]."""
    rng = np.random.default_rng(seed)
    specials = ("<pad>", "<unk>", "[CLS]", "[SEP]", "[MASK]")
    pieces = [[t, 0.0] for t in specials]
    seen = set(specials)

    def add(piece: str, score: float) -> None:
        if len(pieces) < vocab_size and piece not in seen:
            seen.add(piece)
            pieces.append([piece, float(score - rng.random())])

    for c in "▁abcdefghijklmnopqrstuvwxyz0123456789":
        add(c, -12.0)
    for syl in SYLLABLES:
        add(syl, -10.0)
        add("▁" + syl, -9.0)
    for a in SYLLABLES:
        for b in SYLLABLES:
            add("▁" + a + b, -8.0)
    for a in SYLLABLES:
        for b in SYLLABLES:
            for c in SYLLABLES:
                add("▁" + a + b + c, -8.5)
    template = [{"SpecialToken": {"id": "[CLS]", "type_id": 0}}, {"Sequence": {"id": "A", "type_id": 0}},
                {"SpecialToken": {"id": "[SEP]", "type_id": 0}}]
    return {"version": "1.0", "truncation": None, "padding": None,
            "added_tokens": [_added(i, t) for i, t in enumerate(specials)],
            "normalizer": {"type": "Sequence", "normalizers": [
                {"type": "Replace", "pattern": {"String": "``"}, "content": '"'},
                {"type": "Replace", "pattern": {"String": "''"}, "content": '"'},
                {"type": "NFKD"}, {"type": "StripAccents"}, {"type": "Lowercase"}]},
            "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
                {"type": "WhitespaceSplit"},
                {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always", "split": True}]},
            "post_processor": {"type": "TemplateProcessing", "single": template,
                               "pair": template + [{"Sequence": {"id": "B", "type_id": 1}},
                                                   {"SpecialToken": {"id": "[SEP]", "type_id": 1}}],
                               "special_tokens": {t: {"id": t, "ids": [i], "tokens": [t]}
                                                  for t, i in (("[CLS]", 2), ("[SEP]", 3))}},
            "decoder": {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always", "split": True},
            "model": {"type": "Unigram", "unk_id": 1, "vocab": pieces, "byte_fallback": False}}


def hf_state_dict(cfg: dict, seed: int) -> dict:
    """Seeded weights (normal, std 0.02; LayerNorms near 1) under the key
    names of HF's BertModel, RobertaModel, AlbertModel (the factorized
    embedding and the one shared layer) or DistilBertModel (its own layer
    names, no token-type table)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    distil = cfg["model_type"] == "distilbert"
    h, f = (cfg["dim"], cfg["hidden_dim"]) if distil else (cfg["hidden_size"], cfg["intermediate_size"])
    e = cfg.get("embedding_size", h)

    def w(*shape):
        return torch.randn(shape, generator=g) * 0.02

    def norm(prefix, n):
        return {prefix + ".weight": 1.0 + w(n), prefix + ".bias": w(n)}

    def linear(name, n_out, n_in):
        return {name + ".weight": w(n_out, n_in), name + ".bias": w(n_out)}

    sd = {"embeddings.word_embeddings.weight": w(cfg["vocab_size"], e),
          "embeddings.position_embeddings.weight": w(cfg["max_position_embeddings"], e),
          **norm("embeddings.LayerNorm", e)}
    if distil:
        for i in range(cfg["n_layers"]):
            at = f"transformer.layer.{i}."
            for name in ("q_lin", "k_lin", "v_lin", "out_lin"):
                sd.update(linear(at + "attention." + name, h, h))
            sd.update({**norm(at + "sa_layer_norm", h), **linear(at + "ffn.lin1", f, h),
                       **linear(at + "ffn.lin2", h, f), **norm(at + "output_layer_norm", h)})
        return sd
    sd["embeddings.token_type_embeddings.weight"] = w(cfg["type_vocab_size"], e)
    if cfg["model_type"] == "albert":
        sd.update(linear("encoder.embedding_hidden_mapping_in", h, e))
        at = "encoder.albert_layer_groups.0.albert_layers.0."
        for name in ("query", "key", "value", "dense"):
            sd.update(linear(at + "attention." + name, h, h))
        sd.update({**norm(at + "attention.LayerNorm", h), **linear(at + "ffn", f, h),
                   **linear(at + "ffn_output", h, f), **norm(at + "full_layer_layer_norm", h)})
        return sd
    for i in range(cfg["num_hidden_layers"]):
        at = f"encoder.layer.{i}."
        for name in ("query", "key", "value"):
            sd.update(linear(at + "attention.self." + name, h, h))
        sd.update({**linear(at + "attention.output.dense", h, h), **norm(at + "attention.output.LayerNorm", h),
                   **linear(at + "intermediate.dense", f, h), **linear(at + "output.dense", h, f),
                   **norm(at + "output.LayerNorm", h)})
    return sd


def write_checkpoint(path: str, cfg: dict, tokenizer, max_seq_length: int, seed: int, pooling: str = "mean",
                     normalize: bool = True, dense: int = 0, lower: bool = True) -> None:
    """A sentence-transformers checkpoint directory: config.json, seeded
    weights in pytorch_model.bin, ``pooling`` ("mean" or "cls"), an
    optional 2_Dense (hidden -> ``dense``, tanh), an optional Normalize,
    sentence_bert_config.json, and the tokenizer: a tokenizer.json (a dict)
    or a WordPiece vocab.txt (a list of tokens) with a
    tokenizer_config.json giving ``lower`` as do_lower_case."""
    import torch

    hidden = cfg.get("hidden_size", cfg.get("dim"))
    modules = [{"idx": 0, "name": "0", "path": "", "type": "sentence_transformers.models.Transformer"},
               {"idx": 1, "name": "1", "path": "1_Pooling", "type": "sentence_transformers.models.Pooling"}]
    files = {
        "config.json": cfg,
        "1_Pooling/config.json": {"word_embedding_dimension": hidden, "pooling_mode_cls_token": pooling == "cls",
                                  "pooling_mode_mean_tokens": pooling == "mean", "pooling_mode_max_tokens": False},
        "sentence_bert_config.json": {"max_seq_length": max_seq_length, "do_lower_case": False},
    }
    if dense:
        modules.append({"idx": 2, "name": "2", "path": "2_Dense", "type": "sentence_transformers.models.Dense"})
        files["2_Dense/config.json"] = {"in_features": hidden, "out_features": dense, "bias": True,
                                        "activation_function": "torch.nn.modules.activation.Tanh"}
    if normalize:
        n = len(modules)
        modules.append({"idx": n, "name": str(n), "path": f"{n}_Normalize",
                        "type": "sentence_transformers.models.Normalize"})
    files["modules.json"] = modules
    if isinstance(tokenizer, dict):
        files["tokenizer.json"] = tokenizer
    else:
        files["tokenizer_config.json"] = {"do_lower_case": lower, "tokenize_chinese_chars": True,
                                          "strip_accents": None, "pad_token": "[PAD]",
                                          "model_max_length": max_seq_length}
    for name, body in files.items():
        os.makedirs(os.path.dirname(os.path.join(path, name)), exist_ok=True)
        with open(os.path.join(path, name), "w", encoding="utf-8") as fh:
            json.dump(body, fh, ensure_ascii=False)
    if not isinstance(tokenizer, dict):
        with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as fh:
            fh.write("\n".join(tokenizer) + "\n")
    torch.save(hf_state_dict(cfg, seed), os.path.join(path, "pytorch_model.bin"))
    if dense:
        g = torch.Generator().manual_seed(seed + 1)
        torch.save({"linear.weight": torch.randn((dense, hidden), generator=g) / hidden ** 0.5,
                    "linear.bias": torch.randn((dense,), generator=g) * 0.02},
                   os.path.join(path, "2_Dense", "pytorch_model.bin"))


def family_docs(rng, tokenizer: dict, n_docs: int = FAMILY_DOCS, n_long: int = FAMILY_LONG) -> list[str]:
    """``n_docs`` texts of the words the tokenizer holds whole (one token
    each, mostly): the first ``n_long`` of 440 to 1,100 words, the rest 12
    to 120, a few with punctuation and capitals.  ``tokenizer`` is a
    tokenizer.json dict or a WordPiece vocabulary; where the vocabulary
    holds CJK ideographs, every tenth word is a run of 2 to 4 of them."""
    cjk = []
    if isinstance(tokenizer, list):
        words = [t for t in tokenizer if len(t) > 3 and not t.startswith(("##", "["))]
        cjk = [t for t in tokenizer if len(t) == 1 and "\u4e00" <= t <= "\u9fff"]
    elif tokenizer["model"]["type"] == "BPE":
        sp = "Ġ"
        words = [t[1:] for t in tokenizer["model"]["vocab"] if t.startswith(sp) and len(t) > 3]
    else:
        words = [p[1:] for p, _ in tokenizer["model"]["vocab"] if p.startswith("▁") and len(p) > 3]
    docs = []
    for i in range(n_docs):
        n = int(rng.integers(440, 1100)) if i < n_long else int(rng.integers(12, 121))
        picks = [words[j] for j in rng.integers(0, len(words), n)]
        if cjk:
            for j in range(0, n, 10):
                picks[j] = "".join(cjk[c] for c in rng.integers(0, len(cjk), int(rng.integers(2, 5))))
        if i % 4 == 1:
            picks[0] = picks[0].capitalize()
            picks[-1] += "."
        docs.append(" ".join(picks))
    return docs


def row_norm_max(searcher) -> float:
    """The largest row norm in the searcher's host mirror."""
    m = searcher.matrix
    step = 262_144
    return max(float(np.linalg.norm(m.host_vectors_for(slice(lo, min(m.rows, lo + step))), axis=1).max())
               for lo in range(0, m.rows, step))


def score_scale(searcher, qvs):
    """Per query, |q| times the largest row norm in the searcher's host
    mirror: a dot product's rounding error scales with its operands' norms,
    so every score tolerance below is a unit tolerance times this (1 for
    unit queries over unit rows)."""
    return qvs[:, : searcher.matrix.dim].norm(dim=1).cpu().numpy() * row_norm_max(searcher)


def family_phase(card: str, workdir: str, dev, ctx: dict, installed: dict) -> dict:
    """The registry families the main slices do not run, through the normal
    entry points: the tokenizer.json ones (byte-level BPE, Unigram) and the
    DistilBERT ones (WordPiece vocab.txt, CLS pooling, a Dense head, a
    cased vocabulary).  Each checkpoint is written under
    PERCEIVE_TPU_MODEL_DATA, ``model set`` on a fresh database, a fresh
    AppState must load it (PERCEIVE_TPU_REQUIRE_CHECKPOINT=1) and scans 256
    documents (``scan_and_check``: K11 at DH 64 where the 512 bucket is
    reached, none where max_seq_length is 128); ``installed`` holds each
    checkpoint's write seconds (``install_checkpoints`` into
    ``workdir``/model_data, in a worker process); then 65,536 filler rows at
    the model's width, their norms drawn from the scanned windows', and an
    AppState over them all (that model) answers 16 CLI queries (K1 over
    the matrix) whose hits must equal the plain scan's over the same
    device matrix (``hold_to_plain``) and an exact f32 top-10 over the
    host mirror."""
    import shutil

    import torch

    from perceive_tpu_torch.cli import AppState
    from perceive_tpu_torch.cli import main as cli_main
    from perceive_tpu_torch.db import add_source
    from perceive_tpu_torch.models import ModelType
    from perceive_tpu_torch.ops import attention as attn
    from perceive_tpu_torch.ops import topk
    from perceive_tpu_torch.types import Source

    t_phase = time.perf_counter()
    models_dir = os.path.join(workdir, "model_data")
    os.environ["PERCEIVE_TPU_MODEL_DATA"] = models_dir
    os.environ["PERCEIVE_TPU_REQUIRE_CHECKPOINT"] = "1"
    out = {"attention": 0, "scan_topk": 0}
    try:
        for seed, (name, fam) in enumerate(FAMILIES.items(), start=20):
            t0 = time.perf_counter()
            mt = ModelType.parse(name)
            cfg = fam["config"]
            width = fam.get("dense") or cfg.get("hidden_size", cfg.get("dim"))
            spec, t_write = checkpoint_tokenizer(fam), installed[name]
            fdir = os.path.join(workdir, mt.checkpoint_dir_name)
            docs = family_docs(np.random.default_rng(seed), spec)
            write_docs(os.path.join(fdir, "docs"), docs)
            db_path = os.path.join(fdir, "family.sqlite3")

            # model set on the new database, then a fresh AppState that must
            # load the checkpoint, and the scan
            setter = AppState(db_path, model=ctx["model"], highlights_model=ctx["model"], device=dev,
                              build_searcher=False)
            with contextlib.redirect_stdout(io.StringIO()) as said:
                rc = cli_main(["--db", db_path, "model", "set", name], state=setter)
            if rc != 0:
                raise SystemExit(f"model set {name} exited {rc}")
            log(f"  cli: {said.getvalue().strip()}")
            src_fill = add_source(setter.db, Source(name="filler", config={"type": "fs"},
                                                   location="generated:filler"))
            setter.close()
            t1 = time.perf_counter()
            state = AppState(db_path, highlights_model=ctx["model"], device=dev)
            t_state = time.perf_counter() - t1
            model = state.model
            log(f"{name}: AppState loaded {model.name!r} ({model.dim}-d, {model.head.pooling} pooling, "
                f"dense {model.head.dense_dim or 'none'}, normalize {model.head.normalize}; tokenizer: the compiled "
                f"engine over a {type(model.tokenizer.tokenizer).__name__}, max_seq_length "
                f"{model.tokenizer.max_seq_length}) in {t_state:.1f} s (checkpoint written in {t_write:.1f} s)  "
                f"[{card}]")
            if model.name != name or model.model_id != mt.model_id or model.dim != width:
                raise SystemExit(f"AppState serves {model.name!r} ({model.dim}-d), not the {name} checkpoint")
            reset_launch_counts()
            ing = scan_and_check(card, state, db_path, os.path.join(fdir, "docs"), docs, tag=name,
                                 attention=fam["max_seq_length"] >= attn.KERNEL_MIN_SEQ)
            out["attention"] += ing["launches"]
            state.close()

            # the filler at the model's width and its windows' norms, then an
            # AppState over all the rows
            t1 = time.perf_counter()
            norms = np.linalg.norm(ing["embs"], axis=1)
            filler_text = " ".join(docs[-1].split()[:16])
            write_filler(db_path, src_fill.id, ing["next_id"], ing["next_seq"], FAMILY_FILLER,
                         torch.Generator(device=dev).manual_seed(seed), filler_text, mt.model_id, 0, dim=width,
                         norms=norms)
            t_fill = time.perf_counter() - t1
            state = AppState(db_path, model=model, highlights_model=ctx["model"], device=dev)
            m = state.searcher.matrix
            log(f"{name}: {FAMILY_FILLER} filler rows (norms {norms.min():.4g} to {norms.max():.4g}, median "
                f"{np.median(norms):.4g}: the windows') written in {t_fill:.1f} s; AppState over {len(m)} rows, "
                f"tier {m.tier_name}")
            if len(m) != FAMILY_FILLER + ing["windows"] or m.dtype != torch.bfloat16 or m.dim != width:
                raise SystemExit(f"{name}: the searcher holds {len(m)} {m.tier_name} rows of {m.dim}; "
                                 f"want {FAMILY_FILLER + ing['windows']} bf16 rows of {width}")

            doc_ids = ing["doc_ids"]
            self_docs = [FAMILY_LONG + i * ((FAMILY_DOCS - FAMILY_LONG) // N_SELF_QUERIES)
                         for i in range(N_SELF_QUERIES)]
            rng = np.random.default_rng(seed + 100)
            words = " ".join(docs[FAMILY_LONG:]).split()
            queries = [docs[d] for d in self_docs] + [
                " ".join(words[j] for j in rng.integers(0, len(words), int(rng.integers(3, 9))))
                for _ in range(16 - N_SELF_QUERIES)]
            fctx = {"db_path": db_path, "docs": docs, "queries": queries, "self_docs": self_docs,
                    "doc_ids": doc_ids, "filler_text": filler_text, "first_fill_id": ing["next_id"],
                    "tok": model.tokenizer, "model": model}
            topk.reset_launch_counts()
            # a stored window's own text ranks it first by cosine; by dot
            # product (no Normalize) a longer row may outscore it: reported
            results, p50, p95 = cli_queries(card, state, fctx, name, "scan_topk", gate_self=model.head.normalize)
            out["scan_topk"] += topk.launch_counts()["scan_topk"]
            qvs = torch.cat([query_vector(fctx, q, dev) for q in queries])
            scale = score_scale(state.searcher, qvs)
            hold_to_plain(state.searcher, qvs, results, name, scale)
            # and against an exact f32 top-10 over the host mirror: a bf16
            # row's score lies within BF16_SCORE_TOL * |q| |r| of its f32
            # row's, and two hits (the 10th and 11th too) may trade places
            # within twice that
            exact = exact_top10(state.searcher, qvs, dev, k=11)
            worst, same = 0.0, 0
            for qi, want in enumerate(exact):
                got = [(r["id"], r["score"]) for r in results[qi]]
                if not hits_match(got + [want[10]], want, BF16_SCORE_TOL * scale[qi]):
                    raise SystemExit(f"{name} query {qi}: hits differ from the exact f32 top-10:\n{got}\n{want}")
                worst = max(worst, max(abs(a[1] - b[1]) / scale[qi] for a, b in zip(got, want)))
                same += len({i for i, _ in got} & {i for i, _ in want[:10]})
            log(f"{name}: hits within the exact f32 top-10 for 16/16 queries (recall@10 {same / (10 * len(exact)):.4f}, "
                f"max score error {worst:.3g} of |q| |r|max, tol {BF16_SCORE_TOL}; |q| |r|max "
                f"{scale.min():.4g} to {scale.max():.4g}); smoke readings over {len(docs)} documents "
                f"and {len(m)} rows: docs/s {len(docs) / ing['scan_s']:.1f} end to end "
                f"({ing['summary'][0] if ing['summary'] else 'no summary'}); query p50 {p50:.2f} ms p95 {p95:.2f} ms; "
                f"launches: attention {ing['launches']} in the scan, scan_topk "
                f"{topk.launch_counts()['scan_topk']} in the queries  [{card}]")
            out[name] = {"docs_s": len(docs) / ing["scan_s"], "p50": p50, "p95": p95, "tok_s": ing["tok_s"],
                         "scan_s": ing["scan_s"], "s": time.perf_counter() - t0}
            state.close()
            del state, model, fctx
            shutil.rmtree(os.path.join(models_dir, mt.checkpoint_dir_name))
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        os.environ.pop("PERCEIVE_TPU_REQUIRE_CHECKPOINT", None)
        os.environ.pop("PERCEIVE_TPU_MODEL_DATA", None)
    took = time.perf_counter() - t_phase
    each = ", ".join(f"{n} {out[n]['s']:.1f} s" for n in FAMILIES)
    log(f"registry families: {took:.1f} s of the phase's {FAMILY_PHASE_S} s budget ({each})  [{card}]")
    if out["attention"] == 0 or out["scan_topk"] == 0:
        raise SystemExit(f"the families' main path launched attention {out['attention']}, "
                         f"scan_topk {out['scan_topk']} times")
    if took > FAMILY_PHASE_S:
        raise SystemExit(f"the families' phase took {took:.1f} s, past its {FAMILY_PHASE_S} s budget")
    return out


# -- the default configuration: the models AppState loads when none is named --

DEFAULT_FILLER = 786_432  # with the 2,593 windows, 1.58M effective rows at 768-d: the int8 tier by auto
DEFAULT_PHASE_S = 150  # the phase's budget


@contextlib.contextmanager
def timed_loads():
    """Seconds of each ``cli.state.load_model`` call inside the block, by
    model name (AppState loads its two models on two threads)."""
    from perceive_tpu_torch.cli import state as cli_state

    loads, load = {}, cli_state.load_model

    def timed(model_type, device):
        t0 = time.perf_counter()
        model = load(model_type, device)
        loads[model_type.value] = time.perf_counter() - t0
        return model

    cli_state.load_model = timed
    try:
        yield loads
    finally:
        cli_state.load_model = load


def default_state(card: str, db_path: str, dev, tier: str):
    """AppState(db_path) with no model passed: it must load the default
    main model (MsMarcoBertBaseDotV5: id 7, 768-d, from its checkpoint) and,
    as a model of its own, the default highlight model (AllMiniLmL6V2: id
    0, 384-d)."""
    from perceive_tpu_torch.cli import AppState
    from perceive_tpu_torch.cli.state import DEFAULT_HIGHLIGHT_MODEL, DEFAULT_MODEL

    t0 = time.perf_counter()
    with timed_loads() as loads, build_route() as route:
        state = AppState(db_path, device=dev)
    main, hl = state.model, state.highlights_model
    m = state.searcher.matrix
    log(f"default AppState ({tier}): main {main.name!r} (id {main.model_id}, v{main.model_version}, {main.dim}-d, "
        f"{main.head.pooling} pooling, normalize {main.head.normalize}) loaded in "
        f"{loads.get(DEFAULT_MODEL.value, math.nan):.2f} s; highlight {hl.name!r} (id {hl.model_id}, {hl.dim}-d) in "
        f"{loads.get(DEFAULT_HIGHLIGHT_MODEL.value, math.nan):.2f} s; {len(m)} rows, tier {m.tier_name}, in "
        f"{time.perf_counter() - t0:.1f} s  [{card}]")
    if (main.name, main.model_id, main.dim, main.model_version) != (DEFAULT_MODEL.value, 7, 768, 0):
        raise SystemExit(f"AppState's default main model is {main.name!r} ({main.dim}-d), not MsMarcoBertBaseDotV5")
    if hl is main or (hl.name, hl.model_id, hl.dim, hl.model_version) != (DEFAULT_HIGHLIGHT_MODEL.value, 0, 384, 0):
        raise SystemExit(f"AppState's default highlight model is {hl.name!r} ({hl.dim}-d), not its own AllMiniLmL6V2")
    return state, route


def default_phase(card: str, workdir: str, dev, ctx: dict, installed: dict, background) -> dict:
    """The default configuration's first half: MsMarcoBertBaseDotV5 (12
    layers, 768 wide, mean pooling, no Normalize) and AllMiniLmL6V2 written
    under PERCEIVE_TPU_MODEL_DATA (``workdir``/model_data: ``installed``)
    at their published widths with seeded weights,
    PERCEIVE_TPU_REQUIRE_CHECKPOINT=1, and a database with no ``model
    set``:
      (a) AppState(db_path) loads both by its defaults (``default_state``);
      (b) ``source add fs`` + ``source scan`` of the smoke's 2,048 files
          (``scan_and_check``): K11 at head width 64 through 12 layers;
      (c) ``python3 -m perceive_tpu_torch.cli serve --port 0`` over a copy
          of the scanned database (bf16, D = 768): ready, one /search equal
          to the in-process CLI's, SIGTERM exit 0 (``default_serve``),
          while ``background`` (an executor of one thread) writes
          DEFAULT_FILLER rows with the scanned windows' norms into the
          database, for ``default_tiers``.
    Every score tolerance scales with the operands' norms (``score_scale``):
    these rows are not unit vectors.  Returns what ``default_tiers``
    needs."""
    import sqlite3

    import torch

    from perceive_tpu_torch.cli.state import DEFAULT_HIGHLIGHT_MODEL, DEFAULT_MODEL
    from perceive_tpu_torch.db import add_source
    from perceive_tpu_torch.types import Source

    t_phase = time.perf_counter()
    ddir = os.path.join(workdir, "default")
    # its checkpoints' folder, no random fallback, a data dir of its own
    env = {"PERCEIVE_TPU_MODEL_DATA": os.path.join(workdir, "model_data"), "PERCEIVE_TPU_REQUIRE_CHECKPOINT": "1",
           "PERCEIVE_TPU_DATA_DIR": os.path.join(ddir, "data")}
    os.environ.update(env)
    out = {}
    try:
        for model_type in (DEFAULT_MODEL, DEFAULT_HIGHLIGHT_MODEL):
            log(f"default configuration: {model_type.checkpoint_dir_name} written in "
                f"{installed[model_type.value]:.1f} s, beside the first kernel checks")
        docs, db_path = ctx["docs"], os.path.join(ddir, "default.sqlite3")
        write_docs(os.path.join(ddir, "docs"), docs)

        # (a) and (b)
        state, _ = default_state(card, db_path, dev, "empty")
        reset_launch_counts()
        ing = scan_and_check(card, state, db_path, os.path.join(ddir, "docs"), docs, tag="default ingest")
        layers = state.model.arch.num_layers
        log(f"default ingest: K11 launched {ing['launches']} times through {layers} layers "
            f"({ing['launches'] / layers:g} batches at a bucket of 384 or more)")
        if ing["launches"] == 0 or ing["launches"] % layers:
            raise SystemExit(f"the default ingest launched K11 {ing['launches']} times, not a multiple of {layers}")
        out["ingest_docs_s"], out["attention"] = len(docs) / ing["scan_s"], ing["launches"]
        norms = np.linalg.norm(ing["embs"], axis=1)
        log(f"default ingest: the stored rows' norms {norms.min():.4g} to {norms.max():.4g}, median "
            f"{np.median(norms):.4g} (mean pooling, no Normalize)")
        dctx = {"db_path": db_path, "docs": docs, "queries": ctx["queries"], "self_docs": ctx["self_docs"],
                "doc_ids": ing["doc_ids"], "filler_text": ctx["filler_text"], "first_fill_id": ing["next_id"],
                "tok": state.model.tokenizer, "model": state.model}

        # (c) the real entry point over the installed checkpoints, serving a
        # copy of the scanned database while the filler goes into this one
        q = ctx["queries"][N_SELF_QUERIES]
        want = cli_json(state, dctx, "search", q, "-n", "10")
        scale = float(score_scale(state.searcher, query_vector(dctx, q, dev))[0])
        serve_db = os.path.join(ddir, "serve.sqlite3")
        with contextlib.closing(sqlite3.connect(serve_db)) as copy:
            state.db.read().backup(copy)
        rows = len(state.searcher.matrix)
        src_fill = add_source(state.db, Source(name="filler", config={"type": "fs"}, location="generated:filler"))
        state.close()
        del state, dctx["model"], dctx["tok"]
        vectors = list(filler_vectors(torch.Generator(device=dev).manual_seed(32), DEFAULT_FILLER, 768, norms))
        filler = background.submit(filler_job, {**ctx, "fill_source": src_fill.id, "next_id": ing["next_id"],
                                                "next_seq": ing["next_seq"]},
                                   db_path, DEFAULT_FILLER, vectors, dim=768, mid=7)
        out["serve"] = default_serve(card, serve_db, q, want, scale, rows, env)
    finally:
        for key in env:
            os.environ.pop(key, None)
        gc.collect()
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"default configuration, first half: {out['seconds']:.1f} s  [{card}]")
    return {"out": out, "ctx": dctx, "filler": filler, "rows": DEFAULT_FILLER + ing["windows"], "norms": norms,
            "dir": ddir, "env": env}


def default_tiers(card: str, dev, half: dict) -> dict:
    """The default configuration's second half, once ``default_phase``'s
    filler rows are in (1.58M effective rows at 768-d):
      (d) an AppState by the defaults on the int8 tier (auto), 16 CLI
          queries (K3; highlight on the MiniLM model) equal to an exact f32
          top-10, a 2,048-query batch (K4) equal to search_vector's answers;
      (e) the same database pinned to int2 (PERCEIVE_TPU_MATRIX_DTYPE),
          built from (d)'s snapshot: 16 CLI queries per audit route (K5, K6,
          K7), the device pipeline equal to the plain one,
          served_recall_at_10 >= 0.99.
    Both halves' seconds, the filler's written beside other phases left
    out, stay within DEFAULT_PHASE_S."""
    import torch

    from perceive_tpu_torch.index.matrix import INT2

    t_phase = time.perf_counter()
    out, dctx, env, db_path = half["out"], half["ctx"], half["env"], half["ctx"]["db_path"]
    log(f"default configuration: {DEFAULT_FILLER} filler rows of 768-d (the windows' norms) written in "
        f"{half['filler'].result()['seconds']:.1f} s, beside the server and the kernel checks")
    os.environ.update(env)
    try:
        # (d) the int8 tier by auto over the windows and the filler
        state, _ = default_state(card, db_path, dev, "auto")
        m = state.searcher.matrix
        if len(m) != half["rows"] or m.dtype != torch.int8 or m.dim != 768:
            raise SystemExit(f"the default state holds {len(m)} {m.tier_name} rows of {m.dim}; "
                             f"want {half['rows']} int8 rows of 768")
        dctx.update(tok=state.model.tokenizer, model=state.model)
        out["int8"] = default_int8(card, state, dctx, dev, half["norms"])
        dctx["snap"] = os.path.join(half["dir"], "matrix.npz")
        cli_snapshot(card, state, dctx, dctx["snap"], "full")
        state.close()
        del state, dctx["model"], dctx["tok"]
        gc.collect()

        # (e) pinned to int2, streamed from (d)'s snapshot (another tier)
        os.environ["PERCEIVE_TPU_MATRIX_DTYPE"] = "int2"
        state, route = default_state(card, db_path, dev, "int2 pinned")
        check_route(route, "default int2", adopted=False, sqlite_rows=0)
        m = state.searcher.matrix
        if m.dtype != INT2 or m.dim != 768 or len(m) != half["rows"]:
            raise SystemExit(f"the pinned default state holds {len(m)} {m.tier_name} rows of {m.dim}")
        dctx.update(tok=state.model.tokenizer, model=state.model)
        out["int2"] = default_int2(card, state, dctx, dev)
        state.close()
        del state
    finally:
        for key in (*env, "PERCEIVE_TPU_MATRIX_DTYPE"):
            os.environ.pop(key, None)
        gc.collect()
        torch.cuda.empty_cache()
    out["seconds"] += time.perf_counter() - t_phase
    log(f"default configuration: {out['seconds']:.1f} s of the phase's {DEFAULT_PHASE_S} s budget (both halves; "
        f"the filler rows written beside other phases)  [{card}]")
    if out["seconds"] > DEFAULT_PHASE_S:
        raise SystemExit(f"the default configuration's phase took {out['seconds']:.1f} s, past its "
                         f"{DEFAULT_PHASE_S} s budget")
    return out


def default_serve(card: str, db_path: str, q: str, want: list, scale: float, rows: int, env: dict) -> dict:
    """(c): ``python3 -m perceive_tpu_torch.cli serve --port 0`` in a
    subprocess over ``db_path`` (a copy of the default database holding the
    scanned windows alone: ``rows`` of them, bf16, D = 768) with the
    installed checkpoints and no fallback: ready, /status over the same
    rows, one /search for ``q`` whose hits equal ``want``, the in-process
    CLI's (scores within 1e-4 of ``scale`` = |q| |r|max: the same kernels
    over the same rows), SIGTERM exit 0."""
    import signal

    root = os.path.dirname(os.path.abspath(__file__))
    cli = [sys.executable, "-m", "perceive_tpu_torch.cli", "--db", db_path, "serve", "--port", "0"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cli, cwd=root, env=dict(os.environ, PYTHONUNBUFFERED="1", **env),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines: list = []
    reader = threading.Thread(target=lambda: lines.extend(iter(proc.stdout.readline, "")), daemon=True)
    reader.start()
    try:
        wait_for(lambda: any(l.startswith("Serving on") for l in lines) or proc.poll() is not None, 120,
                 "the default server's address")
        url = next((l.split()[-1] for l in lines if l.startswith("Serving on")), None)
        if url is None:
            raise SystemExit(f"default serve: the subprocess server exited {proc.returncode}: {lines[-10:]}")
        port = int(url.rsplit(":", 1)[1])
        wait_for(lambda: http_request(port, "GET", "/status")[1]["model_loaded"] or proc.poll() is not None, 120,
                 "the default server's readiness")
        ready = time.perf_counter() - t0
        status = http_request(port, "GET", "/status")[1]
        code, got = http_request(port, "GET", search_path(q, k=10))
        t1 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(30)
        stop_s = time.perf_counter() - t1
        reader.join(10)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    for line in lines[-6:]:
        log(f"  default serve: {line.rstrip()}")
    log(f"default serve: `python3 -m perceive_tpu_torch.cli serve` ready in {ready:.1f} s over {status.get('rows')} "
        f"rows (tier {status.get('tier')}); /search answered {code} with {len(got) if code == 200 else got} hits; "
        f"SIGTERM exit code {rc} in {stop_s:.2f} s  [{card}]")
    if not status["model_loaded"] or status["rows"] != rows or status["tier"] != "bfloat16":
        raise SystemExit(f"default serve: /status {status}")
    if any("WARNING: no checkpoint" in line for line in lines):
        raise SystemExit("default serve: the server fell back to a random model")
    if code != 200 or not hits_match(served_hits(got), served_hits(want), 1e-4 * scale):
        raise SystemExit(f"default serve: /search answered {code}:\n{got}\nthe CLI:\n{want}")
    if rc != 0:
        raise SystemExit(f"default serve: the subprocess server exited {rc} on SIGTERM")
    return {"ready_s": ready, "sigterm_s": stop_s}


def default_int8(card: str, state, ctx: dict, dev, norms) -> dict:
    """(d): 16 CLI queries over the int8 tier (K3; highlight on the MiniLM
    model, never the main one) equal to an exact f32 top-10 over the host
    mirror (scores within 1e-5 of |q| |r|max: both are f32 dot products,
    summed in another order; ids may trade places within twice that, the
    11th beside the 10th), then
    a batch of N_BATCH queries (half near a stored window, half random, at
    the stored rows' norms) through search_vectors_batch (K4), each answer
    equal to search_vector's."""
    import torch

    searcher = state.searcher
    calls = {"main": 0, "highlight": 0}

    def counted(model, key):
        run = model.highlight

        def highlight(*args, **kwargs):
            calls[key] += 1
            return run(*args, **kwargs)
        return highlight

    state.model.highlight = counted(state.model, "main")
    state.highlights_model.highlight = counted(state.highlights_model, "highlight")
    reset_launch_counts()
    esc0 = searcher.escalations
    try:
        results, p50, p95 = cli_queries(card, state, ctx, "default int8", "scan_int8", gate_self=False)
    finally:
        del state.model.highlight, state.highlights_model.highlight
    launches = launch_counts()["scan_int8"]
    escalations = searcher.escalations - esc0
    if calls["highlight"] != 18 or calls["main"]:
        raise SystemExit(f"default int8: highlight ran {calls['highlight']} times on the MiniLM model and "
                         f"{calls['main']} on the main model; want 18 and 0")
    qvs = torch.cat([query_vector(ctx, q, dev) for q in ctx["queries"]])
    rmax = row_norm_max(searcher)
    scale = qvs.norm(dim=1).cpu().numpy() * rmax
    exact = exact_top10(searcher, qvs, dev, k=11)
    for qi, want in enumerate(exact):
        got = [(r["id"], r["score"]) for r in results[qi]]
        if not hits_match(got + want[10:], want, 1e-5 * scale[qi]):
            raise SystemExit(f"default int8 query {qi}: hits differ from the exact f32 top-10:\n{got}\n{want}")
    log(f"default int8: hits equal the exact f32 top-10 for 16/16 queries (|q| |r|max {scale.min():.4g} to "
        f"{scale.max():.4g}); highlight on {state.highlights_model.name} 18 times, on the main model 0; "
        f"escalations {escalations}; scan_int8 launches {launches}")

    # the batch path
    rng = np.random.default_rng(33)
    half = N_BATCH // 2
    stored = searcher.matrix.host_vectors_for(rng.integers(0, searcher.matrix.rows, half))
    near = stored + 0.02 * np.linalg.norm(stored, axis=1, keepdims=True) * rng.standard_normal(
        stored.shape).astype(np.float32) / np.sqrt(stored.shape[1])
    far = rng.standard_normal((N_BATCH - half, 768)).astype(np.float32)
    far *= (rng.choice(norms, N_BATCH - half) / np.linalg.norm(far, axis=1))[:, None]
    vecs = np.concatenate([near, far]).astype(np.float32)[rng.permutation(N_BATCH)]
    reset_launch_counts()
    esc0 = searcher.escalations
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = searcher.search_vectors_batch(vecs, 10)
    batch_s = time.perf_counter() - t0
    k4 = launch_counts()["scan_int8_slab"]
    esc = searcher.escalations - esc0
    bscale = np.linalg.norm(vecs, axis=1) * rmax
    bad = sum(not hits_match(batch[i], searcher.search_vector(vecs[i], 10), 1e-5 * bscale[i]) for i in range(N_BATCH))
    log(f"default int8 search_vectors_batch, {N_BATCH} queries (half near a stored window): {batch_s * 1e3:.2f} ms "
        f"(one cold run) = {N_BATCH / batch_s:.1f} QPS; {esc} escalations; scan_int8_slab launches {k4}; answers "
        f"equal search_vector's {N_BATCH - bad}/{N_BATCH}  [{card}]")
    if k4 == 0 or bad:
        raise SystemExit(f"default int8 batch: {k4} K4 launches, {bad} answers differ from search_vector's")
    return {"launches": launches, "p50": p50, "p95": p95, "escalations": escalations, "batch_ms": batch_s * 1e3,
            "batch_escalations": esc, "scan_int8_slab": k4}


def default_int2(card: str, state, ctx: dict, dev) -> dict:
    """(e): the self-audit's verdict, 16 CLI queries on each of
    ``audit_routes`` (K5, K6 and K7 where the coarse pass serves), the
    composed device pipeline against the plain one per query and
    served_recall_at_10 >= 0.99 against an exact f32 top-10 (scores within
    1e-5 of |q| |r|max)."""
    import torch

    searcher = state.searcher
    log(f"default int2 coarse self-audit: {json.dumps(searcher.coarse_audit)}")
    qvs = torch.cat([query_vector(ctx, q, dev) for q in ctx["queries"]])
    scale = score_scale(searcher, qvs)
    exact = exact_top10(searcher, qvs, dev)
    out = {"audit": dict(searcher.coarse_audit)}
    for route, coarse in audit_routes(searcher):
        tier = f"default int2 ({route}, coarse pass {'serving' if coarse else 'demoted'})"
        reset_launch_counts()
        esc0 = searcher.escalations
        results, p50, p95 = cli_queries(card, state, ctx, tier, "int2_scores" if coarse else "scan_int8t",
                                        gate_self=False)
        counts = launch_counts()
        launches = {name: counts[name] for name in ("int2_scores", "select_topk", "scan_int8t")}
        escalations = searcher.escalations - esc0
        log(f"{tier} CLI path: escalations {escalations}; launches {launches}")
        for name in ("int2_scores", "select_topk", "scan_int8t") if coarse else ("scan_int8t",):
            if launches[name] == 0:
                raise SystemExit(f"the {tier} CLI path launched no {name} kernel (audit {searcher.coarse_audit})")
        recall = served_recall(tier, results, exact, scale=scale)
        out[route] = {"launches": launches, "p50": p50, "p95": p95, "escalations": escalations, "recall": recall}
    out["pipeline_ms"] = check_int2_pipeline(card, searcher, ctx, dev, "default int2")
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.")
    ap.add_argument("--audit-case", default="", help="write the int2+int4 self-audit's worst sample here (.npz)")
    ap.add_argument("--ladder", action="store_true",
                    help="only build the kernels and time the flat scans by depth and by width, and K5 (ladders)")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)  # host_job's process
    ap.add_argument("--only", choices=("widths", "families", "default"), action="append",
                    help="only build and run these phases (repeatable): the kernels at the registry's other "
                         "widths, the registry families, the default configuration; prints no result")
    args = ap.parse_args(argv)
    if args.worker:
        return worker()
    card = environment()
    import torch

    if args.ladder:
        build_kernels(card)
        ladders(card)
        return 0
    if args.only:
        dev = torch.device("cuda:0")
        with phase("build"):
            build_tokenizer(card)
            build_kernels(card)
            build_walker(card)
        ctx = smoke_texts(dev)
        with tempfile.TemporaryDirectory() as workdir:
            installed = {}
            if {"families", "default"} & set(args.only):
                with phase("checkpoints"):
                    installed = host_job("checkpoints", {"models_dir": os.path.join(workdir, "model_data")})
            with concurrent.futures.ThreadPoolExecutor(1) as background:
                for name, run in (("widths", lambda: check_wide_kernels(card)),
                                  ("families", lambda: family_phase(card, workdir, dev, ctx, installed)),
                                  ("default", lambda: default_tiers(card, dev, default_phase(
                                      card, workdir, dev, ctx, installed, background)))):
                    if name in args.only:
                        with phase(name):
                            run()
        return 0

    t_start = time.perf_counter()
    dev = torch.device("cuda:0")
    with tempfile.TemporaryDirectory() as workdir, concurrent.futures.ThreadPoolExecutor(1) as background:
        with phase("build"):
            # g++ builds the tokenizer while nvcc builds the kernels
            with concurrent.futures.ThreadPoolExecutor(1) as pool:
                tokenizer_built = pool.submit(build_tokenizer, card)
                build_kernels(card)
                build_walker(card)
                tokenizer_built.result()

        # every main path runs with the launch counts set to 0 just before it
        # and read just after it; the kernel checks' comparisons do not count
        launches = {}
        with phase("bf16 slice: ingest through source add fs + source scan"):
            reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            ctx = build_corpus(card, workdir, dev)
            launches["attention"] = ctx["attention_launches"]
        # the kernel checks keep the card busy and the host all but idle:
        # worker processes meanwhile write the families' and the default
        # configuration's checkpoints (seeded weights, ~1.4 GB) and the bf16
        # slice's filler rows, then (below) the default configuration's and
        # the int8 and int2 slices', each into a database nothing else holds
        # open then
        installed = background.submit(host_job, "checkpoints", {"models_dir": os.path.join(workdir, "model_data")})
        filled = background.submit(fill_corpus, ctx)
        with phase("K1, K2 against their plain version"):
            bf16 = check_bf16_scans(card)
        with phase("K3, K4 against their plain version"):
            int8 = check_int8_scans(card)
        with phase("K11 against its plain version"):
            k11 = check_k11(card)
        with phase("bf16 slice: 1M rows, 16 CLI queries"):
            log(f"sqlite corpus: {len(ctx['stored'])} document rows + filler rows = {TOTAL_ROWS} rows (filler "
                f"written in {filled.result():.1f} s, beside the kernel checks)")
            reset_launch_counts()
            state, bf16_sl = bf16_slice(card, ctx, dev)
            launches["scan_topk"] = bf16_sl["launches"]
        with phase("bf16 batch path"):
            bf16_batch = batch_path(card, state, ctx, "bf16", "scan_slab")
            launches["scan_slab"] = bf16_batch["launches"]["scan_slab"]
        with phase("serve: the HTTP server over the bf16 state, refresh, CLI, doctor, the real entry point"):
            serve_phase(card, state, ctx, bf16_sl["results"], workdir)
        with phase("bf16 snapshot: a v2 base of the 1M rows through the CLI"):
            ctx["snap"] = os.path.join(workdir, "matrix.npz")
            cli_snapshot(card, state, ctx, ctx["snap"], "full")
            check_manifest(state, ctx)
        mesh_s = {}
        with phase(f"mesh bf16: the base adopted over {MESH_SLOTS} slots, 16 fused queries, a 2,048-query batch"):
            mesh_s["bf16"] = mesh_bf16(card, state, ctx, dev)
        with phase("mesh encode: dryrun_multichip(4), the windows through shard_over at model-parallel 1 and 2"):
            mesh_s["encode"] = mesh_encode(card, ctx, dev)
        state.close()
        del state
        torch.cuda.empty_cache()
        with phase("default configuration, first half: MsMarcoBertBaseDotV5 + AllMiniLmL6V2 by AppState's "
                   "defaults, the scan, the subprocess server"):
            half = default_phase(card, workdir, dev, ctx, installed.result(), background)
        filler = background.submit(slice_filler, ctx, [list(filler_vectors(ctx["gen"], n)) for n in SLICE_FILLER])
        with phase("K5, K6, K7, K8, K10 against their plain version"):
            int2k = check_int2_kernels(card)
        with phase(f"K10 against its plain version at {INT2_TOP_ROWS:,} x {DIM}"):
            check_tiletop_top(card, dev)
        with phase("K9 (flat, slab) against its plain version at 25,165,824 x 384, slab at 34,603,008"):
            int4k = check_int4_kernels(card)
        with phase(f"K1-K10 at the registry's other widths: D = {WIDE_DIM} at the int8, int2 and int4 tiers' rows, "
                   f"D = {DENSE_DIM} bf16"):
            check_wide_kernels(card)
        t0 = time.perf_counter()
        ctx["slice_filler"] = filler.result()
        log(f"waited {time.perf_counter() - t0:.1f} s for the slices' filler rows")
        with phase("registry families at full width: distilroberta (BPE), albert (Unigram), tas-b (CLS), "
                   "distiluse (Dense, cased)"):
            families = family_phase(card, workdir, dev, ctx, installed.result())
        with phase("default configuration, second half: the int8 tier by auto, the int2 tier pinned"):
            default = default_tiers(card, dev, half)
        with phase("int8 slice: 2M rows, built from the bf16 base and 1M rows replayed, 16 CLI queries"):
            state, int8_sl = int8_slice(card, ctx, dev)
            launches["scan_int8"] = int8_sl["launches"]
        with phase("int8 batch path"):
            int8_batch = batch_path(card, state, ctx, "int8", "scan_int8_slab")
            launches["scan_int8_slab"] = int8_batch["launches"]["scan_int8_slab"]
        state.close()
        del state  # release the int8 tier's mirror and device matrix
        gc.collect()
        torch.cuda.empty_cache()
        with phase("int2 slice: 4.19M rows, a cold build, 16 CLI queries"):
            state, int2_sl = int2_slice(card, ctx, dev)
            launches.update(int2_sl["launches"])
        with phase("int2 batch path"):
            # one cold batch of each mix: the host rerank bounds them (PERF.md)
            int2_batch = batch_path(card, state, ctx, "int2", "scan_int8t_slab", "scan_int8t", reps=1)
            launches["scan_int8t_slab"] = int2_batch["launches"]["scan_int8t_slab"]
        with phase("int2 pinned selects: tiletop, window, threshold, 16 CLI queries each"):
            selects = int2_selects(card, state, ctx, dev)
            launches["int2_tiletop"] = selects["tiletop"]["launches"]["int2_tiletop"]
        with phase("int2 adopt: snapshot, a fresh AppState adopting it, 16 CLI queries per route"):
            adopted = int2_adopt(card, state, ctx, dev)  # kept for the delta phase, which changes it
        with phase(f"mesh int2: the int2 base adopted over {MESH_SLOTS} slots, audited, 16 fused queries a route"):
            mesh_s["int2"] = mesh_int2(card, adopted, ctx, dev)
        log(f"mesh steps: {sum(mesh_s.values()):.1f} s in all ({', '.join(f'{k} {v:.1f} s' for k, v in mesh_s.items())}"
            f"; budget {MESH_BUDGET_S} s)  [{card}]")
        del state
        gc.collect()
        torch.cuda.empty_cache()
        with phase("int4 slice: the 4.19M-row corpus pinned to int4, streamed from the int2 base, 16 CLI queries"):
            state, int4_sl = int4_slice(card, ctx, dev)
            launches["scan_int4"] = int4_sl["launches"]
        with phase("int4 batch path"):
            int4_batch = batch_path(card, state, ctx, "int4", "scan_int4_slab", "scan_int4", reps=1, verify_every=4)
            launches["scan_int4_slab"] = int4_batch["launches"]["scan_int4_slab"]
        with phase("int2 with the int4 companion: retier, self-audit, 16 CLI queries, a batch of each mix"):
            int2_int4_slice(card, state, ctx, dev, args.audit_case)
        state.close()
        del state
        gc.collect()
        torch.cuda.empty_cache()
        with phase("delta: the adopted int2 state changed through the hooks, a delta, a build from it"):
            delta_gate(card, adopted, ctx, dev)
        del adopted
    note_peak()
    log(f"max_memory_allocated {PEAK_BYTES[0] / 2**30:.3f} GiB  [{card}]")
    log(f"kernel launches on the main paths: {launches}; the registry families' scans and queries: "
        f"attention {families['attention']}, scan_topk {families['scan_topk']}; the default configuration: "
        f"attention {default['attention']} in its scan, scan_int8 {default['int8']['launches']}, scan_int8_slab "
        f"{default['int8']['scan_int8_slab']}, int2 by route "
        f"{ {r: default['int2'][r]['launches'] for r in ('audited', 'audit off') if r in default['int2']} }")
    for name, n in launches.items():
        if n == 0:
            raise SystemExit(f"the main path launched no {name} kernel")

    measured = {"scan_topk": bf16["K1"], "scan_slab": bf16["K2"], "scan_int8": int8["K3"],
                "scan_int8_slab": int8["K4"], "attention": k11, "int2_scores": int2k["K5"],
                "select_topk": int2k["K6"], "scan_int8t": int2k["K7"], "scan_int8t_slab": int2k["K8"],
                "scan_int4": int4k["flat"], "scan_int4_slab": int4k["slab"], "int2_tiletop": int2k["K10"]}
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
