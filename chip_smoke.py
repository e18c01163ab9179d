"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):
  1. environment: CUDA present, card name and power limit, versions;
  2. build the CUDA kernels from perceive_tpu_torch/csrc;
  3. K1 (scan + top-k) against its plain version at 1M x 384 bf16;
  4. K11 (attention) against its plain version at the encoder's long buckets;
  5. the slice: an all-MiniLM-L6-v2-width model with seeded random weights
     embeds a generated corpus into SQLite (filled to 1M rows), AppState
     builds the searcher on the card, and 16 queries run through the CLI.
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
import time

import numpy as np

K1_SOURCE = "perceive_tpu_torch/csrc/scan_topk.cu"
K1_REPLACES = "perceive_tpu/ops/topk.py:966"
K11_SOURCE = "perceive_tpu_torch/csrc/attention.cu"
K11_REPLACES = "perceive_tpu/ops/attention.py:58"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, timed with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# -- phase 1-2 -------------------------------------------------------------


def environment():
    import torch

    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is False")
        sys.exit(1)
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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


# -- phase 3: K1 -------------------------------------------------------------


def compare_topk(vk, rk, vp, rp, tol: float):
    """(max abs score error, rows outside the tie band) between a kernel and
    a plain top-k; rows may differ only where the score lies within ``tol``
    of the k-th score."""
    vk, rk, vp, rp = (t.cpu().numpy() for t in (vk, rk, vp, rp))
    fin_k, fin_p = np.isfinite(vk), np.isfinite(vp)
    if not np.array_equal(fin_k, fin_p):
        return math.inf, -1
    err = float(np.max(np.abs(np.where(fin_p, vk - vp, 0.0)), initial=0.0))
    bad = 0
    for qi in range(vk.shape[0]):
        n = int(fin_p[qi].sum())
        if n == 0:
            continue
        kth = vp[qi, n - 1]
        sk, sp = set(rk[qi, :n].tolist()), set(rp[qi, :n].tolist())
        score_k = dict(zip(rk[qi, :n].tolist(), vk[qi, :n].tolist()))
        score_p = dict(zip(rp[qi, :n].tolist(), vp[qi, :n].tolist()))
        for r in sk - sp:
            bad += abs(score_k[r] - kth) > tol
        for r in sp - sk:
            bad += abs(score_p[r] - kth) > tol
        if not np.all(rk[qi, n:] == -1):
            bad += 1
    return err, bad


def check_k1(card: str) -> dict:
    import torch

    from perceive_tpu_torch.index.matrix import sweep_rows_for
    from perceive_tpu_torch.ops import topk

    dev = torch.device("cuda:0")
    n, d, hwm = 1_048_576, 384, 950_000
    g = torch.Generator(device=dev).manual_seed(1)
    m = torch.empty((n, d), dtype=torch.bfloat16, device=dev)
    for lo in range(0, n, 131072):
        blk = torch.randn((131072, d), generator=g, device=dev)
        m[lo : lo + 131072] = (blk / blk.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    src = torch.randint(0, 3, (n,), generator=g, device=dev, dtype=torch.int32)
    src[torch.rand((n,), generator=g, device=dev) < 0.05] = -1  # tombstones
    src[hwm:] = -1  # unallocated tail
    ns = sweep_rows_for(hwm, n)
    assert ns < n
    no_filter = torch.full((16,), -9, dtype=torch.int32, device=dev)
    no_filter[0] = topk.ALLOW_ALL
    two = torch.full((16,), -9, dtype=torch.int32, device=dev)
    two[0], two[1] = 0, 2
    worst = 0.0
    for nq in (1, 8, 64, 512):
        q = torch.randn((nq, d), generator=g, device=dev)
        q = q / q.norm(dim=1, keepdim=True)
        for k in (16, 32, 1024, 8192):  # 32: the slice's kb (n=10, doubled for chunk dedupe)
            for name, allowed in (("all", no_filter), ("2src", two)):
                vk, rk = topk.scan_topk(m, src, q, allowed, k, ns)
                vp, rp = topk.scan_topk_plain(m, src, q, allowed, k, ns)
                torch.cuda.synchronize()
                err, bad = compare_topk(vk, rk, vp, rp, 1e-4)
                status = "ok" if err <= 1e-4 and bad == 0 else "FAIL"
                log(f"K1 Q={nq:<4d} k={k:<5d} filter={name:<4s} max_abs_err={err:.3g} "
                    f"rows_outside_ties={bad} {status}")
                if status != "ok":
                    raise SystemExit(f"K1 disagrees with its plain version (Q={nq} k={k} {name})")
                worst = max(worst, err)

    # tie rule: duplicate rows must come out lower row first.  Small integer
    # entries keep every dot product exact, so equal rows score equal bits
    # in any summation order.
    base = torch.randint(-3, 4, (8, d), generator=g, device=dev).to(torch.bfloat16)
    tm = base.repeat(512, 1).contiguous()
    tsrc = torch.zeros((tm.shape[0],), dtype=torch.int32, device=dev)
    tq = torch.randint(-3, 4, (4, d), generator=g, device=dev).float()
    vk, rk = topk.scan_topk(tm, tsrc, tq, no_filter, 64)
    vp, rp = topk.scan_topk_plain(tm, tsrc, tq, no_filter, 64)
    if not (torch.equal(rk, rp) and torch.equal(vk, vp)):
        raise SystemExit("K1 tie order differs from the plain version")
    log("K1 tie rule: equal scores order by the lower row  ok")

    times = {}
    for nq in (1, 64):
        q = torch.randn((nq, d), generator=g, device=dev)
        t_k = cuda_ms(lambda: topk.scan_topk(m, src, q, no_filter, 16, ns))
        t_p = cuda_ms(lambda: topk.scan_topk_plain(m, src, q, no_filter, 16, ns))
        times[nq] = (t_k, t_p)
        log(f"K1 time Q={nq} k=16 n_sweep={ns}: kernel {t_k:.4f} ms  plain {t_p:.4f} ms  [{card}]")
    del m
    torch.cuda.empty_cache()
    return {"max_abs_err": worst, "ms": times[1][0], "plain_ms": times[1][1], "times": times}


# -- phase 4: K11 ------------------------------------------------------------


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
        t_k = cuda_ms(lambda: attn.attention(q, k, v, mask))
        t_p = cuda_ms(lambda: attn.attention_plain(q, k, v, mask))
        times[(b, s, nh, dh)] = (t_k, t_p)
        log(f"K11 time B={b} S={s} NH={nh} DH={dh}: kernel {t_k:.4f} ms  plain {t_p:.4f} ms  [{card}]")
    return {"max_abs_err": worst, "ms": times[(64, 512, 12, 32)][0],
            "plain_ms": times[(64, 512, 12, 32)][1], "times": times}


# -- phase 5: the slice ------------------------------------------------------

N_DOCS = 2048
N_LONG = N_DOCS // 4  # documents over 400 tokens
TOTAL_ROWS = 1_000_000
ENCODE_BATCH = 64
N_SELF_QUERIES = 8


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


def run_slice(card: str, workdir: str, dev) -> dict:
    import torch

    from perceive_tpu.db import Database, add_source
    from perceive_tpu.types import Source
    from perceive_tpu_torch.cli import AppState, main as cli_main
    from perceive_tpu_torch.index.matrix import serialize_embedding
    from perceive_tpu_torch.index.searcher import _k_bucket
    from perceive_tpu_torch.models import EncoderArch, HeadConfig, Model, ModelType, TextTokenizer
    from perceive_tpu_torch.ops import attention as attn
    from perceive_tpu_torch.ops import topk

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

    # the main path starts here: every launch counter from 0
    topk.LAUNCHES = 0
    attn.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()

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
    seq = 0
    with db.write() as conn:
        for d, text in enumerate(docs):
            conn.execute(
                """INSERT INTO items (id, source_id, external_id, version, hash, content,
                     process_version, name, modified) VALUES (?,?,?,?,?,?,?,?,?)""",
                (d + 1, src_docs.id, f"doc{d}.txt", 1, "", text, 0, f"doc {d}", 1_700_000_000 + d),
            )
        rows = []
        for (d, c, _), e in zip(flat, embs):
            seq += 1
            rows.append((d + 1, c, 1, serialize_embedding(e), mid, ver, seq))
        conn.executemany(
            """INSERT INTO item_embeddings (item_id, chunk_idx, item_index_version, embedding,
                 model_id, model_version, seq) VALUES (?,?,?,?,?,?,?)""",
            rows,
        )
    n_fill = TOTAL_ROWS - len(flat)
    filler_text = " ".join(vocab_list[300:316])
    chunk = 100_000
    for lo in range(0, n_fill, chunk):
        n = min(chunk, n_fill - lo)
        v = rng.standard_normal((n, 384)).astype(np.float32)
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        ids = range(N_DOCS + 1 + lo, N_DOCS + 1 + lo + n)
        with db.write() as conn:
            conn.executemany(
                """INSERT INTO items (id, source_id, external_id, version, hash, content,
                     process_version) VALUES (?,?,?,?,?,?,?)""",
                ((i, src_fill.id, f"fill{i}", 1, "", filler_text, 0) for i in ids),
            )
            conn.executemany(
                """INSERT INTO item_embeddings (item_id, chunk_idx, item_index_version, embedding,
                     model_id, model_version, seq) VALUES (?,?,?,?,?,?,?)""",
                ((i, 0, 1, v[j].tobytes(), mid, ver, seq + lo + j + 1) for j, i in enumerate(ids)),
            )
    db.close()
    log(f"sqlite corpus: {len(flat)} document rows + {n_fill} filler rows = {TOTAL_ROWS} rows "
        f"written in {time.perf_counter() - t0:.1f} s")

    # build the searcher from SQLite onto cuda:0
    t0 = time.perf_counter()
    state = AppState(db_path, model=model, highlights_model=model, device=dev)
    searcher = state.searcher
    m = searcher.matrix
    log(f"AppState build: {len(m)} rows, tier {m.tier_name}, sweep_rows {m.sweep_rows}, "
        f"capacity {m.capacity} in {time.perf_counter() - t0:.1f} s  [{card}]")
    if len(m) != TOTAL_ROWS or m.device != dev:
        raise SystemExit(f"searcher holds {len(m)} rows on {m.device}")

    # queries through the CLI
    self_docs = [N_LONG + i * ((N_DOCS - N_LONG) // N_SELF_QUERIES) for i in range(N_SELF_QUERIES)]
    queries = [docs[d] for d in self_docs]
    words = vocab_list[200:]
    for _ in range(16 - N_SELF_QUERIES):
        queries.append(" ".join(words[j] for j in rng.integers(0, len(words), int(rng.integers(3, 9)))))

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
        before = topk.LAUNCHES
        t0 = time.perf_counter()
        res = run(q)
        walls.append((time.perf_counter() - t0) * 1e3)
        if topk.LAUNCHES <= before:
            raise SystemExit("a query launched no scan_topk kernel")
        results.append(res)
    # the main path ends here; the checks below call only plain versions
    launches = {"scan_topk": topk.LAUNCHES, "attention": attn.LAUNCHES}

    # every query answered; self-queries first; snippets from their documents
    contents = {d + 1: t for d, t in enumerate(docs)}
    filler_ids = range(N_DOCS + 1, N_DOCS + 1 + n_fill)
    for qi, res in enumerate(results):
        if not res:
            raise SystemExit(f"query {qi} returned no results")
        for r in res:
            text = contents.get(r["id"], filler_text if r["id"] in filler_ids else None)
            if text is None or not r["snippet"] or r["snippet"] not in text:
                raise SystemExit(f"query {qi}: snippet of item {r['id']} is not from its document")
    firsts = sum(results[i][0]["id"] == self_docs[i] + 1 for i in range(N_SELF_QUERIES))
    log(f"queries answered: {sum(bool(r) for r in results)}/16; self-queries ranked first: "
        f"{firsts}/{N_SELF_QUERIES}")
    if firsts != N_SELF_QUERIES:
        raise SystemExit("a stored document's own text did not rank it first")

    # the hits equal the plain scan over the same device matrix and queries
    vectors, src = m.device_view()
    kb = _k_bucket(searcher._first_fetch(10), m.sweep_rows)
    allowed = torch.from_numpy(searcher._allowed_arrays(None)[0]).to(dev)
    for qi, q in enumerate(queries):
        ids = torch.from_numpy(tok.encode_batch_ids([q], pad_batch_to=1)).to(dev)
        qv = model.encode_ids(ids).float()
        vals, rows = topk.scan_topk_plain(vectors, src, qv, allowed, kb, m.sweep_rows)
        want = searcher._decode_hits(vals[0].cpu().numpy(), rows[0].cpu().numpy(), 10)
        got = [(r["id"], r["score"]) for r in results[qi]]
        if [i for i, _ in got] != [i for i, _ in want] or max(
            abs(a[1] - b[1]) for a, b in zip(got, want)
        ) > 1e-4:
            raise SystemExit(f"query {qi}: hits differ from the plain scan:\n{got}\n{want}")
    log("slice hits equal the plain scan's for 16/16 queries")

    p50, p95 = (float(np.percentile(walls, p)) for p in (50, 95))
    log(f"query wall time (CLI search -n 10 --json, incl. highlight) p50 {p50:.2f} ms  "
        f"p95 {p95:.2f} ms over 16 queries  [{card}]")
    log(f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB  [{card}]")
    log(f"kernel launches on the main path: {launches}")
    state.close()
    return {"launches": launches, "p50": p50, "p95": p95, "docs_per_s": N_DOCS / t_enc}


def main() -> int:
    card = environment()
    import torch

    build_kernels(card)
    k1 = check_k1(card)
    k11 = check_k11(card)
    with tempfile.TemporaryDirectory() as workdir:
        sl = run_slice(card, workdir, torch.device("cuda:0"))
    for name, n in sl["launches"].items():
        if n == 0:
            raise SystemExit(f"the main path launched no {name} kernel")
    record = {"kernels": [
        {"name": "scan_topk", "route": "cuda", "source": K1_SOURCE, "replaces": K1_REPLACES,
         "launches": sl["launches"]["scan_topk"], "max_abs_err": k1["max_abs_err"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"]},
        {"name": "attention", "route": "cuda", "source": K11_SOURCE, "replaces": K11_REPLACES,
         "launches": sl["launches"]["attention"], "max_abs_err": k11["max_abs_err"],
         "ms": k11["ms"], "plain_ms": k11["plain_ms"]},
    ]}
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
