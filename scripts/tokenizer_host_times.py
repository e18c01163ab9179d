#!/usr/bin/env python
"""Host seconds of the port's tokenizer over chip_smoke.py's corpora, for one
tree.

    python3 scripts/tokenizer_host_times.py [--root TREE] [--reps N]

Imports ``perceive_tpu_torch`` from TREE (default: this checkout) and times
``TextTokenizer``'s entry points on this host's CPU, over the corpora that
this checkout's ``chip_smoke.py`` generates (so two trees see the same
texts):

  * ``ingest``: ``encode_untruncated(docs, fast=True)`` over the bf16
    slice's 2,048 documents at all-MiniLM-L6-v2 width (the ingest chunker's
    call) and ``offsets``: the same with offsets (the highlight path's);
  * ``query``: ``encode_batch_ids([q], pad_batch_to=1)`` for each of the 16
    CLI queries, one call each (the searcher's), summed;
  * ``highlight``: ``encode_untruncated`` of 10 documents for each query
    (highlight's ``_prepare_docs`` over a page of hits), summed;
  * ``bpe`` and ``unigram``: ``encode_untruncated(docs, fast=True)`` over
    each tokenizer.json family's 256 documents.

Each is the median of ``--reps`` runs after one warm run; ``construct`` is
``TextTokenizer.from_vocab``'s seconds once the tree's tokenizer is ready
(a build, where the tree has one, comes before it).  Prints one JSON line.
Run it over two trees in turns (parent, change, change, parent) to compare
them on one host.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _median(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE), help="the tree whose perceive_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    from perceive_tpu_torch.models import TextTokenizer
    from perceive_tpu_torch.models.tokenizer_json import Pipeline

    smoke = _smoke()
    words = smoke.minilm_vocab()
    rng = np.random.default_rng(11)
    docs = smoke.make_docs(rng, words)
    _, queries = smoke.text_queries(rng, docs, words)
    vocab = {w: i for i, w in enumerate(words)}
    TextTokenizer.from_vocab(vocab)  # any build first
    t0 = time.perf_counter()
    tok = TextTokenizer.from_vocab(vocab, max_seq_length=512)
    out = {"root": str(Path(args.root).resolve()), "cpus": os.cpu_count(), "docs": len(docs),
           "chars": sum(map(len, docs)), "construct": time.perf_counter() - t0,
           "engine": hasattr(tok, "engine")}
    out["ingest"] = _median(lambda: tok.encode_untruncated(docs, fast=True), args.reps)
    out["offsets"] = _median(lambda: tok.encode_untruncated(docs), args.reps)
    out["query"] = _median(lambda: [tok.encode_batch_ids([q], pad_batch_to=1) for q in queries], args.reps)
    pages = [[docs[(7 * i + j) % len(docs)] for j in range(10)] for i in range(len(queries))]
    out["highlight"] = _median(lambda: [tok.encode_untruncated(page) for page in pages], args.reps)
    for seed, (name, make) in enumerate((("bpe", smoke.bpe_tokenizer_json), ("unigram", smoke.unigram_tokenizer_json)),
                                        start=20):
        spec = make()
        fam = TextTokenizer(Pipeline(spec), max_seq_length=512)
        fdocs = smoke.family_docs(np.random.default_rng(seed), spec)
        out[name] = _median(lambda: fam.encode_untruncated(fdocs, fast=True), args.reps)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
