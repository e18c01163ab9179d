"""Highlight engine: the best-matching snippet of each result document.

A copy of perceive_tpu/models/highlight.py (numpy only), bound to the
port's ``Model`` through duck typing: it calls ``model.tokenizer.
encode_untruncated`` / ``encode_token_chunks``, ``model.encode_token_batch``
and ``model.dim``.  Each document is tokenized untruncated and cut into
CHUNK_SIZE-token windows with CHUNK_OVERLAP; every window is encoded in one
batch, dotted with the query embedding, and the best window's character
range is sliced out of the original text.  A per-model LRU keeps each
document's chunk embeddings keyed by content hash.
"""

from __future__ import annotations

import hashlib
import os
import threading
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np


def _chunk_sizes() -> tuple[int, int]:
    """(CHUNK_SIZE, CHUNK_OVERLAP), env-tunable (highlight.rs:7-18)."""

    def env_int(name: str, default: int) -> int:
        try:
            return int(os.environ.get(name, ""))
        except ValueError:
            return default

    return env_int("CHUNK_SIZE", 20), env_int("CHUNK_OVERLAP", 4)


def _longest_nonspecial_run(special_mask: Sequence[int]) -> tuple[int, int]:
    """(start, length) of the longest consecutive run of non-special tokens."""
    best_start = best_len = cur_start = cur_len = 0
    for i, is_special in enumerate(special_mask):
        if not is_special:
            if cur_len == 0:
                cur_start = i
            cur_len += 1
            if cur_len > best_len:
                best_start, best_len = cur_start, cur_len
        else:
            cur_len = 0
    return best_start, best_len


class HighlightCache:
    """Thread-safe LRU of per-document highlight chunk data.

    key -> (char_ranges, embs): ``char_ranges[i]`` is the (start, end) char
    range of chunk i in the original text (or None when the chunk's tokens
    carry no offsets), ``embs`` is the (n_chunks, dim) f32 chunk-embedding
    matrix.  Keys include the content hash and the chunk geometry, so a
    changed document or a retuned CHUNK_SIZE can never serve stale entries.

    Bounded BOTH by entry count (``max_docs``) and by embedding bytes
    (``max_bytes``) — a doc-count-only LRU would let a few pathological
    multi-megabyte documents (thousands of chunks each) pin gigabytes of
    host RAM.
    """

    def __init__(self, max_docs: int, max_bytes: int = 64 << 20):
        self.max_docs = max_docs
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._entries: OrderedDict = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def nbytes(self) -> int:
        return self._bytes

    @staticmethod
    def _size(value) -> int:
        return int(getattr(value[1], "nbytes", 0))

    def get(self, key):
        with self._lock:
            v = self._entries.get(key)
            if v is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return v

    def put(self, key, value) -> None:
        ranges, embs = value
        if getattr(embs, "base", None) is not None:
            # a slice VIEW into a batch's concatenated encode would pin the
            # whole base array while .nbytes counts only the slice — the
            # byte budget must account what is actually held
            value = (ranges, embs.copy())
        size = self._size(value)
        if size > self.max_bytes:
            return  # larger than the whole budget: never cache it
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= self._size(old)
            self._entries[key] = value
            self._bytes += size
            while self._entries and (
                len(self._entries) > self.max_docs or self._bytes > self.max_bytes
            ):
                _, evicted = self._entries.popitem(last=False)
                self._bytes -= self._size(evicted)
                self.evictions += 1


_CACHE_INIT_LOCK = threading.Lock()


def _cache_for(model) -> Optional[HighlightCache]:
    """The model's highlight cache (binding it to the model instance keys
    entries by model identity for free).  PERCEIVE_TPU_HIGHLIGHT_CACHE_DOCS
    sets the LRU entry cap (0 disables) and PERCEIVE_TPU_HIGHLIGHT_CACHE_MB
    the byte budget.  Defaults: 1024 docs / 64 MB — a typical doc is ~32
    chunks x 384 dims f32 = 48 KB, so the byte budget only bites when the
    working set skews to very long documents."""
    cache = getattr(model, "_highlight_cache", None)
    if cache is None:
        with _CACHE_INIT_LOCK:  # serve's warm thread races the first query
            cache = getattr(model, "_highlight_cache", None)
            if cache is None:
                def env_int(name: str, default: int) -> int:
                    try:
                        return int(os.environ.get(name, ""))
                    except ValueError:
                        return default

                n = env_int("PERCEIVE_TPU_HIGHLIGHT_CACHE_DOCS", 1024)
                mb = env_int("PERCEIVE_TPU_HIGHLIGHT_CACHE_MB", 64)
                cache = (
                    HighlightCache(n, max_bytes=mb << 20)
                    if n > 0 and mb > 0
                    else False
                )
                model._highlight_cache = cache
    # NOTE: an empty HighlightCache is falsy (__len__ == 0) — test by type,
    # not truthiness (False marks "disabled")
    return cache if isinstance(cache, HighlightCache) else None


def _doc_key(text: str, chunk_size: int, chunk_overlap: int) -> tuple:
    h = hashlib.sha1(text.encode("utf-8", "surrogatepass")).hexdigest()
    return (h, len(text), chunk_size, chunk_overlap)


def _prepare_docs(model, texts, chunk_size, chunk_overlap, step):
    """Host-side chunking: per document, (token chunk windows, per-chunk
    char ranges).  Char ranges are resolved here (min/max over each chunk's
    token offsets, highlight.rs:129-158) so a cached document never needs
    its tokenization again."""
    encs = model.tokenizer.encode_untruncated(list(texts))
    out = []
    for enc in encs:
        chunks: list[list[int]] = []
        ranges: list[Optional[tuple[int, int]]] = []
        n = len(enc.ids)
        i = 0
        while i + chunk_overlap < n:
            end = min(i + chunk_size, n)
            start, length = _longest_nonspecial_run(enc.special_tokens_mask[i:end])
            abs_start = i + start
            abs_end = min(abs_start + length, end)
            if abs_end - abs_start >= chunk_size // 2:
                chunks.append(list(enc.ids[abs_start:abs_end]))
                span = enc.offsets[abs_start:abs_end]
                offsets = [
                    o for o in span if o is not None and o != (0, 0)
                ] or [o for o in span if o is not None]
                if offsets:
                    ranges.append(
                        (min(o[0] for o in offsets), max(o[1] for o in offsets))
                    )
                else:
                    ranges.append(None)
            i += step
        out.append((chunks, ranges))
    return out


def _best_snippet(text, ranges, embs, qemb) -> Optional[str]:
    """Argmax chunk -> char-range snippet (highlight.rs:104-158 semantics:
    a document with no chunks, or whose best chunk has no offsets, yields
    None)."""
    if len(ranges) == 0:
        return None
    r = ranges[int(np.argmax(embs @ qemb))]
    return None if r is None else text[r[0] : r[1]]


def highlight_batch(
    model,
    pairs: Sequence[tuple[str, Sequence[str]]],
    query_embs: Optional[Sequence] = None,
) -> list[list[Optional[str]]]:
    """Many (query, documents) highlight requests through ONE device batch.

    All requests' uncached chunk windows — and each request's query, unless
    its ``query_embs`` entry is supplied — concatenate into a single bucketed
    encode, so N concurrent queries cost at most one highlight dispatch.
    When every
    document hits the chunk cache AND the query embedding is supplied (the
    fused search program returns it), no device dispatch happens at all.
    """
    chunk_size, chunk_overlap = _chunk_sizes()
    step = max(chunk_size - chunk_overlap, 1)
    if query_embs is None:
        query_embs = [None] * len(pairs)
    cache = _cache_for(model)

    # Phase 1: cache lookups; collect the miss documents of every request.
    # A docstate is ("hit", ranges, embs) or a mutable ["miss", key, None]
    # slot filled by phase 2 with (base index into to_encode, count, ranges).
    # Duplicate misses (coalesced concurrent queries share top-k documents —
    # exactly the common case) share ONE slot, so each distinct document is
    # tokenized and encoded once per batch.
    requests: list = []
    miss_texts: list[str] = []
    miss_slots: list[list] = []
    slot_by_key: dict = {}
    for (query, documents), qemb in zip(pairs, query_embs):
        if not documents:
            requests.append(None)
            continue
        docstates: list = []
        for d in documents:
            hit = None
            key = None
            if cache is not None:
                key = _doc_key(d, chunk_size, chunk_overlap)
                hit = cache.get(key)
            if hit is not None:
                docstates.append(("hit",) + hit)
            elif key is not None and key in slot_by_key:
                docstates.append(slot_by_key[key])  # dup miss: shared slot
            else:
                slot = ["miss", key, None]
                docstates.append(slot)
                miss_texts.append(d)
                miss_slots.append(slot)
                if key is not None:
                    slot_by_key[key] = slot
        requests.append([query, documents, docstates, qemb, -1])

    # Phase 2: tokenize + chunk all miss documents in one tokenizer batch.
    to_encode: list[list[int]] = []
    if miss_texts:
        for slot, (chunks, ranges) in zip(
            miss_slots, _prepare_docs(model, miss_texts, chunk_size, chunk_overlap, step)
        ):
            slot[2] = (len(to_encode), len(chunks), ranges)
            to_encode.extend(chunks)

    # Phase 3: queries whose embedding wasn't supplied ride the same batch
    # as one more token window (a separate encode([query]) would be a
    # second device round trip) — but only when the request has at least
    # one chunk to score.
    pending_q: list[list] = []
    for req in requests:
        if req is None:
            continue
        _, _, docstates, qemb, _ = req
        if qemb is not None:
            continue
        n_chunks = sum(
            len(s[2]) if s[0] == "hit" else s[2][1] for s in docstates
        )
        if n_chunks == 0:
            continue
        pending_q.append(req)
    if pending_q:  # ONE tokenizer call for all pending queries, like the docs
        for req, qenc in zip(
            pending_q,
            model.tokenizer.encode_untruncated(
                [r[0] for r in pending_q], fast=True  # ids + special mask only
            ),
        ):
            req[4] = len(to_encode)
            to_encode.append(
                [i for i, m in zip(qenc.ids, qenc.special_tokens_mask) if not m]
            )

    # Phase 4: one bucketed device encode of everything that missed.
    all_embs = None
    if to_encode:
        embs = []
        for s in range(0, len(to_encode), 256):
            tb = model.tokenizer.encode_token_chunks(to_encode[s : s + 256])
            embs.append(model.encode_token_batch(tb))
        all_embs = np.concatenate(embs, axis=0)

    # Phase 5: per request, assemble per-doc (ranges, embs), fill the cache,
    # score, and slice snippets.
    out: list[list[Optional[str]]] = []
    for req in requests:
        if req is None:
            out.append([])
            continue
        query, documents, docstates, qemb, q_idx = req
        if q_idx >= 0:
            qemb = all_embs[q_idx]
        snippets: list[Optional[str]] = []
        for d, state in zip(documents, docstates):
            if state[0] == "hit":
                _, ranges, dembs = state
            else:
                _, key, (base, count, ranges) = state
                dembs = (
                    all_embs[base : base + count]
                    if count
                    else np.zeros((0, model.dim), np.float32)
                )
                if cache is not None:
                    cache.put(key, (ranges, dembs))
                # resolve the shared slot in place: other requests in this
                # coalesced batch referencing the same document take the hit
                # branch instead of re-slicing + re-put()ing it
                state[:] = ("hit", ranges, dembs)
            if qemb is None:  # no chunks anywhere in this request
                snippets.append(None)
            else:
                snippets.append(_best_snippet(d, ranges, dembs, qemb))
        out.append(snippets)
    return out


def precompute_chunks(model, documents: Sequence[str]) -> int:
    """Fill the chunk cache for ``documents`` without scoring anything.

    The serve layer calls this in the background after readiness (most
    recently accessed items first) so that even a FIRST-seen query's
    highlight needs no device dispatch — on a personal-sized corpus the
    whole working set fits the cache budget.  Already-cached and empty
    documents are skipped; returns how many documents were newly encoded.
    Stops early (returns what it did) once the cache's byte budget would
    evict what it just warmed."""
    cache = _cache_for(model)
    if cache is None:
        return 0
    chunk_size, chunk_overlap = _chunk_sizes()
    step = max(chunk_size - chunk_overlap, 1)
    miss: list[tuple[tuple, str]] = []
    seen = set()
    for d in documents:
        if not d:
            continue
        key = _doc_key(d, chunk_size, chunk_overlap)
        if key in seen:
            continue
        seen.add(key)
        if cache.get(key) is None:
            miss.append((key, d))
    done = 0
    ev0 = cache.evictions
    for s in range(0, len(miss), 64):  # bounded tokenizer + device batches
        batch = miss[s : s + 64]
        prepared = _prepare_docs(
            model, [d for _, d in batch], chunk_size, chunk_overlap, step
        )
        flat: list[list[int]] = []
        for chunks, _ in prepared:
            flat.extend(chunks)
        embs = []
        for e in range(0, len(flat), 256):
            tb = model.tokenizer.encode_token_chunks(flat[e : e + 256])
            embs.append(model.encode_token_batch(tb))
        all_embs = (
            np.concatenate(embs, axis=0)
            if embs
            else np.zeros((0, model.dim), np.float32)
        )
        base = 0
        for (key, _), (chunks, ranges) in zip(batch, prepared):
            dembs = all_embs[base : base + len(chunks)]
            base += len(chunks)
            cache.put(key, (ranges, dembs))
            done += 1
        if cache.evictions > ev0:
            break  # capacity reached (docs or bytes) — warming further
            # would only cycle the LRU
    return done


def highlight(
    model, query: str, documents: Sequence[str], query_emb=None
) -> list[Optional[str]]:
    """Best snippet per document, or None when a document yields no chunks.

    The query embeds IN THE SAME device batch as the chunks (appended as one
    more token window) unless ``query_emb`` is supplied."""
    return highlight_batch(model, [(query, documents)], [query_emb])[0]
