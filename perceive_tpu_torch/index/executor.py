"""Micro-batching search executor: coalesce concurrent queries into one sweep.

Port of perceive_tpu/index/executor.py.  A drain of at least 256 queries
sweeps through the slab kernels (K2 at bf16, K4 at int8); smaller drains
through K1 or K3.

A sweep reads the whole matrix once whatever its width, so concurrent
callers' queries are coalesced into shared device work: requests enqueue,
the shared CoalescingBatcher drains the queue every ``window_ms``
(immediately when uncontended, or when ``max_batch`` are waiting) and this
class answers all of them together.

Text queries ride too (``submit_text``): an uncontended text query runs the
FUSED encode+sweep program (one device dispatch, searcher.search_fused); a
coalesced burst batch-encodes once and shares sweeps with vector requests.
Queries with the same (k, source-filter) signature share a sweep; mixed
signatures are grouped per drain so correctness never depends on the mix.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future
from typing import Optional, Sequence

import numpy as np

from ..utils.coalesce import CoalescingBatcher


def _result_cache_size() -> int:
    """Entries in the per-executor text-query result cache
    (PERCEIVE_TPU_RESULT_CACHE, 0 disables; default 512)."""
    try:
        return int(os.environ.get("PERCEIVE_TPU_RESULT_CACHE", "512"))
    except ValueError:
        return 512


class _Request:
    __slots__ = ("vec", "text", "k", "source_key", "want_aux", "aux_vec")

    def __init__(self, vec, k, source_key, text=None, want_aux=False):
        self.vec = vec
        self.text = text  # text queries ride the fused encode+sweep dispatch
        self.k = k
        self.source_key = source_key
        # want_aux: also return the query embedded by the executor's
        # aux_model (the highlights model) — fused into the same dispatch
        # when uncontended, one shared batch encode per drain otherwise
        self.want_aux = want_aux
        self.aux_vec = None


class BatchingSearchExecutor:
    # 512 concurrent queries sweep in one go (a slab-kernel width); a
    # bigger cap only adds queueing latency
    def __init__(
        self,
        searcher,
        *,
        model=None,
        aux_model=None,
        window_ms: float = 2.0,
        max_batch: int = 512,
        idle_factor: float = 4.0,
    ):
        self.searcher = searcher
        # optional encoder: enables submit_text (an uncontended text query
        # rides searcher.search_fused — encode + sweep in ONE dispatch;
        # coalesced text queries batch-encode once, then share the sweep)
        self.model = model
        # optional second encoder (the serve layer's highlights model):
        # want_aux text queries also get the query embedded by this model,
        # inside the same fused dispatch when uncontended
        self.aux_model = aux_model
        # observability counters (read by serve's /metrics; monotonic,
        # written only by the dispatcher thread)
        self.sweeps_total = 0
        self.queries_total = 0
        self.query_errors_total = 0
        self.sweep_seconds_total = 0.0
        # Text-query result cache: key (query, k, filter, want_aux) ->
        # (matrix.mutation_gen at sweep time, result).  A repeat query on an
        # UNCHANGED corpus is answered from here with ZERO device dispatches
        # (the fused path costs one encode and one sweep).  Validity is
        # the matrix's logical generation — any upsert/remove/retier bumps
        # it and every cached entry self-invalidates on next lookup.  The
        # gen is captured BEFORE the sweep, so a mutation racing the sweep
        # can only waste the slot (stored gen goes stale), never serve a
        # stale result at a newer gen.  model/aux_model are bound at
        # construction and never reassigned, so they aren't in the key.
        self.result_cache_hits = 0
        self.result_cache_misses = 0
        self._rcache: OrderedDict = OrderedDict()
        self._rcache_max = _result_cache_size()
        self._rcache_lock = threading.Lock()
        # the queue/window/idle-short-circuit machinery is the shared
        # CoalescingBatcher (utils/coalesce.py) in non-resolving mode:
        # _dispatch groups requests and resolves each future itself
        self._batcher = CoalescingBatcher(
            self._dispatch,
            window_ms=window_ms,
            max_batch=max_batch,
            idle_factor=idle_factor,
            name="search-batcher",
            resolving=False,
        )

    # -- client API -----------------------------------------------------------

    def submit(
        self, vec: np.ndarray, k: int, source_ids: Optional[Sequence[int]] = None
    ) -> Future:
        """Enqueue one query; resolves to [(item_id, score)]."""
        key = tuple(sorted(source_ids)) if source_ids is not None else None
        return self._batcher.submit(
            _Request(np.asarray(vec, np.float32).reshape(-1), k, key)
        )

    def search(self, vec, k, source_ids=None, timeout: float = 30.0):
        """Blocking convenience wrapper."""
        return self.submit(vec, k, source_ids).result(timeout)

    def submit_text(
        self,
        query: str,
        k: int,
        source_ids: Optional[Sequence[int]] = None,
        *,
        want_aux: bool = False,
    ) -> Future:
        """Enqueue a TEXT query; encode happens on the dispatcher — fused
        with the sweep into one device program when uncontended.  With
        ``want_aux`` the future resolves to ``(hits, aux_qvec)`` where
        ``aux_qvec`` is the query embedded by the executor's aux_model (may
        be None when there were no hits to highlight)."""
        if self.model is None:
            raise RuntimeError("executor built without a model; submit vectors")
        if want_aux and self.aux_model is None:
            raise RuntimeError("executor built without an aux_model")
        key = tuple(sorted(source_ids)) if source_ids is not None else None
        cached = self._rcache_get((query, k, key, want_aux))
        if cached is not None:
            fut: Future = Future()
            fut.set_result(cached)
            return fut
        return self._batcher.submit(
            _Request(None, k, key, text=query, want_aux=want_aux)
        )

    def search_text(self, query, k, source_ids=None, timeout: float = 30.0,
                    *, want_aux: bool = False):
        """Blocking convenience wrapper for text queries."""
        return self.submit_text(query, k, source_ids, want_aux=want_aux).result(timeout)

    def close(self) -> None:
        self._batcher.close()

    # -- result cache ----------------------------------------------------------

    @staticmethod
    def _copy_result(result, want_aux: bool):
        """Hand each caller its own hits list (the aux vector is read-only
        by contract) so one caller's mutation can't corrupt the cache."""
        if want_aux:
            hits, aux = result
            return (list(hits), aux)
        return list(result)

    def _rcache_get(self, key):
        if self._rcache_max <= 0:
            return None
        gen = self.searcher.matrix.mutation_gen
        with self._rcache_lock:
            e = self._rcache.get(key)
            if e is not None and e[0] == gen:
                self._rcache.move_to_end(key)
                self.result_cache_hits += 1
                return self._copy_result(e[1], key[3])
            if e is not None:
                del self._rcache[key]  # corpus changed since: drop
            # inside the lock: misses are bumped on CALLER threads (unlike
            # the dispatcher-owned counters), so the unlocked += lost
            # increments under concurrent submitters
            self.result_cache_misses += 1
        return None

    def _rcache_put(self, key, gen: int, result) -> None:
        if self._rcache_max <= 0:
            return
        with self._rcache_lock:
            # store a PRIVATE copy: the filling request's caller holds the
            # original and may mutate its hits list
            self._rcache[key] = (gen, self._copy_result(result, key[3]))
            self._rcache.move_to_end(key)
            while len(self._rcache) > self._rcache_max:
                self._rcache.popitem(last=False)

    # -- dispatcher (runs on the batcher thread) -------------------------------

    def _dispatch(self, pairs: list) -> None:
        """``pairs``: live (request, future) tuples from one drain; every
        future is resolved here (CoalescingBatcher resolving=False)."""
        if len(pairs) == 1 and pairs[0][0].text is not None:
            # uncontended text query: encode + sweep in ONE compiled
            # dispatch (searcher.search_fused); want_aux
            # folds the highlight-model query encode into the same program
            r, fut = pairs[0]
            t0 = time.monotonic()
            gen = self.searcher.matrix.mutation_gen  # BEFORE the sweep
            try:
                source_ids = list(r.source_key) if r.source_key is not None else None
                if r.want_aux:
                    result = self.searcher.search_fused(
                        self.model, r.text, r.k, source_ids,
                        aux_model=self.aux_model,
                    )
                else:
                    result = self.searcher.search_fused(
                        self.model, r.text, r.k, source_ids
                    )
            except Exception as e:  # noqa: BLE001
                self.query_errors_total += 1
                fut.set_exception(e)
                return
            self.sweeps_total += 1
            self.queries_total += 1
            self.sweep_seconds_total += time.monotonic() - t0
            self._rcache_put((r.text, r.k, r.source_key, r.want_aux), gen, result)
            fut.set_result(result)
            return
        texts = [(r, f) for r, f in pairs if r.text is not None]
        if texts:
            # coalesced text queries: ONE batched encode dispatch, then the
            # vectors share sweeps with everything else in the drain; the
            # want_aux requests share one aux-model batch encode too
            try:
                vecs = self.model.encode([r.text for r, _ in texts])
                for (r, _), v in zip(texts, vecs):
                    r.vec = np.asarray(v, np.float32).reshape(-1)
            except Exception as e:  # noqa: BLE001
                self.query_errors_total += len(texts)
                for _, f in texts:
                    f.set_exception(e)
                pairs = [(r, f) for r, f in pairs if r.text is None]
            aux_reqs = [r for r, f in pairs if r.want_aux and r.text is not None]
            if aux_reqs:
                try:
                    aux_vecs = self.aux_model.encode([r.text for r in aux_reqs])
                    for r, v in zip(aux_reqs, aux_vecs):
                        r.aux_vec = np.asarray(v, np.float32).reshape(-1)
                except Exception:  # noqa: BLE001 — the aux embed is a
                    # highlight optimization; its failure must not fail the
                    # SEARCH (and certainly not the non-aux requests in the
                    # drain).  aux_vec stays None; highlight_batch handles a
                    # None query embedding by riding the chunk batch.
                    pass
        # group by (k, source filter): each group is one device sweep
        groups: dict = {}
        for r, f in pairs:
            groups.setdefault((r.k, r.source_key), []).append((r, f))
        for (k, source_key), reqs in groups.items():
            t0 = time.monotonic()
            gen = self.searcher.matrix.mutation_gen  # BEFORE the sweep
            try:
                vecs = np.stack([r.vec for r, _ in reqs])
                source_ids = list(source_key) if source_key is not None else None
                results = self.searcher.search_vectors_batch(vecs, k, source_ids)
            except Exception as e:  # noqa: BLE001 — fail the requests, not the loop
                self.query_errors_total += len(reqs)
                for _, f in reqs:
                    f.set_exception(e)
                continue
            self.sweeps_total += 1
            self.queries_total += len(reqs)
            self.sweep_seconds_total += time.monotonic() - t0
            for (r, f), hits in zip(reqs, results):
                result = (hits, r.aux_vec) if r.want_aux else hits
                degraded_aux = r.want_aux and r.aux_vec is None and bool(hits)
                if r.text is not None and not degraded_aux:
                    # a failed aux encode (aux_vec None with real hits) is a
                    # transient degradation — caching it would pin every
                    # repeat of this query to the slower highlight path
                    # until the corpus next changes
                    self._rcache_put(
                        (r.text, r.k, r.source_key, r.want_aux), gen, result
                    )
                f.set_result(result)
