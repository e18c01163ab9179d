"""Searcher: exact top-k query engine over the device matrix (bf16, f32
and int8 tiers).

Port of perceive_tpu/index/searcher.py's bf16, f32 and int8 paths:

    build()           SELECT every live embedding -> device matrix
    rebuild_source()  drop + reload one source's rows
    search_vector()   q -> top-k (item_id, score), chunk hits deduped
    search_fused()    text -> encode (main + highlight model) -> scan
    retrieve()        join ids back to SQLite rows

Every sweep goes through ``ops.topk``: the CUDA kernels for a matrix on a
CUDA device (K1/K2 at bf16 and f32, K3/K4 at int8, by batch width), their
plain versions for one on the CPU.  The bf16 and f32 tiers score exactly
as stored, so their sweep is the answer.  The int8 tier's scores are
approximate: the sweep over-fetches RERANK_FACTOR times the candidates,
``_rerank`` rescores them in f32 against the host mirror, and ``_scan``
escalates to a 4x deeper sweep while the k-th exact score does not clear
the fetched floor plus a 3-sigma quantization-noise margin.  Scores are
plain dot products (cosine when the model L2-normalizes).

``build`` always loads from SQLite: snapshots are not ported yet, and any
snapshot recorded in ``vector_shards`` is ignored.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..db import ITEM_COLUMNS, Database, deserialize_item_row, json_ids
from ..ops import topk
from ..types import Item
from .matrix import CHUNK_STRIDE, EmbeddingMatrix, chunk_key, deserialize_embedding, key_item

K_BUCKETS = (16, 32, 64, 128, 256, 512, 1024)
MAX_K = K_BUCKETS[-1]
# internal over-fetch (chunk dedupe) may exceed the user-facing MAX_K
_OVERFETCH_BUCKETS = K_BUCKETS + (2048, 4096, 8192)
MAX_SOURCE_FILTER = topk.MAX_FILTER


# quantized sweeps over-fetch candidates by this factor before the f32
# rerank; the escalation loop in _scan re-fetches 4x deeper whenever the
# fetched floor cannot prove the top-k
RERANK_FACTOR = 4


def _margin_sigma() -> float:
    """N-sigma quantization-noise margin on the escalation trigger
    (PERCEIVE_TPU_RERANK_MARGIN_SIGMA, default 3; 0 keeps the fetched floor
    alone).  The floor proves that no row outside the candidates has a
    QUANTIZED score above it; the margin also covers rows whose quantized
    score underestimates the exact one, with per-dot noise std
    sqrt(scale_row^2 * |q|^2 + qscale^2 * |row|^2) / sqrt(12)."""
    try:
        return float(os.environ.get("PERCEIVE_TPU_RERANK_MARGIN_SIGMA", "3"))
    except ValueError:
        return 3.0


def _k_bucket(k: int, n: int) -> int:
    for b in _OVERFETCH_BUCKETS:
        if b >= k:
            return min(b, max(n, 1))
    return min(_OVERFETCH_BUCKETS[-1], max(n, 1))


@dataclasses.dataclass
class SearchResult:
    item: Item
    score: float
    source_name: str = ""
    highlight: Optional[str] = None


class Searcher:
    def __init__(
        self,
        model_id: int,
        model_version: int,
        dim: int,
        *,
        device: torch.device | str,
        dtype: torch.dtype = torch.bfloat16,
        matrix: Optional[EmbeddingMatrix] = None,
    ):
        self.model_id = model_id
        self.model_version = model_version
        self.matrix = matrix if matrix is not None else EmbeddingMatrix(dim, dtype=dtype, device=device)
        # when True (AppState's "auto" tier), growth re-evaluates the tier
        self.auto_retier = False
        # how often a quantized sweep's floor forced a deeper re-fetch, and
        # how many scans ran (plain ints, bumped under the GIL)
        self.escalations = 0
        self.scan_calls = 0

    # -- build ---------------------------------------------------------------

    _CHUNK_STRIDE = CHUNK_STRIDE

    _BUILD_SQL = f"""
        SELECT items.id, items.source_id, ie.embedding, ie.chunk_idx
        FROM items
        JOIN item_embeddings ie ON ie.item_id = items.id
          AND ie.model_id = ? AND ie.model_version = ?
          AND ie.chunk_idx < {_CHUNK_STRIDE}
        WHERE items.skipped IS NULL AND items.hidden_at IS NULL
    """

    @classmethod
    def build(
        cls,
        db: Database,
        model_id: int,
        model_version: int,
        dim: int,
        *,
        device: torch.device | str,
        dtype: torch.dtype = torch.bfloat16,
    ) -> "Searcher":
        """Load every live embedding for (model_id, model_version) from
        SQLite and stage the device matrix.  Snapshots are ignored."""
        dbg = os.environ.get("PERCEIVE_TPU_DEBUG_STARTUP")
        s = cls(model_id, model_version, dim, device=device, dtype=dtype)
        t0 = time.perf_counter()
        s._load(db, extra_sql="", params=())
        t1 = time.perf_counter()
        s.matrix.sync()
        if dbg:
            print(
                f"build: stream+upsert {t1 - t0:.1f}s  device stage {time.perf_counter() - t1:.1f}s",
                file=sys.stderr,
            )
        return s

    # rows per chunk when streaming embeddings out of SQLite
    _LOAD_DB_CHUNK_ROWS = 262_144

    def _load(self, db: Database, extra_sql: str, params: tuple) -> int:
        cur = db.read().execute(
            self._BUILD_SQL + extra_sql, (self.model_id, self.model_version, *params)
        )
        total = skipped_dim = 0
        want_len = 4 * self.matrix.dim  # f32-LE BLOBs
        while True:
            rows = cur.fetchmany(self._LOAD_DB_CHUNK_ROWS)
            if not rows:
                break
            # rows of another width under the same (model_id, version) can
            # never score against this model's queries: skip them
            good = [r for r in rows if len(r[2]) == want_len]
            skipped_dim += len(rows) - len(good)
            if not good:
                continue
            keys = [chunk_key(r[0], r[3]) for r in good]
            vecs = np.frombuffer(b"".join(r[2] for r in good), dtype="<f4").reshape(
                len(good), self.matrix.dim
            )
            self.matrix.upsert(keys, [r[1] for r in good], vecs)
            total += len(good)
        if skipped_dim:
            print(
                f"WARNING: skipped {skipped_dim} stored embeddings whose byte length != "
                f"{want_len} (written by a different-dim encoder under "
                f"model_id={self.model_id} v{self.model_version})",
                file=sys.stderr,
            )
        if total:
            self._maybe_retier()
        return total

    def rebuild_source(self, db: Database, source_id: int) -> int:
        """Drop + reload one source's rows."""
        self.matrix.remove_source(source_id)
        n = self._load(db, " AND items.source_id = ?", (source_id,))
        self.matrix.sync()
        return n

    # -- incremental updates -------------------------------------------------

    def upsert_embeddings(self, item_ids: Sequence, source_ids: Sequence[int], vectors: np.ndarray) -> None:
        """Stream vectors into the matrix.  ``item_ids`` entries are item ids
        (chunk 0) or (item_id, chunk_idx) pairs; chunk keys an item no longer
        has are tombstoned."""
        keys: list[int] = []
        per_item: dict[int, set[int]] = {}
        for e in item_ids:
            iid, ci = e if isinstance(e, tuple) else (int(e), 0)
            keys.append(chunk_key(iid, ci))
            per_item.setdefault(iid, set()).add(keys[-1])
        stale = []
        for iid, new in per_item.items():
            stale.extend(k for k in self.matrix.keys_of_group(iid) if k not in new)
        if stale:
            self.matrix.remove(stale)
        self.matrix.upsert(keys, source_ids, vectors)
        self._maybe_retier()

    def remove_items(self, item_ids: Sequence[int]) -> int:
        """Tombstone every chunk of each item."""
        keys = [k for iid in item_ids for k in self.matrix.keys_of_group(int(iid))]
        return self.matrix.remove(keys)

    def _maybe_retier(self) -> None:
        """Follow the auto tier rule as the corpus grows (bf16, then int8).
        A corpus past the int8 tier raises (the int2 and int4 tiers are not
        ported) rather than being served in another tier."""
        if not self.auto_retier:
            return
        from .matrix import auto_matrix_dtype

        self.matrix.retier(auto_matrix_dtype(len(self.matrix), self.matrix.padded_dim))

    # -- query ---------------------------------------------------------------

    @staticmethod
    def _sweep(vectors, scales, source_ids, q, allowed, kb: int, n_sweep: int):
        """The tier's sweep on device tensors -> ((Q, kb) scores, rows)."""
        if scales is not None:
            return topk.scan_topk_int8(vectors, scales, source_ids, q, allowed, kb, n_sweep)
        return topk.scan_topk(vectors, source_ids, q, allowed, kb, n_sweep)

    def _device_scan(self, qp: np.ndarray, kb: int, allowed: np.ndarray):
        """One sweep -> ((Q, kb) scores, (Q, kb) rows) on the host (int8:
        approximate scores; _scan reranks).  Capture and launch happen under
        the matrix lock; the copy back outside it."""
        m = self.matrix
        with m._lock:
            vectors, source_ids, scales = m.device_view()
            vals, rows = self._sweep(
                vectors, scales, source_ids,
                torch.from_numpy(np.ascontiguousarray(qp)).to(m.device),
                torch.from_numpy(allowed).to(m.device), kb, m.sweep_rows,
            )
        return vals.cpu().numpy(), rows.cpu().numpy()

    def _first_fetch(self, k: int) -> int:
        """Candidate depth of the first sweep for a user-facing k: times
        RERANK_FACTOR at a quantized tier, doubled while any document is
        chunk-embedded (dedupe needs extra).  The one formula shared by
        _scan and search_fused."""
        want = RERANK_FACTOR * k if self.matrix.quantized else k
        return 2 * want if self.matrix.multi_chunk_groups > 0 else want

    def _pad_queries(self, q: np.ndarray) -> np.ndarray:
        """Zero-pad queries to the matrix's lane-aligned width."""
        m = self.matrix
        if m.padded_dim <= m.dim:
            return q
        return np.concatenate([q, np.zeros((q.shape[0], m.padded_dim - m.dim), q.dtype)], axis=1)

    # query-count buckets (the encoder's BATCH_BUCKETS ladder); zero-pad
    # queries are sliced off before return
    _Q_BUCKETS = (1, 8, 16, 32, 64, 128, 256, 512)

    @classmethod
    def _q_bucket(cls, n: int) -> int:
        for b in cls._Q_BUCKETS:
            if n <= b:
                return b
        return n

    def _scan(self, q: np.ndarray, k: int, allowed: np.ndarray, first_sweep=None):
        """Sweep (or take the fused sweep ``first_sweep`` = (kb, vals,
        rows) when its depth matches), then at a quantized tier rerank and
        escalate until the fetched floor proves the top k."""
        m = self.matrix
        self.scan_calls += 1
        want = self._first_fetch(k)
        q0 = q.shape[0]
        qb = self._q_bucket(q0)
        if qb > q0:
            q = np.concatenate([q, np.zeros((qb - q0, q.shape[1]), q.dtype)], axis=0)
        qp = self._pad_queries(q)
        while True:
            kb = _k_bucket(want, m.sweep_rows)
            if first_sweep is not None and first_sweep[0] == kb:
                vals, rows = first_sweep[1], first_sweep[2]  # the fused sweep
            else:
                vals, rows = self._device_scan(qp, kb, allowed)
            first_sweep = None
            if not m.quantized:
                return vals[:q0], rows[:q0]
            evals, erows = self._rerank(q, vals, rows)
            # a row outside the candidates scores at most the quantized
            # floor (the kb-th fetched score): once the k-th exact score
            # clears it (plus the noise margin), no outside row can
            # displace the top k; else fetch 4x deeper
            if kb >= min(m.rows, _OVERFETCH_BUCKETS[-1]):
                return evals[:q0], erows[:q0]  # fetched everything fetchable
            buffer_full = np.isfinite(vals[:, -1])  # else every match was fetched
            kth = evals[:, min(k, evals.shape[1]) - 1]
            margin = 0.0
            sigmas = _margin_sigma()
            if sigmas > 0.0:
                qnorm = np.linalg.norm(q[:, : m.dim], axis=1)
                qscale = np.abs(q[:, : m.dim]).max(axis=1) / 127.0
                margin = sigmas * np.sqrt(
                    (m.scale_hw * qnorm) ** 2 + (qscale * m.norm_hw) ** 2
                ) / np.sqrt(12.0)
            if not (buffer_full & (kth < vals[:, -1] + margin)).any():
                return evals[:q0], erows[:q0]
            self.escalations += 1
            want = 4 * kb  # past the current bucket, not the request

    def _rerank(self, q: np.ndarray, vals: np.ndarray, rows: np.ndarray):
        """Exact f32 rescoring of quantized candidates against the host
        mirror, best first (a stable sort: equal scores keep sweep order)."""
        m = self.matrix
        out_vals = np.full_like(vals, -np.inf)
        out_rows = np.full_like(rows, -1)
        for qi in range(len(q)):
            cand = rows[qi][vals[qi] > -np.inf]
            if len(cand) == 0:
                continue
            exact = m.host_vectors_for(cand) @ q[qi, : m.dim]
            order = np.argsort(-exact, kind="stable")
            out_vals[qi, : len(cand)] = exact[order]
            out_rows[qi, : len(cand)] = cand[order]
        return out_vals, out_rows

    def _allowed_arrays(self, source_ids: Optional[Sequence[int]]) -> list[np.ndarray]:
        """Fixed-size filter arrays; longer filters split into scan groups
        whose results merge."""
        if source_ids is None:
            allowed = np.full(MAX_SOURCE_FILTER, -9, dtype=np.int32)
            allowed[0] = topk.ALLOW_ALL
            return [allowed]
        ids = sorted(set(int(i) for i in source_ids))
        out = []
        for start in range(0, len(ids), MAX_SOURCE_FILTER):
            allowed = np.full(MAX_SOURCE_FILTER, -9, dtype=np.int32)
            group = ids[start : start + MAX_SOURCE_FILTER]
            allowed[: len(group)] = group
            out.append(allowed)
        return out

    def _scan_filtered(self, q: np.ndarray, k: int, source_ids, first_sweep=None) -> tuple:
        """(vals, rows, full, depth): ``full`` marks queries whose buffer
        filled in at least one scan group (judged per group, before the
        merge); ``depth`` is the widest single group's fetch."""
        if source_ids is not None and len(source_ids) == 0:
            return (
                np.full((q.shape[0], 0), -np.inf, np.float32),
                np.full((q.shape[0], 0), -1, np.int64),
                np.zeros(q.shape[0], dtype=bool),
                0,
            )
        groups = self._allowed_arrays(source_ids)
        if len(groups) == 1:
            vals, rows = self._scan(q, k, groups[0], first_sweep=first_sweep)
            full = np.isfinite(vals[:, -1]) if vals.shape[1] else np.zeros(q.shape[0], bool)
            return vals, rows, full, vals.shape[1]
        parts = [self._scan(q, k, g) for g in groups]
        full = np.any([np.isfinite(p[0][:, -1]) for p in parts], axis=0)
        vals = np.concatenate([p[0] for p in parts], axis=1)
        rows = np.concatenate([p[1] for p in parts], axis=1)
        order = np.argsort(-vals, axis=1, kind="stable")
        depth = max(p[0].shape[1] for p in parts)
        return np.take_along_axis(vals, order, 1), np.take_along_axis(rows, order, 1), full, depth

    @staticmethod
    def _underfilled(full: np.ndarray, outs: list, k: int) -> bool:
        """Some query decoded to fewer than k distinct items while its
        candidate buffer was full: only a deeper fetch recovers the rest."""
        return any(len(outs[qi]) < k and full[qi] for qi in range(len(outs)))

    def _search_consistent(self, q: np.ndarray, k: int, source_ids, decode, first=None):
        """Scan + decode with two retry rules: rescan when a row changed
        owner between the sweep and the decode (``reuse_gen`` moved), and
        fetch 4x deeper while chunk dedupe leaves fewer than k items from a
        full buffer.  The last attempt holds the matrix lock throughout.
        ``first`` is an optional (reuse_gen, kb, vals, rows) sweep from
        ``search_fused``, consumed on the first iteration only."""
        m = self.matrix
        fetch = k
        for _ in range(8):
            gen = m.reuse_gen if first is None else first[0]
            vals, rows, full, depth = self._scan_filtered(
                q, fetch, source_ids, first_sweep=None if first is None else first[1:]
            )
            first = None
            outs = decode(vals, rows)
            if m.reuse_gen != gen:
                continue
            if not self._underfilled(full, outs, k):
                return outs
            if depth >= min(m.rows, _OVERFETCH_BUCKETS[-1]):
                return outs
            fetch = min(4 * max(fetch, depth), _OVERFETCH_BUCKETS[-1])
        with m._lock:
            while True:
                vals, rows, full, depth = self._scan_filtered(q, fetch, source_ids)
                outs = decode(vals, rows)
                if not self._underfilled(full, outs, k):
                    return outs
                if depth >= min(m.rows, _OVERFETCH_BUCKETS[-1]):
                    return outs
                fetch = min(4 * max(fetch, depth), _OVERFETCH_BUCKETS[-1])

    def search_vector(self, vec: np.ndarray, k: int, source_ids: Optional[Sequence[int]] = None):
        """One query vector -> [(item_id, score)] best first."""
        if k > MAX_K:
            raise ValueError(f"k={k} exceeds the maximum of {MAX_K}")
        if len(self.matrix) == 0:
            return []
        q = np.asarray(vec, dtype=np.float32).reshape(1, -1)
        return self._search_consistent(
            q, k, source_ids, lambda vals, rows: [self._decode_hits(vals[0], rows[0], k)]
        )[0]

    def search_vectors_batch(self, vecs: np.ndarray, k: int, source_ids: Optional[Sequence[int]] = None):
        """Batched queries: one sweep scores every query."""
        if k > MAX_K:
            raise ValueError(f"k={k} exceeds the maximum of {MAX_K}")
        if len(self.matrix) == 0:
            return [[] for _ in range(len(vecs))]
        q = np.asarray(vecs, dtype=np.float32)
        return self._search_consistent(
            q, k, source_ids,
            lambda vals, rows: [self._decode_hits(vals[qi], rows[qi], k) for qi in range(len(q))],
        )

    def _decode_hits(self, vals, rows, k: int) -> list[tuple[int, float]]:
        """Rows -> (item_id, score) best first; a document's chunk hits
        dedupe to its best chunk.  Stops at the first non-finite score."""
        out: list[tuple[int, float]] = []
        seen: set[int] = set()
        for score, row in zip(vals, rows):
            if not np.isfinite(score) or len(out) >= k:
                break
            key = int(self.matrix.item_ids[row])
            if key < 0:
                continue
            iid = key_item(key)
            if iid in seen:
                continue
            seen.add(iid)
            out.append((iid, float(score)))
        return out

    def search(self, model, query: str, k: int, source_ids: Optional[Sequence[int]] = None):
        """Encode + scan, as two steps."""
        return self.search_vector(model.encode_query(query), k, source_ids)

    # -- fused text query ----------------------------------------------------

    def search_fused(
        self,
        model,
        query: str,
        k: int,
        source_ids: Optional[Sequence[int]] = None,
        *,
        aux_model=None,
    ):
        """Text query -> [(item_id, score)] best first.  The query encode
        (and, with ``aux_model``, its encode by the highlight model) and the
        first sweep are enqueued on one stream with no sync between them;
        one device-to-host copy brings back the query vectors and the sweep.
        At the int8 tier that first sweep is reranked and escalated like any
        other.  Retries (row reuse, dedupe underfill, escalation) re-sweep
        from the query vector.

        With ``aux_model`` returns ``(hits, aux_qvec)``; ``aux_qvec`` is None
        when there can be no hits."""
        if k > MAX_K:
            raise ValueError(f"k={k} exceeds the maximum of {MAX_K}")
        m = self.matrix
        if len(m) == 0 or (source_ids is not None and len(source_ids) == 0):
            return [] if aux_model is None else ([], None)
        if source_ids is not None and len(set(source_ids)) > MAX_SOURCE_FILTER:
            hits = self.search(model, query, k, source_ids)
            if aux_model is None:
                return hits
            return hits, (aux_model.encode_query(query) if hits else None)
        for mdl in (model, aux_model):
            if mdl is not None and mdl.device != m.device:
                raise ValueError(f"model on {mdl.device}, matrix on {m.device}")
        allowed = torch.from_numpy(self._allowed_arrays(source_ids)[0]).to(m.device)
        ids = torch.from_numpy(model.tokenizer.encode_batch_ids([query], pad_batch_to=1)).to(m.device)
        if aux_model is not None:
            aux_ids = torch.from_numpy(
                aux_model.tokenizer.encode_batch_ids([query], pad_batch_to=1)
            ).to(m.device)
        with m._lock:  # capture through launch (a retier takes this lock too)
            gen = m.reuse_gen
            kb = _k_bucket(self._first_fetch(k), m.sweep_rows)
            vectors, src, scales = m.device_view()
            q = model.encode_ids(ids).float()  # (1, dim)
            parts = [q]
            if aux_model is not None:
                parts.append(aux_model.encode_ids(aux_ids).float())
            qp = q if m.padded_dim == m.dim else torch.nn.functional.pad(q, (0, m.padded_dim - m.dim))
            # int8: the query quantizes on the device inside the sweep
            vals, rows = self._sweep(vectors, scales, src, qp, allowed, kb, m.sweep_rows)
        # ONE copy back: query vectors, scores and rows (int32 bits) packed
        flat = torch.cat([p.reshape(-1) for p in parts] + [vals.reshape(-1), rows.view(torch.float32).reshape(-1)])
        host = flat.cpu().numpy()
        qvec = host[: q.numel()].reshape(1, -1)
        off = q.numel()
        aqvec = None
        if aux_model is not None:
            aqvec = host[off : off + parts[1].numel()]
            off += parts[1].numel()
        hvals = host[off : off + kb].reshape(1, kb)
        hrows = host[off + kb : off + 2 * kb].view(np.int32).reshape(1, kb)
        hits = self._search_consistent(
            qvec, k, source_ids,
            lambda vals, rows: [self._decode_hits(vals[0], rows[0], k)],
            first=(gen, kb, hvals, hrows),
        )[0]
        if aux_model is None:
            return hits
        return hits, aqvec

    # -- retrieve --------------------------------------------------------------

    def retrieve(self, db: Database, matches: list[tuple[int, float]]) -> list[SearchResult]:
        if not matches:
            return []
        by_id = {iid: score for iid, score in matches}
        qualified = ", ".join(f"items.{c.strip()}" for c in ITEM_COLUMNS.split(","))
        rows = db.read().execute(
            f"""SELECT {qualified}, sources.name FROM items
                JOIN sources ON sources.id = items.source_id
                WHERE items.id IN (SELECT value FROM json_each(?))
                  AND items.hidden_at IS NULL""",
            (json_ids(by_id.keys()),),
        ).fetchall()
        results = [
            SearchResult(item=deserialize_item_row(r), score=by_id[r[0]], source_name=r[-1])
            for r in rows
        ]
        results.sort(key=lambda r: r.score, reverse=True)
        return results

    def search_and_retrieve(self, db: Database, model, query: str, k: int,
                            source_ids: Optional[Sequence[int]] = None) -> list[SearchResult]:
        return self.retrieve(db, self.search_fused(model, query, k, source_ids))

    def search_vector_and_retrieve(self, db: Database, vec: np.ndarray, k: int,
                                   source_ids: Optional[Sequence[int]] = None) -> list[SearchResult]:
        return self.retrieve(db, self.search_vector(vec, k, source_ids))

    def stored_embedding(self, db: Database, item_id: int) -> Optional[np.ndarray]:
        """An item's stored chunk-0 vector (the ``--like`` search)."""
        row = db.read().execute(
            """SELECT embedding FROM item_embeddings
               WHERE model_id = ? AND model_version = ? AND item_id = ?
                 AND chunk_idx = 0""",
            (self.model_id, self.model_version, item_id),
        ).fetchone()
        return deserialize_embedding(row[0]) if row else None

    def stored_embeddings(self, db: Database, item_id: int) -> list[tuple[int, np.ndarray]]:
        """Every stored (chunk_idx, vector) of an item."""
        rows = db.read().execute(
            f"""SELECT chunk_idx, embedding FROM item_embeddings
               WHERE model_id = ? AND model_version = ? AND item_id = ?
                 AND chunk_idx < {self._CHUNK_STRIDE}
               ORDER BY chunk_idx""",
            (self.model_id, self.model_version, item_id),
        ).fetchall()
        return [(int(r[0]), deserialize_embedding(r[1])) for r in rows]
