"""Searcher: exact top-k query engine over the device matrix (bf16, f32,
int8, int4 and int2 tiers).

Port of perceive_tpu/index/searcher.py's bf16, f32, int8, int4 and int2
paths:

    build()           SELECT every live embedding -> device matrix
    rebuild_source()  drop + reload one source's rows
    search_vector()   q -> top-k (item_id, score), chunk hits deduped
    search_fused()    text -> encode (main + highlight model) -> scan
    retrieve()        join ids back to SQLite rows

Every sweep goes through ``ops.topk`` and ``ops.int2``: the CUDA kernels
for a matrix on a CUDA device (K1/K2 at bf16 and f32, K3/K4 at int8, K9's
flat and slab kernels at int4, by batch width; at int2 K5 -> K6 -> the fine
phase for a single query (K10 -> K6 under the tiletop select, K5 -> glue
under window and threshold: ``matrix.coarse_select``), K7/K8 over the int8
companion, or K9 over the int4 one, for batches and escalations), their
plain versions for one on the CPU.  The bf16 and f32 tiers score exactly as stored, so their sweep
is the answer.  The quantized tiers' scores are approximate: the sweep
over-fetches RERANK_FACTOR times the candidates (RERANK_FACTOR_INT4 where
the candidates are ranked by 4-bit scores), ``_rerank``
rescores them in f32 against the host mirror, and ``_scan`` escalates to a
4x deeper sweep while the k-th exact score does not clear the fetched
floor (at int2 also the coarse floor) plus a 3-sigma quantization-noise
margin; at int2 any escalation leaves the coarse pass for the companion.
Whether the coarse pass serves at all is decided by a self-audit on the
corpus (``audit_coarse``).  Scores are plain dot products (cosine when
the model L2-normalizes).

``build`` starts from the snapshot recorded in ``vector_shards`` where
there is one (``save_snapshot``): a format-v2 base of the matrix's tier is
adopted as stored, any other base streams its f32 rows, and only the
embeddings written since replay from SQLite; without one it loads every
row from SQLite.
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..db import ITEM_COLUMNS, Database, deserialize_item_row, json_ids
from ..ops import int2 as int2_ops
from ..ops import topk
from ..ops.int2 import INT2_COARSE_FETCH
from ..types import Item
from ..utils import dispatchmeter
from .matrix import CHUNK_STRIDE, EmbeddingMatrix, SnapshotDeviceError, chunk_key, deserialize_embedding, key_item

K_BUCKETS = (16, 32, 64, 128, 256, 512, 1024)
MAX_K = K_BUCKETS[-1]
# internal over-fetch (chunk dedupe) may exceed the user-facing MAX_K
_OVERFETCH_BUCKETS = K_BUCKETS + (2048, 4096, 8192)
MAX_SOURCE_FILTER = topk.MAX_FILTER


# quantized sweeps over-fetch candidates by this factor before the f32
# rerank; the escalation loop in _scan re-fetches 4x deeper whenever the
# fetched floor cannot prove the top-k
RERANK_FACTOR = 4
# 4-bit scores are noisier: the int4 tier, and the int2 tier with the int4
# companion, start deeper (the JAX package's factor)
RERANK_FACTOR_INT4 = 8

# Widest query batch the int2 coarse pass serves; wider batches sweep the
# companion (the coarse pass costs a (Q, N) score buffer and a select per
# query).  The JAX package's crossover, measured on its TPU.
_INT2_MAX_Q = 1


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


def _coarse_audit_queries(rows: int = 0, k: int = 10) -> int:
    """Sample size of the int2 coarse self-audit: PERCEIVE_TPU_COARSE_AUDIT
    pins it (0 disables the audit and trusts the coarse pass), else
    clamp(12, k * log2(rows), 384)."""
    env = os.environ.get("PERCEIVE_TPU_COARSE_AUDIT", "")
    if env:
        try:
            return int(env)
        except ValueError:
            pass
    if rows <= 0:
        return 12
    return int(min(384, max(12, round(k * math.log2(rows + 1)))))


def _coarse_audit_min() -> float:
    """Minimum mean top-k overlap (coarse pipeline vs its escalation
    target) for the coarse pass to keep serving
    (PERCEIVE_TPU_COARSE_AUDIT_MIN, default 0.95)."""
    try:
        return float(os.environ.get("PERCEIVE_TPU_COARSE_AUDIT_MIN", "0.95"))
    except ValueError:
        return 0.95


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
        # int2 coarse self-audit state (audit_coarse): the last verdict, the
        # live-row count it ran at (-1 = never), a fresh sampling seed per
        # audit, and per-source live rows at the audit and churn since
        self.coarse_audit: Optional[dict] = None
        self._coarse_audit_rows = -1
        self._audit_seq = 0
        self._src_rows_at_audit: dict[int, int] = {}
        self._src_churn: dict[int, int] = {}
        # retier/audit deferred by maintenance=False hook calls (the ingest
        # write stage: never inside its open SQLite write transaction)
        self._maintenance_due = False

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
    # the replay after a snapshot: the embeddings written since its max seq,
    # found through the seq index (the unary + keeps the planner off the
    # primary key, through which it would read every row of the model to
    # test seq)
    _REPLAY_SQL = f"""
        SELECT items.id, items.source_id, ie.embedding, ie.chunk_idx
        FROM item_embeddings ie JOIN items ON items.id = ie.item_id
        WHERE +ie.model_id = ? AND +ie.model_version = ? AND ie.seq > ?
          AND ie.chunk_idx < {_CHUNK_STRIDE}
          AND items.skipped IS NULL AND items.hidden_at IS NULL
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
        use_snapshot: bool = True,
    ) -> "Searcher":
        """Load every live embedding for (model_id, model_version) and stage
        the device matrix: from the snapshot in ``vector_shards`` plus the
        embeddings written after it (``_load_snapshot``) where there is one
        and ``use_snapshot``, else every BLOB from SQLite."""
        return cls(model_id, model_version, dim, device=device, dtype=dtype)._build_from(db, use_snapshot)

    def _build_from(self, db: Database, use_snapshot: bool) -> "Searcher":
        """``build``'s body on this fresh searcher."""
        dbg = os.environ.get("PERCEIVE_TPU_DEBUG_STARTUP")
        if use_snapshot and self._load_snapshot(db):
            t0 = time.perf_counter()
            self._audit_coarse_if_stale()
            if dbg:
                print(f"build: snapshot path, audit {time.perf_counter() - t0:.1f}s", file=sys.stderr)
            return self
        t0 = time.perf_counter()
        self._load(db, extra_sql="", params=())
        t1 = time.perf_counter()
        self.matrix.sync()
        t2 = time.perf_counter()
        self._audit_coarse_if_stale()
        if dbg:
            print(
                f"build: cold stream+upsert {t1 - t0:.1f}s  device stage {t2 - t1:.1f}s  "
                f"audit {time.perf_counter() - t2:.1f}s",
                file=sys.stderr,
            )
        return self

    # -- snapshots (the vector_shards manifest) ------------------------------

    def save_snapshot(self, db: Database, path: str) -> None:
        """Save the matrix to ``path`` and record (path, max seq) in
        ``vector_shards``."""
        # through the seq index, as the replay (_REPLAY_SQL): through the
        # primary key the max reads every row of the model
        row = db.read().execute(
            "SELECT COALESCE(MAX(seq),0) FROM item_embeddings WHERE +model_id=? AND +model_version=?",
            (self.model_id, self.model_version),
        ).fetchone()
        self.matrix.save_snapshot(path)
        with db.write() as conn:
            conn.execute(
                """INSERT INTO vector_shards
                     (model_id, model_version, path, max_item_id, rows, dim, dtype, created_at)
                   VALUES (?,?,?,?,?,?,?,?)
                   ON CONFLICT (model_id, model_version) DO UPDATE SET
                     path=excluded.path, max_item_id=excluded.max_item_id,
                     rows=excluded.rows, dim=excluded.dim, dtype=excluded.dtype,
                     created_at=excluded.created_at""",
                (
                    self.model_id,
                    self.model_version,
                    str(path),
                    row[0],  # the max seq a later load replays from
                    len(self.matrix),
                    self.matrix.dim,
                    self.matrix.dtype_name,
                    int(time.time()),
                ),
            )

    def _load_snapshot(self, db: Database) -> bool:
        """Load the matrix from the snapshot in ``vector_shards``: adopt a
        base of this tier, else stream its f32 rows; apply its delta; replay
        the embeddings written after its max seq; tombstone the rows hidden
        or removed since; reload the items unhidden since.  False (and an
        empty matrix) when there is no usable snapshot: the caller loads
        from SQLite.  A failure to copy an adopted payload to the device
        raises (SnapshotDeviceError)."""
        manifest = db.read().execute(
            "SELECT path, max_item_id FROM vector_shards WHERE model_id=? AND model_version=?",
            (self.model_id, self.model_version),
        ).fetchone()
        dbg = os.environ.get("PERCEIVE_TPU_DEBUG_STARTUP")
        if manifest is None or not os.path.exists(manifest[0]):
            if dbg and manifest is not None:
                print(f"build: snapshot {manifest[0]} is missing; cold build", file=sys.stderr)
            return False
        path, max_seq = manifest
        t0 = time.perf_counter()
        try:
            # one open handle for every member read: a base replaced by a
            # concurrent save can never contribute a mix of two saves
            with open(path, "rb") as fh:
                z = np.load(fh)
                token = str(z["base_token"]) if "base_token" in getattr(z, "files", []) else None
                adopted = self.matrix._adopt_snapshot_fh(path, fh)
                if not adopted:
                    if int(z["dim"]) != self.matrix.dim:
                        if dbg:
                            print(f"build: snapshot {path} has another dim; cold build", file=sys.stderr)
                        return False
                    item_ids, source_ids = z["item_ids"], z["source_ids"]
                    # the f32 member streams in bounded row chunks into the
                    # matrix, which keeps its device
                    for lo, hi, vecs in self.matrix._iter_snapshot_vectors(path, self.matrix._LOAD_CHUNK_ROWS, fh):
                        live = source_ids[lo:hi] >= 0
                        if not live.any():
                            continue
                        self.matrix.upsert(
                            item_ids[lo:hi][live].tolist(),
                            source_ids[lo:hi][live].tolist(),
                            vecs[live] if not live.all() else vecs,
                        )
            # the loaded state is what the base restores: the delta tracking
            # restarts here, and the delta and replay below mark their rows
            # through upsert and remove
            with self.matrix._lock:
                self.matrix._delta_rows = set()
                self.matrix._delta_removed = set()
            if self.matrix.apply_snapshot_delta(path, token) < 0:
                # an unusable delta: the manifest's max_seq moved past its
                # rows, so only a rebuild from SQLite recovers them
                self.matrix.clear()
                if dbg:
                    print(f"build: snapshot delta {path}.delta is unusable; cold build", file=sys.stderr)
                return False
        except SnapshotDeviceError:
            raise
        except Exception as e:  # noqa: BLE001 — a corrupt snapshot: rebuild from SQLite
            self.matrix.clear()
            if dbg:
                print(f"build: snapshot {path} unreadable ({type(e).__name__}: {e}); cold build", file=sys.stderr)
            return False
        t1 = time.perf_counter()
        replayed = self._load(db, "", (max_seq,), sql=self._REPLAY_SQL)
        t2 = time.perf_counter()
        # tombstone the rows hidden, skipped or deleted since the snapshot:
        # an ids-only scan, no BLOB decoding
        cur = db.read().execute(
            f"""SELECT items.id * {self._CHUNK_STRIDE} + ie.chunk_idx FROM items
               JOIN item_embeddings ie ON ie.item_id = items.id
                 AND ie.model_id = ? AND ie.model_version = ?
                 AND ie.chunk_idx < {self._CHUNK_STRIDE}
               WHERE items.skipped IS NULL AND items.hidden_at IS NULL""",
            (self.model_id, self.model_version),
        )
        live = np.fromiter((r[0] for r in cur), dtype=np.int64)
        with self.matrix._lock:
            held = np.fromiter(self.matrix.row_of, dtype=np.int64, count=len(self.matrix.row_of))
        dead = held[~np.isin(held, live)]
        if len(dead):
            self.matrix.remove(dead.tolist())
        # ... and load the live keys the replay missed: unhiding clears
        # hidden_at without bumping item_embeddings.seq, so an item hidden
        # before the save and unhidden after it is invisible to the replay
        missing_items = np.unique(live[~np.isin(live, held)] // CHUNK_STRIDE).tolist()
        for lo in range(0, len(missing_items), 500):
            batch = missing_items[lo : lo + 500]
            ph = ",".join("?" * len(batch))
            replayed += self._load(db, f" AND items.id IN ({ph})", tuple(batch))
        t3 = time.perf_counter()
        self.matrix.sync()
        if dbg:
            print(
                f"build: snapshot {'adopted' if adopted else 'streamed'} {t1 - t0:.1f}s  replay {replayed} rows "
                f"{t2 - t1:.1f}s  reconcile ({len(dead)} dead, {len(missing_items)} unhidden) {t3 - t2:.1f}s  "
                f"device stage {time.perf_counter() - t3:.1f}s",
                file=sys.stderr,
            )
        return True

    # rows per chunk when streaming embeddings out of SQLite
    _LOAD_DB_CHUNK_ROWS = 262_144

    def _load(self, db: Database, extra_sql: str, params: tuple, sql: Optional[str] = None) -> int:
        cur = db.read().execute(
            (sql or self._BUILD_SQL) + extra_sql, (self.model_id, self.model_version, *params)
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
        self._coarse_audit_rows = -1  # the corpus's composition changed: audit afresh
        self._audit_coarse_if_stale()
        return n

    # -- incremental updates -------------------------------------------------

    def upsert_embeddings(
        self,
        item_ids: Sequence,
        source_ids: Sequence[int],
        vectors: np.ndarray,
        *,
        maintenance: bool = True,
    ) -> None:
        """Stream vectors into the matrix.  ``item_ids`` entries are item ids
        (chunk 0) or (item_id, chunk_idx) pairs; chunk keys an item no longer
        has are tombstoned.

        ``maintenance=False`` defers the retier/coarse-audit pass to a later
        :meth:`run_deferred_maintenance`: the ingest write stage calls this
        hook inside its open SQLite write transaction, and a retier restages
        the whole matrix and an audit runs many sweeps, neither of which may
        hold the write lock."""
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
        self._note_src_churn(source_ids)
        if maintenance:
            self._maybe_retier()
            self._audit_coarse_if_stale()
        else:
            self._maintenance_due = True

    def run_deferred_maintenance(self) -> None:
        """Run the retier/audit pass deferred by ``maintenance=False`` hook
        calls.  Idempotent; the ingest write stage calls it after each
        batch's transaction commits."""
        if self._maintenance_due:
            self._maintenance_due = False
            self._maybe_retier()
            self._audit_coarse_if_stale()

    def pipeline_hooks(self):
        """(on_embeddings, on_removed) for the ingest write stage: as
        upsert_embeddings/remove_items, with the retier/audit deferred to an
        ``after_commit`` attribute that the write stage invokes once the
        batch's SQLite transaction has committed."""

        def on_embeddings(item_ids, source_ids, vectors):
            self.upsert_embeddings(item_ids, source_ids, vectors, maintenance=False)

        def on_removed(item_ids):
            self.remove_items(item_ids, maintenance=False)

        on_embeddings.after_commit = self.run_deferred_maintenance
        on_removed.after_commit = self.run_deferred_maintenance
        return on_embeddings, on_removed

    def remove_items(self, item_ids: Sequence[int], *, maintenance: bool = True) -> int:
        """Tombstone every chunk of each item.  ``maintenance=False`` defers
        the audit as in :meth:`upsert_embeddings`."""
        m = self.matrix
        keys = [k for iid in item_ids for k in m.keys_of_group(int(iid))]
        if keys:  # per-source churn, read before the tombstones wipe the ids
            with m._lock:
                self._note_src_churn([int(m.source_ids[m.row_of[k]]) for k in keys if k in m.row_of])
        n = m.remove(keys)
        if n:
            if maintenance:
                self._audit_coarse_if_stale()
            else:
                self._maintenance_due = True
        return n

    def _tier_for(self, n_rows: int):
        """The auto tier of ``n_rows`` rows (``auto_matrix_dtype``; the
        sharded searcher keys it on one shard's rows)."""
        from .matrix import auto_matrix_dtype

        return auto_matrix_dtype(n_rows, self.matrix.padded_dim)

    def _maybe_retier(self) -> None:
        """Follow the auto tier rule as the corpus grows or shrinks (bf16,
        int8, int2, int4).  A new tier is audited afresh."""
        if not self.auto_retier:
            return
        before = self.matrix.dtype
        self.matrix.retier(self._tier_for(len(self.matrix)))
        if self.matrix.dtype is not before:
            self._coarse_audit_rows = -1

    # -- int2 coarse self-audit ------------------------------------------------

    # demote when any single sampled query's overlap falls below this, even
    # if the mean clears the gate (the JAX package's calibration)
    _COARSE_AUDIT_MIN_SINGLE = 0.75
    # re-audit when the corpus grew or shrank this much since the last audit
    _COARSE_AUDIT_GROWTH = 1.25
    # audit chunk widths: reference sweeps of the companion, and coarse
    # passes (each holds a (Q, N) f32 score buffer on the device)
    _AUDIT_REF_BATCH = 32
    _AUDIT_COARSE_BATCH = 8
    # a source must churn at least this many rows to trigger a re-audit
    _SRC_CHURN_MIN = 256
    # adaptive coarse-depth ladder, and its rule: the depth covers the
    # quantile of per-query worst sampled displacements with 2x headroom
    _COARSE_FETCH_LADDER = (1024, 2048)
    _COARSE_FETCH_MARGIN = 2.0
    _COARSE_FETCH_QUANTILE = 0.98

    def _audit_coarse_if_stale(self) -> None:
        """Audit the coarse pass if the int2 tier was never audited, the
        corpus grew or shrank by _COARSE_AUDIT_GROWTH, or one source turned
        over; off the int2 tier, drop the last verdict."""
        if not self.matrix.packed2:
            self.coarse_audit = None
            self._coarse_audit_rows = -1
            return
        rows = len(self.matrix)
        if rows == 0:
            return
        prev = self._coarse_audit_rows
        if (
            prev < 0
            or rows >= self._COARSE_AUDIT_GROWTH * max(prev, 1)
            or rows * self._COARSE_AUDIT_GROWTH <= prev
            or self._src_composition_shifted()
        ):
            self.audit_coarse()

    def _src_composition_shifted(self) -> bool:
        """Some single source's churn since the last audit exceeds both the
        growth band of its size then and _SRC_CHURN_MIN."""
        if self._coarse_audit_rows < 0 or not self._src_churn:
            return False
        grow = self._COARSE_AUDIT_GROWTH - 1.0
        return any(
            churn >= max(self._SRC_CHURN_MIN, grow * max(self._src_rows_at_audit.get(sid, 0), 1))
            for sid, churn in self._src_churn.items()
        )

    def _note_src_churn(self, source_ids) -> None:
        """Tally per-source churn (upserts and removals alike)."""
        ids, counts = np.unique(np.asarray(list(source_ids), dtype=np.int64), return_counts=True)
        for sid, c in zip(ids.tolist(), counts.tolist()):
            if sid >= 0:
                self._src_churn[sid] = self._src_churn.get(sid, 0) + c

    def _audit_rank_counts(self, q1: np.ndarray, rows: np.ndarray) -> np.ndarray:
        """(B, k) 1-based coarse-score ranks of the reference ``rows`` (B, k)
        (-1 = empty slot, counts 0) for the (B, D) padded queries ``q1``:
        how many rows score at least as high under K5."""
        m = self.matrix
        with m._lock:
            (packed2, _), source_ids, (scales2, _) = m.device_view()
            ns = m.sweep_rows
            allowed = torch.from_numpy(self._allowed_arrays(None)[0]).to(m.device)
            qi8, qscale = topk.quantize_queries(torch.from_numpy(q1).to(m.device))
            coarse = int2_ops.int2_scores(packed2, scales2, source_ids, qi8, qscale, allowed, ns)
        r = torch.from_numpy(rows).to(m.device).long()
        thr = torch.gather(coarse, 1, r.clamp(0, ns - 1)).masked_fill(r < 0, float("inf"))
        counts = torch.stack([(coarse >= thr[:, j : j + 1]).sum(dim=1) for j in range(r.shape[1])], dim=1)
        return counts.masked_fill(r < 0, 0).cpu().numpy()

    def _pick_coarse_fetch(self, kb: int, rank_maxes) -> int:
        """Adaptive coarse depth: the shallowest ladder entry with MARGIN
        headroom over the QUANTILE of per-query worst displacements and at
        least 2 * kb; 0 (INT2_COARSE_FETCH) when none clears it.
        PERCEIVE_TPU_COARSE_FETCH pins it.  Rows past the depth stay bounded
        by the coarse floor and escalate as at the default depth."""
        env = os.environ.get("PERCEIVE_TPU_COARSE_FETCH", "")
        if env:
            try:
                return max(int(env), 0)
            except ValueError:
                pass
        if not rank_maxes:
            return 0
        need = self._COARSE_FETCH_MARGIN * float(np.quantile(np.asarray(rank_maxes), self._COARSE_FETCH_QUANTILE))
        for f in self._COARSE_FETCH_LADDER:
            if f >= INT2_COARSE_FETCH or f >= self.matrix.sweep_rows:
                break
            if f >= 2 * kb and f >= need:
                return f
        return 0

    @staticmethod
    def _stratified_sample(rng, live, live_src, src_ids, src_counts, n_q: int, kc: int) -> np.ndarray:
        """Audit sample: per-source allocation proportional to live rows
        (largest remainder), at least one sample for every source of
        max(64, kc / 4) live rows or more."""
        if len(src_ids) <= 1:
            return rng.choice(live, size=min(n_q, len(live)), replace=False)
        quota = src_counts * (n_q / int(src_counts.sum()))
        alloc = np.floor(quota).astype(np.int64)
        rem = n_q - int(alloc.sum())
        if rem > 0:
            order = np.argsort(-(quota - alloc), kind="stable")
            alloc[order[:rem]] += 1
        alloc = np.where((src_counts >= max(64, kc // 4)) & (alloc == 0), 1, alloc)
        alloc = np.minimum(alloc, src_counts)
        by_src = live[np.argsort(live_src[live], kind="stable")]
        offs = np.concatenate([[0], np.cumsum(src_counts)])
        picks = [rng.choice(by_src[offs[i] : offs[i + 1]], size=int(take), replace=False)
                 for i, take in enumerate(alloc) if take > 0]
        return np.concatenate(picks) if picks else live[:0]

    def audit_coarse(self, max_queries: int = 0, k: int = 10) -> Optional[float]:
        """Decide whether the int2 coarse pass may serve queries on THIS
        corpus (the JAX package's self-audit).  Stored vectors, sampled by
        source, are the queries: on corpora whose score ties are denser than
        the 2-bit grid can rank, the coarse pass keeps an arbitrary subset
        of the tie bulk, and no escalation margin sees it.

          phase 1   the reference top-k of each sample: the companion
                    sweep at 4x the first fetch, reranked in f32; and the
                    coarse-score rank of each reference row (K5);
          phase 2a  the adaptive coarse depth from those ranks;
          phase 2b  the coarse select back to "exact": the JAX audit sets
                    "approx" or "exact" here from its approximate select's
                    bin-collision risk, and both run the exact select in
                    the port, so a pinned select (tiletop, window,
                    threshold) does not outlive an audit, as in JAX;
          phase 3   the mean and the worst top-k overlap of the production
                    coarse pipeline with the references; a flunk at a
                    shallowed depth is re-measured at the default depth.

        Sets ``matrix.coarse_trusted`` (False routes every query to the
        companion), ``matrix.coarse_fetch`` and ``matrix.coarse_select``.
        The JAX audit's approx -> exact retry has no counterpart: the
        port's "approx" is the exact select.  Returns the mean overlap, or
        None when not applicable or disabled (PERCEIVE_TPU_COARSE_AUDIT=0)."""
        m = self.matrix
        if not m.packed2 or len(m) == 0:
            return None
        with m._lock:
            live_src = m.source_ids[: m.rows]
            live = np.flatnonzero(live_src >= 0)
            src_ids, src_counts = (
                np.unique(live_src[live], return_counts=True)
                if len(live) else (np.empty(0, np.int64), np.empty(0, np.int64))
            )
        n_q = max_queries or _coarse_audit_queries(len(live), k)
        if n_q <= 0:  # disabled: trust unconditionally
            m.coarse_trusted = True
            self._coarse_audit_rows = len(m)
            self._src_rows_at_audit = dict(zip(src_ids.tolist(), src_counts.tolist()))
            self._src_churn.clear()
            return None
        if len(live) == 0:
            return None
        self._audit_seq += 1
        with m._lock:
            rng = np.random.default_rng(0xC0A005E + self._audit_seq)
            sample = np.sort(self._stratified_sample(
                rng, live, live_src, src_ids, src_counts, n_q, min(INT2_COARSE_FETCH, max(m.sweep_rows, 1))))
            vecs = m.host_vectors_for(sample)
        vecs = (vecs / np.maximum(np.linalg.norm(vecs, axis=1, keepdims=True), 1e-12)).astype(np.float32)
        qp = self._pad_queries(vecs)
        allowed = self._allowed_arrays(None)[0]
        kb = _k_bucket(self._first_fetch(k), m.sweep_rows)
        kb_ref = _k_bucket(4 * kb, m.sweep_rows)

        def chunks(width: int):  # zero-padded to a fixed width
            for lo in range(0, len(qp), width):
                hi = min(lo + width, len(qp))
                cq = qp[lo:hi]
                if hi - lo < width:
                    cq = np.concatenate([cq, np.zeros((width - (hi - lo), qp.shape[1]), qp.dtype)])
                yield lo, hi, cq

        # phase 1: references, then their coarse ranks
        refs: list[list[int]] = []
        for lo, hi, cq in chunks(self._AUDIT_REF_BATCH):
            rvals, rrows, _ = self._device_scan(cq, kb_ref, allowed, use_coarse=False)
            _, rr = self._rerank(vecs[lo:hi], rvals[: hi - lo], rrows[: hi - lo])
            refs.extend([r for r in rr[j][:k].tolist() if r >= 0] for j in range(hi - lo))
        rank_maxes: list[float] = []
        if min(INT2_COARSE_FETCH, max(m.sweep_rows, 1)) < m.sweep_rows:
            idxs = [i for i, ref in enumerate(refs) if ref]
            b = self._AUDIT_COARSE_BATCH
            for lo in range(0, len(idxs), b):
                batch = idxs[lo : lo + b]
                qb = np.zeros((b, qp.shape[1]), qp.dtype)
                qb[: len(batch)] = qp[batch]
                rows_b = np.full((b, k), -1, np.int32)
                for j, i in enumerate(batch):
                    rows_b[j, : len(refs[i])] = refs[i]
                counts = self._audit_rank_counts(qb, rows_b)
                rank_maxes += [float(np.max(counts[j][: len(refs[i])])) for j, i in enumerate(batch)]
        # phase 2a: the adaptive depth; phase 2b: the select
        fetch = self._pick_coarse_fetch(kb, rank_maxes)
        with m._lock:
            changed = fetch != m.coarse_fetch or m.coarse_select != "exact"
            if changed:
                m.coarse_fetch, m.coarse_select = fetch, "exact"
                m.mutation_gen += 1
        if changed:
            print(f"int2 coarse self-audit: select=exact fetch={fetch or 'default'} (reference coarse rank max "
                  f"{max(rank_maxes) if rank_maxes else float('nan'):.0f})", file=sys.stderr)

        # phase 3: end overlap of the production coarse pipeline
        def end_overlap():
            total, worst = 0.0, 1.0
            for lo, hi, cq in chunks(self._AUDIT_COARSE_BATCH):
                cvals, crows, _ = self._device_scan(cq, kb, allowed, use_coarse=True, force_coarse=True)
                _, cr = self._rerank(vecs[lo:hi], cvals[: hi - lo], crows[: hi - lo])
                for j in range(hi - lo):
                    ref = refs[lo + j]
                    if ref:
                        o = len(set(ref) & set(cr[j][: len(ref)].tolist())) / len(ref)
                        total += o
                        worst = min(worst, o)
            return total / len(qp), worst

        def passes(overlap, worst):
            return overlap >= _coarse_audit_min() and worst >= self._COARSE_AUDIT_MIN_SINGLE

        overlap, min_overlap = end_overlap()
        trusted = passes(overlap, min_overlap)
        if not trusted and m.coarse_fetch:
            # a flunk at a shallowed depth may be the depth's fault
            with m._lock:
                m.coarse_fetch = 0
                m.mutation_gen += 1
            overlap, min_overlap = end_overlap()
            trusted = passes(overlap, min_overlap)
        with m._lock:
            demoted = m.coarse_trusted and not trusted
            if trusted != m.coarse_trusted:
                m.coarse_trusted = trusted
                m.mutation_gen += 1  # cached results of the other route go stale
        self.coarse_audit = {
            "overlap": round(float(overlap), 6), "min_overlap": round(float(min_overlap), 6),
            "queries": int(len(qp)), "k": int(k), "trusted": trusted, "rows": len(m),
            "select": m.coarse_select, "fetch": int(m.coarse_fetch), "strata": int(len(src_ids)),
        }
        self._coarse_audit_rows = len(m)
        self._src_rows_at_audit = dict(zip(src_ids.tolist(), src_counts.tolist()))
        self._src_churn.clear()
        if demoted:
            print(f"int2 coarse self-audit: top-{k} overlap mean {overlap:.4f} / min {min_overlap:.4f} "
                  f"(gates {_coarse_audit_min():.2f} / {self._COARSE_AUDIT_MIN_SINGLE:.2f}) on {len(qp)} "
                  f"sampled corpus vectors: queries go to the int{m.fine_bits} companion sweep",
                  file=sys.stderr)
        return overlap

    # -- query ---------------------------------------------------------------

    def _sweep(self, vectors, scales, source_ids, q, allowed, kb: int, n_sweep: int, use_coarse: bool = False):
        """The tier's sweep on device tensors (from ``device_view``) ->
        ((Q, kb) scores, rows, (Q,) coarse floor or None).  At int2,
        ``use_coarse`` runs the coarse-to-fine scan, else the sweep of the
        companion, by its width (int8: K7/K8, packed int4: K9)."""
        if self.matrix.packed2:
            (packed2, fine), (scales2, fscales) = vectors, scales
            if use_coarse:
                return int2_ops.scan_int2_coarse_fine(packed2, scales2, fine, fscales, source_ids, q, allowed,
                                                      kb, n_sweep=n_sweep, fetch=self.matrix.coarse_fetch,
                                                      select=self.matrix.coarse_select)
            scan = topk.scan_topk_int8t if fine.dtype == torch.int8 else topk.scan_topk_int4
            return (*scan(fine, fscales, source_ids, q, allowed, kb, n_sweep), None)
        if self.matrix.packed4:
            return (*topk.scan_topk_int4(vectors, scales, source_ids, q, allowed, kb, n_sweep), None)
        if scales is not None:
            return (*topk.scan_topk_int8(vectors, scales, source_ids, q, allowed, kb, n_sweep), None)
        return (*topk.scan_topk(vectors, source_ids, q, allowed, kb, n_sweep), None)

    def _device_scan(self, qp: np.ndarray, kb: int, allowed: np.ndarray,
                     use_coarse: bool = True, force_coarse: bool = False):
        """One sweep -> ((Q, kb) scores, (Q, kb) rows, (Q,) coarse floor or
        None) on the host (quantized tiers: approximate scores; _scan
        reranks).  At int2 the coarse pass serves batches of up to
        _INT2_MAX_Q queries while ``use_coarse``; ``force_coarse`` (the
        self-audit only) keeps it at any width.  Capture and launch happen
        under the matrix lock; the copy back outside it."""
        m = self.matrix
        with m._lock:
            vectors, source_ids, scales = m.device_view()
            coarse = m.packed2 and use_coarse and (qp.shape[0] <= _INT2_MAX_Q or force_coarse)
            vals, rows, floor = self._sweep(
                vectors, scales, source_ids,
                torch.from_numpy(np.ascontiguousarray(qp)).to(m.device),
                torch.from_numpy(allowed).to(m.device), kb, m.sweep_rows, coarse,
            )
        dispatchmeter.count("sweep")
        return vals.cpu().numpy(), rows.cpu().numpy(), None if floor is None else floor.cpu().numpy()

    def _coarse_pays(self, kb: int) -> bool:
        """The int2 depth rule: once a sweep fetches half the coarse depth,
        the coarse pass stops paying and the companion is swept directly."""
        return 2 * kb <= (self.matrix.coarse_fetch or INT2_COARSE_FETCH)

    def _first_fetch(self, k: int) -> int:
        """Candidate depth of the first sweep for a user-facing k: times
        RERANK_FACTOR at a quantized tier whose candidates are ranked by
        8-bit scores (int8, int2 with the int8 companion), RERANK_FACTOR_INT4
        where they are ranked by 4-bit or coarser ones (int4, int2 with the
        int4 companion); doubled while any document is chunk-embedded
        (dedupe needs extra).  The one formula shared by _scan and
        search_fused."""
        m = self.matrix
        want = k
        if m.quantized:
            bits = 8 if m.packed2 and m.fine_bits == 8 else m.quant_bits
            want = (RERANK_FACTOR_INT4 if bits <= 4 else RERANK_FACTOR) * k
        return 2 * want if m.multi_chunk_groups > 0 else want

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
        # the self-audit's verdict holds for every query, not escalations only
        use_coarse = m.coarse_trusted
        while True:
            kb = _k_bucket(want, m.sweep_rows)
            if m.packed2 and not self._coarse_pays(kb):
                use_coarse = False
            if first_sweep is not None and first_sweep[0] == kb:
                vals, rows = first_sweep[1], first_sweep[2]  # the fused sweep
                floor = first_sweep[3] if len(first_sweep) > 3 else None
            else:
                vals, rows, floor = self._device_scan(qp, kb, allowed, use_coarse)
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
            trigger = buffer_full & (kth < vals[:, -1] + margin)
            if floor is not None:  # int2: rows outside the coarse candidates
                trigger |= np.isfinite(floor) & (kth < floor + margin)
            if not trigger.any():
                return evals[:q0], erows[:q0]
            self.escalations += 1
            use_coarse = False  # int2: re-fetch from the companion, never a deeper coarse pass
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
        ``first`` is an optional (reuse_gen, kb, vals, rows, floor) sweep from
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
        one device-to-host copy brings back the query vectors and the sweep
        (at int2 with its coarse floor).  At the quantized tiers that first
        sweep is reranked and escalated like any other.  Retries (row reuse, dedupe underfill, escalation) re-sweep
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
            use_coarse = m.coarse_trusted and (not m.packed2 or self._coarse_pays(kb))
            vectors, src, scales = m.device_view()
            q = model.encode_ids(ids).float()  # (1, dim)
            parts = [q]
            if aux_model is not None:
                parts.append(aux_model.encode_ids(aux_ids).float())
            qp = q if m.padded_dim == m.dim else torch.nn.functional.pad(q, (0, m.padded_dim - m.dim))
            # quantized tiers: the query quantizes on the device inside the sweep
            vals, rows, floor = self._sweep(vectors, scales, src, qp, allowed, kb, m.sweep_rows, use_coarse)
        dispatchmeter.count("fused")
        # ONE copy back: query vectors, scores, rows (int32 bits) and the
        # int2 coarse floor, packed
        tail = [] if floor is None else [floor]
        flat = torch.cat([p.reshape(-1) for p in parts + [vals, rows.view(torch.float32)] + tail])
        host = flat.cpu().numpy()
        qvec = host[: q.numel()].reshape(1, -1)
        off = q.numel()
        aqvec = None
        if aux_model is not None:
            aqvec = host[off : off + parts[1].numel()]
            off += parts[1].numel()
        hvals = host[off : off + kb].reshape(1, kb)
        hrows = host[off + kb : off + 2 * kb].view(np.int32).reshape(1, kb)
        hfloor = None if floor is None else host[off + 2 * kb : off + 2 * kb + 1]
        hits = self._search_consistent(
            qvec, k, source_ids,
            lambda vals, rows: [self._decode_hits(vals[0], rows[0], k)],
            first=(gen, kb, hvals, hrows, hfloor),
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
