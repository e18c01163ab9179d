"""Sharded exact-scan query engine: per-shard top-k, merged on the lead slot.

Port of perceive_tpu/parallel/search.py.  The embedding matrix is
row-sharded over every slot of the mesh (``ShardedEmbeddingMatrix``); each
shard runs its tier's hand-written kernels over its own rows only (K1/K2,
K3/K4, K9, K7/K8, or the int2 tier's whole coarse-to-fine pipeline), and
the per-shard (Q, kl) candidates are copied to the lead slot and merged
there, where JAX runs one ``all_gather`` and a small top-k inside its
``shard_map`` program.  Every shard's launches are enqueued before any copy
leaves a device, so the shards run side by side on their devices.

``ShardedSearcher`` subclasses ``index.Searcher``: build, snapshots, the
rerank and escalation, the self-audit, chunk dedupe, the fused text query,
the executor's drains and retrieve are all inherited; only the matrix
placement, the sweep (``_sweep``), the auto tier's key and the audit's rank
counts differ.
"""

from __future__ import annotations

import numpy as np
import torch

from ..index.matrix import ShardedEmbeddingMatrix
from ..index.searcher import Searcher
from ..ops import int2 as int2_ops
from ..ops import topk
from .mesh import Mesh, device_scope, replicated


def _merge_local_candidates(vals: list, rows: list, *, k: int, n_local: int, lead: torch.device):
    """The merge tail of every sharded sweep (the JAX package's
    ``_merge_local_candidates``): each shard's (Q, kl) rows globalized as
    ``row + shard * n_local`` (-1 slots kept), non-finite scores made -inf,
    the candidates copied to the lead slot and the best k kept by the
    port's key (score, then the lower row: ``topk._merge_topk``), padded
    with (-inf, -1) to k."""
    vs, rs = [], []
    for s, (v, r) in enumerate(zip(vals, rows)):
        v, r = v.to(lead, non_blocking=True), r.to(lead, non_blocking=True)
        rs.append(torch.where(r >= 0, r + s * n_local, -1).to(torch.int32))
        vs.append(torch.where(torch.isfinite(v), v, float("-inf")))
    vcat, rcat = torch.cat(vs, dim=1), torch.cat(rs, dim=1)
    kk = min(k, vcat.shape[1])
    mv, out = topk._merge_topk(vcat, rcat, kk)
    if kk < k:  # k past the global row count
        mv = torch.nn.functional.pad(mv, (0, k - kk), value=float("-inf"))
        out = torch.nn.functional.pad(out, (0, k - kk), value=-1)
    return mv, out


def _sweep_shards(mesh: Mesh, sweep, q: torch.Tensor, allowed: torch.Tensor, k: int, n_local: int):
    """``sweep(shard, q, allowed, kl) -> (vals, rows[, floor])`` enqueued on
    every shard (q and the filter copied once to each distinct device),
    then the merge on the lead slot -> ((Q, k) scores, (Q, k) int32 global
    rows, (Q,) floor or None).  The int2 floors max-merge: a row outside
    every shard's coarse candidates scores at most its own shard's floor,
    so a min would under-bound the rows of the max shard."""
    lead = mesh.lead
    kl = min(k, n_local)  # an over-fetch may exceed one shard's rows
    qs, allows = replicated(q, mesh), replicated(allowed, mesh)
    outs = []
    for s, dev in enumerate(mesh.flat):
        with device_scope(dev):
            outs.append(sweep(s, qs[dev], allows[dev], kl))
    vals, rows = _merge_local_candidates([o[0] for o in outs], [o[1] for o in outs], k=k, n_local=n_local,
                                         lead=lead)
    floors = [o[2] for o in outs if len(o) > 2 and o[2] is not None]
    floor = torch.stack([f.to(lead, non_blocking=True) for f in floors]).amax(dim=0) if floors else None
    return vals, rows, floor


def _tier_scan(vectors, scales, source_ids, q, allowed, k: int):
    """One shard's sweep by its matrix's type: packed int4 (D/2, N) -> K9,
    int8 (N, D) -> K3/K4, bf16/f32 (N, D) -> K1/K2."""
    if vectors.dtype == torch.uint8:
        return topk.scan_topk_int4(vectors, scales, source_ids, q, allowed, k)
    if vectors.dtype == torch.int8:
        return topk.scan_topk_int8(vectors, scales, source_ids, q, allowed, k)
    return topk.scan_topk(vectors, source_ids, q, allowed, k)


def sharded_scan_topk(mesh: Mesh, matrix: list, source_ids: list, q, allowed, k: int, scales=None):
    """Exact top-k over a row-sharded matrix.

    matrix, source_ids and scales: per-slot lists (``mesh.rows_sharding``;
    the packed int4 tier splits its columns); q: (Q, D) f32 and allowed:
    (F,) int32 on the lead slot; scales are required for the quantized
    matrices.  Returns ((Q, k) scores best first, (Q, k) int32 global
    rows) on the lead slot."""
    quantized = matrix[0].dtype in (torch.int8, torch.uint8)
    if quantized and scales is None:
        # zero scales would score every row 0 and return the first k rows
        raise ValueError("scales are required for quantized matrices")
    n_local = source_ids[0].shape[0]

    def sweep(s, q_, a_, kl):
        return _tier_scan(matrix[s], None if scales is None else scales[s], source_ids[s], q_, a_, kl)

    return _sweep_shards(mesh, sweep, q, allowed, k, n_local)[:2]


def _shard(x, s: int):
    """Shard ``s`` of a ``device_view`` member: a per-shard list, a tuple of
    them (the int2 tier's pairs), or None."""
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(_shard(p, s) for p in x)
    return x[s]


class ShardedSearcher(Searcher):
    """Mesh-wide Searcher: the API and semantics of ``index.Searcher``, with
    the matrix row-sharded over every slot of ``mesh`` (capacity a multiple
    of 512 * mesh.size, so each shard's rows stay tile-aligned).

    The sweep ignores ``n_sweep``, as JAX's mesh sweep does: rows are
    block-sharded and allocated in order, so once the corpus outgrows one
    shard the fullest shard is at capacity and sets the latency.  The JAX
    ``_approx_bins`` (the approximate select's bin count for the audit's
    risk estimate) has no counterpart: the port's int2 select is exact
    (ROADMAP.md §3)."""

    def __init__(self, model_id: int, model_version: int, dim: int, mesh: Mesh, *, dtype=torch.bfloat16):
        matrix = ShardedEmbeddingMatrix(dim, devices=mesh.flat, dtype=dtype)
        super().__init__(model_id, model_version, dim, device=mesh.lead, dtype=dtype, matrix=matrix)
        self.mesh = mesh

    @classmethod
    def build(cls, db, model_id: int, model_version: int, dim: int, mesh: Mesh, *,  # type: ignore[override]
              dtype=torch.bfloat16, use_snapshot: bool = True) -> "ShardedSearcher":
        """``Searcher.build`` onto the mesh: a snapshot of any shard count (or
        of the one-device matrix, or of the JAX package) adopts or streams
        here, else every row loads from SQLite."""
        return cls(model_id, model_version, dim, mesh, dtype=dtype)._build_from(db, use_snapshot)

    @staticmethod
    def auto_tier(n_rows: int, mesh: Mesh, padded_dim: int = 384):
        """The auto tier keyed on ONE SHARD's rows: every threshold of
        ``auto_matrix_dtype`` is a per-device concern (a sweep's latency, a
        device's memory).  The one rule of AppState's startup choice and of
        ``_maybe_retier``, so a boot never restages on its first retier."""
        from ..index import matrix as matrix_mod

        return matrix_mod.auto_matrix_dtype(-(-max(n_rows, 0) // mesh.size), padded_dim)

    def _tier_for(self, n_rows: int):
        return self.auto_tier(n_rows, self.mesh, self.matrix.padded_dim)

    def _sweep(self, vectors, scales, source_ids, q, allowed, kb: int, n_sweep: int, use_coarse: bool = False):
        """The tier's sweep on every shard (``Searcher._sweep`` over the
        shard's tensors, at kl = min(kb, n_local), over the whole shard),
        merged on the lead slot.  At int2 with ``use_coarse`` each shard runs
        the whole coarse-to-fine pipeline at its own depth and tiletop
        geometry, and the floors max-merge."""
        one = super()._sweep
        m = self.matrix

        def sweep(s, q_, a_, kl):
            return one(_shard(vectors, s), _shard(scales, s), source_ids[s], q_, a_, kl, 0, use_coarse)

        return _sweep_shards(self.mesh, sweep, q, allowed, kb, m.n_local)

    def _audit_rank_counts(self, q1: np.ndarray, rows: np.ndarray) -> np.ndarray:
        """Global coarse-score ranks (the JAX package's shard_map psum): the
        threshold of each reference row from the shard that owns it, the
        counts of rows scoring at least that summed over every shard."""
        m = self.matrix
        nl, lead = m.n_local, m.device
        with m._lock:
            (packed2, _), source_ids, (scales2, _) = m.device_view()
            allowed = torch.from_numpy(self._allowed_arrays(None)[0]).to(lead)
            q = torch.from_numpy(q1).to(lead)
            r = torch.from_numpy(rows).to(lead).long()
            coarse = []
            for s, dev in enumerate(m.devices):
                with device_scope(dev):
                    qi8, qscale = topk.quantize_queries(q.to(dev))
                    coarse.append(int2_ops.int2_scores(packed2[s], scales2[s], source_ids[s], qi8, qscale,
                                                       allowed.to(dev)))
        thr = torch.zeros(r.shape, dtype=torch.float32, device=lead)
        for s, c in enumerate(coarse):
            loc = r - s * nl
            own = (loc >= 0) & (loc < nl) & (r >= 0)
            got = torch.gather(c, 1, loc.clamp(0, nl - 1).to(c.device)).to(lead)
            thr += torch.where(own, got, 0.0)  # one shard contributes
        counts = torch.zeros(r.shape, dtype=torch.int64, device=lead)
        for c in coarse:
            t = thr.to(c.device)
            counts += torch.stack([(c >= t[:, j : j + 1]).sum(dim=1) for j in range(r.shape[1])], dim=1).to(lead)
        return counts.masked_fill(r < 0, 0).cpu().numpy()
