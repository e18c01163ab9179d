"""One sample of the int2 self-audit over the int4 companion, reproduced on
the CPU in the port and in the JAX package.

``python3 chip_smoke.py --audit-case CASE.npz`` writes the audit's worst
sample on the card and the rows around it: the coarse pass's top 2 * kc
rows, the companion's top kb_ref rows and the sample's own row, in the
corpus's row order, with their keys (item and chunk), f32 vectors,
sources and device bytes.  Quantization is per row, so these rows hold the
card's bytes, and over them the coarse top kc and the reference's
candidates are the rows they are over the whole corpus.

    python tests/audit_case.py CASE.npz

builds the port's ``Searcher`` (on the CPU) and the JAX package's
(``engine="xla"``) at the int2 tier with the int4 companion on those rows,
checks that both hold the card's bytes, makes the audit's sample that one
row, runs each one's ``audit_coarse`` at the coarse depth the card's audit
ended at (``PERCEIVE_TPU_COARSE_FETCH``) and prints one JSON line: the
overlap on the card, the port's and JAX's audits, and the reference and
served rows of each (as corpus rows).
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np


def _rows_of(searcher, case, k: int, engine=None):
    """The sample's reference and served top-k rows, as the audit's phase 3
    measures them, mapped to corpus rows."""
    v = case["vecs"][case["pos"]][None].astype(np.float32)
    v = (v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)).astype(np.float32)
    qp = searcher._pad_queries(v)
    allowed = searcher._allowed_arrays(None)[0]
    kb, kb_ref = int(case["kb"]), int(case["kb_ref"])
    extra = () if engine is None else (engine,)
    rv, rr, _ = searcher._device_scan(qp, kb_ref, allowed, *extra, use_coarse=False)
    _, rr = searcher._rerank(v, np.asarray(rv), np.asarray(rr))
    cv, cr, _ = searcher._device_scan(qp, kb, allowed, *extra, use_coarse=True, force_coarse=True)
    _, cr = searcher._rerank(v, np.asarray(cv), np.asarray(cr))
    rows = case["rows"]
    ref = [int(rows[r]) for r in rr[0][:k].tolist() if r >= 0]
    return ref, [int(rows[r]) for r in cr[0][: len(ref)].tolist()]


def reproduce(path: str, k: int = 10) -> dict:
    from perceive_tpu.index.matrix import INT2 as JAX_INT2
    from perceive_tpu.index.searcher import Searcher as JaxSearcher
    from perceive_tpu_torch.index.matrix import CHUNK_STRIDE, INT2
    from perceive_tpu_torch.index.searcher import Searcher

    case = dict(np.load(path))
    os.environ["PERCEIVE_TPU_INT2_FINE"] = "int4"
    os.environ["PERCEIVE_TPU_COARSE_FETCH"] = str(int(case["fetch"]))  # the depth the card's audit ended at
    rows, dim = case["rows"], int(case["dim"])
    keys = [(int(key) // CHUNK_STRIDE, int(key) % CHUNK_STRIDE) for key in case["keys"]]  # (item, chunk)
    out = {"row": int(case["row"]), "rows": len(rows), "overlap_card": float(case["overlap"]),
           "fetch": int(case["fetch"]),
           "ref_card": case["ref"].tolist(), "served_card": case["served"].tolist(),
           "ref_coarse_rank": case["ref_coarse_rank"].tolist(), "ref_fine_rank": case["ref_fine_rank"].tolist(),
           "kc": int(case["kc"]), "kb": int(case["kb"]), "kb_ref": int(case["kb_ref"])}
    for name in ("port", "jax"):
        if name == "port":
            s, engine = Searcher(0, 0, dim, device="cpu", dtype=INT2), None
        else:
            s, engine = JaxSearcher(0, 0, dim, dtype=JAX_INT2, engine="xla"), "xla"
        s._stratified_sample = lambda *a, **kw: np.array([case["pos"]])  # the audit samples this row
        s.upsert_embeddings(keys, case["src"].tolist(), case["vecs"])
        if s._first_fetch(k) != int(case["first_fetch"]):  # chunked items double it
            raise SystemExit(f"{name}: first fetch {s._first_fetch(k)} over these rows, "
                             f"{int(case['first_fetch'])} on the card")
        (p2, p4), _, (s2, s4) = s.matrix.device_view()
        n = len(rows)
        same = all(np.array_equal(np.asarray(a)[..., :n], case[b])
                   for a, b in ((p2, "packed2"), (s2, "scales2"), (p4, "packed4"), (s4, "scales4")))
        if not same:
            raise SystemExit(f"{name}: the rebuilt matrix does not hold the card's bytes")
        s.audit_coarse(max_queries=1, k=k)
        ref, served = _rows_of(s, case, k, engine)
        out[name] = {"tier": s.matrix.tier_name, "audit": s.coarse_audit, "ref": ref, "served": served,
                     "overlap": len(set(ref) & set(served)) / max(len(ref), 1)}
    return out


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # the repository
    print(json.dumps(reproduce(sys.argv[1])))
