"""Similarity math helpers: port of perceive_tpu/ops/similarity.py, the
semantic spec of the reference's tensor helpers (perceive-core lib.rs:63-77).

These are the scoring semantics; the query path fuses them into the scan
kernels (ops.topk).  ``dot_product`` is what the highlight engine scores
chunks with; the cosine variants normalize by vector NORMS, unlike the
reference's HNSW distance, which divided by the vector's *dimension* and
was only monotonicity-correct for normalized embeddings.

Vectors normalize in their own dtype, with the norm JAX's
``jnp.linalg.norm`` gives a bf16 array (the f32 sum of squares rounded to
bf16, its square root rounded again), and products accumulate in f32
whatever the inputs' dtype, as the JAX package's
``preferred_element_type=float32``.
"""

from __future__ import annotations

import torch


def _normalize(x: torch.Tensor) -> torch.Tensor:
    squares = x.float().square().sum(dim=-1, keepdim=True).to(x.dtype)
    return x / squares.float().sqrt().to(x.dtype).clamp_min(1e-12)


def dot_product(query: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """(D,) or (1, D) query x (N, D) values -> (N,) dot scores."""
    return values.float() @ query.reshape(-1).float()


def cosine_similarity_single_query(query: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """(D,) query vs (N, D) values -> (N,) cosines."""
    return _normalize(values).float() @ _normalize(query.reshape(-1)).float()


def cosine_similarity_multi_query(queries: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """(Q, D) x (N, D) -> (Q, N) cosines."""
    return _normalize(queries).float() @ _normalize(values).float().T
