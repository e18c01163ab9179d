"""perceive-tpu's PyTorch + CUDA port, for one NVIDIA H100.

The JAX package ``perceive_tpu`` beside it is the frozen reference.  This
package serves the text-query path: tokenize -> encoder (CUDA attention
kernel on long buckets) -> exact scan with top-k (CUDA kernels at the bf16
and int8 tiers; int8 candidates reranked in f32) -> chunk dedupe -> SQLite
retrieve -> highlight, behind ``python -m perceive_tpu_torch.cli --db PATH
search ...``, and coalesced batch search (``index.BatchingSearchExecutor``).

It imports ``torch`` and never ``jax``, and nothing of ``perceive_tpu``: it
keeps its own copies of the modules it needs (``db``, ``types``, ``paths``,
``utils.coalesce``).  The CUDA sources under ``csrc/`` build with ``nvcc`` on first use
(``ops/_cuda.py``).
"""

__version__ = "0.1.0"
