"""perceive-tpu's PyTorch + CUDA port, for one NVIDIA H100.

The JAX package ``perceive_tpu`` beside it is the frozen reference.  This
package serves the text-query path: tokenize -> encoder (CUDA attention
kernel on long buckets) -> exact scan with top-k (CUDA kernel) -> chunk
dedupe -> SQLite retrieve -> highlight, behind ``python -m
perceive_tpu_torch.cli --db PATH search ...``.

It imports ``torch`` and never ``jax``.  From ``perceive_tpu`` it reuses
only the modules with a jax-free import chain: ``db``, ``types``, ``paths``.
The CUDA sources under ``csrc/`` build with ``nvcc`` on first use
(``ops/_cuda.py``).
"""

__version__ = "0.1.0"
