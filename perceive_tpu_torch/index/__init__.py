from .executor import BatchingSearchExecutor
from .matrix import CHUNK_STRIDE, EmbeddingMatrix, chunk_key, key_item, sweep_rows_for
from .searcher import MAX_K, SearchResult, Searcher

__all__ = [
    "BatchingSearchExecutor",
    "CHUNK_STRIDE",
    "EmbeddingMatrix",
    "MAX_K",
    "SearchResult",
    "Searcher",
    "chunk_key",
    "key_item",
    "sweep_rows_for",
]
